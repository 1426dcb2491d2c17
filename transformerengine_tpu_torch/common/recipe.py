"""Quantization recipes (counterpart of transformerengine_tpu/common/
recipe.py): the FP8 format pairs, the two per-tensor recipes, delayed
scaling (an amax history carried across steps) and current scaling, and
MXFP8 block scaling. Float8BlockScaling and NVFP4BlockScaling are not
ported yet."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Format:
    """FP8 format pair: the dtype of forward tensors (activations and
    weights) and of backward tensors (gradients)."""

    name: str
    fwd_dtype: torch.dtype
    bwd_dtype: torch.dtype


E4M3 = Format("E4M3", torch.float8_e4m3fn, torch.float8_e4m3fn)
E5M2 = Format("E5M2", torch.float8_e5m2, torch.float8_e5m2)
HYBRID = Format("HYBRID", torch.float8_e4m3fn, torch.float8_e5m2)


class Recipe:
    """Base class of the quantization recipes."""

    def mxfp8(self) -> bool:
        return isinstance(self, MXFP8BlockScaling)


@dataclasses.dataclass(frozen=True)
class DelayedScaling(Recipe):
    """Per-tensor scaling from an amax history: each step quantizes with
    the scale computed at the end of the previous one (``max`` or
    ``most_recent`` of the last ``amax_history_len`` amaxes, with
    ``margin`` powers of two of headroom)."""

    margin: float = 0.0
    fp8_format: Format = HYBRID
    amax_history_len: int = 1024
    amax_compute_algo: str = "max"

    def __post_init__(self):
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError(f"amax_compute_algo must be 'max' or "
                             f"'most_recent', got {self.amax_compute_algo!r}")


@dataclasses.dataclass(frozen=True)
class Float8CurrentScaling(Recipe):
    """Per-tensor scaling from the current amax."""

    fp8_format: Format = HYBRID

    @property
    def fp8_dtype(self) -> torch.dtype:
        """The dtype of forward tensors (weights and activations)."""
        return self.fp8_format.fwd_dtype


@dataclasses.dataclass(frozen=True)
class MXFP8BlockScaling(Recipe):
    """OCP MX FP8: one E8M0 (power-of-two) scale per 32 elements along
    the quantized axis, computed from the block's own amax. Stateless."""

    margin: float = 0.0
    fp8_format: Format = E4M3
    fp8_dpa: bool = False
    fp8_mha: bool = False
