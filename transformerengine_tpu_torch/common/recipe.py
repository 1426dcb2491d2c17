"""Quantization recipes (counterpart of transformerengine_tpu/common/
recipe.py): the FP8 and FP4 format pairs, the per-tensor knobs
(``QParams``), the two per-tensor recipes, delayed scaling (an amax
history carried across steps) and current scaling, MXFP8 block scaling
and NVFP4 block scaling. Float8BlockScaling is not ported yet.

The FP8 recipes carry the reference's attention flags: ``fp8_dpa`` runs
the attention on FP8 Q/K/V (per-tensor current-scaling e4m3 payloads,
under any FP8 recipe), and ``fp8_mha``, with ``fp8_dpa`` under a
per-tensor recipe, also hands an FP8 O to the output projection and
streams an FP8 dO through the attention's backward
(``nn/transformer.py``)."""
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
# FP4's dtype names the format; NVFP4 payloads are stored as e4m3 bytes
# holding e2m1 values (quantize/dtypes.py: FP4_STORAGE_DTYPE).
E2M1 = Format("E2M1", torch.float4_e2m1fn_x2, torch.float4_e2m1fn_x2)


@dataclasses.dataclass(frozen=True)
class QParams:
    """Per-tensor quantization knobs of NVFP4: the random Hadamard
    transform of the colwise usage, stochastic rounding and (16, 16)
    blocks (the reference's ``power_2_scale`` and ``amax_epsilon`` are
    read by no ported recipe and not ported)."""

    random_hadamard_transform: bool = False
    stochastic_rounding: bool = False
    fp4_2d_quantization: bool = False


class Recipe:
    """Base class of the quantization recipes."""

    def mxfp8(self) -> bool:
        return isinstance(self, MXFP8BlockScaling)

    def nvfp4(self) -> bool:
        return isinstance(self, NVFP4BlockScaling)


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
    fp8_dpa: bool = False
    fp8_mha: bool = False

    def __post_init__(self):
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError(f"amax_compute_algo must be 'max' or "
                             f"'most_recent', got {self.amax_compute_algo!r}")


@dataclasses.dataclass(frozen=True)
class Float8CurrentScaling(Recipe):
    """Per-tensor scaling from the current amax."""

    fp8_format: Format = HYBRID
    fp8_dpa: bool = False
    fp8_mha: bool = False

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


_FOUR_OVER_SIX = ("none", "weights", "activations", "all")


@dataclasses.dataclass(frozen=True)
class NVFP4BlockScaling(Recipe):
    """NVFP4: E2M1 values, one E4M3 scale per 16 elements along the
    quantized axis and one f32 scale per tensor. The defaults are the
    reference's: the random Hadamard transform on the input's and the
    gradient's colwise usages (they meet in the wgrad GEMM, where the
    rotations cancel), never on the weight; stochastic rounding on the
    gradient when a generator is given. ``nvfp4_4over6`` picks the tensor
    roles whose blocks may take the "four over six" scale."""

    fp4_format: Format = E2M1
    fp4_quant_fwd_inp: QParams = QParams(random_hadamard_transform=True)
    fp4_quant_fwd_weight: QParams = QParams(fp4_2d_quantization=False)
    fp4_quant_bwd_grad: QParams = QParams(random_hadamard_transform=True,
                                          stochastic_rounding=True)
    nvfp4_4over6: str = "none"

    def __post_init__(self):
        if self.nvfp4_4over6 not in _FOUR_OVER_SIX:
            raise ValueError(f"nvfp4_4over6 must be one of {_FOUR_OVER_SIX}, "
                             f"got {self.nvfp4_4over6!r}")
