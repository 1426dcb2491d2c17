"""Quantization recipes (counterpart of transformerengine_tpu/common/
recipe.py): the FP8 and FP4 format pairs, the per-tensor knobs
(``QParams``), the two per-tensor recipes, delayed scaling (an amax
history carried across steps) and current scaling, MXFP8 block scaling
NVFP4 block scaling, FP8 block scaling (``Float8BlockScaling``: f32
scales per 1 x 128 block or 128 x 128 tile) and ``CustomRecipe``, whose
factory builds each role's quantizer.

The FP8 recipes carry the reference's attention flags: ``fp8_dpa`` runs
the attention on FP8 Q/K/V (per-tensor current-scaling e4m3 payloads,
under any FP8 recipe), and ``fp8_mha``, with ``fp8_dpa`` under a
per-tensor recipe, also hands an FP8 O to the output projection and
streams an FP8 dO through the attention's backward
(``nn/transformer.py``)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    """Per-tensor quantization knobs. NVFP4 reads the last three: the
    random Hadamard transform of the colwise usage, stochastic rounding and
    (16, 16) blocks. ``power_2_scale`` and ``amax_epsilon`` are accepted,
    as the reference accepts them, and read by no recipe, there or
    here."""

    power_2_scale: bool = False
    amax_epsilon: float = 0.0
    random_hadamard_transform: bool = False
    stochastic_rounding: bool = False
    fp4_2d_quantization: bool = False


@dataclasses.dataclass(frozen=True)
class MMParams:
    """Per-GEMM knobs. Accepted as the reference accepts them; neither
    reads ``use_split_accumulator`` (every product accumulates in f32)."""

    use_split_accumulator: bool = True


class Recipe:
    """Base class of the quantization recipes."""

    def mxfp8(self) -> bool:
        return isinstance(self, MXFP8BlockScaling)

    def delayed(self) -> bool:
        return isinstance(self, DelayedScaling)

    def float8_current_scaling(self) -> bool:
        return isinstance(self, Float8CurrentScaling)

    def float8_block_scaling(self) -> bool:
        return isinstance(self, Float8BlockScaling)

    def nvfp4(self) -> bool:
        return isinstance(self, NVFP4BlockScaling)

    def custom(self) -> bool:
        return isinstance(self, CustomRecipe)


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
    """Per-tensor scaling from the current amax. The three ``QParams`` are
    accepted, as the reference accepts them, and read by neither."""

    fp8_format: Format = HYBRID
    fp8_quant_fwd_inp: QParams = QParams()
    fp8_quant_fwd_weight: QParams = QParams()
    fp8_quant_bwd_grad: QParams = QParams()
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


@dataclasses.dataclass(frozen=True)
class Float8BlockScaling(Recipe):
    """FP8 with f32 scales from each block's own amax: 1 x 128 blocks
    (``*_block_scaling_dim=1``) or 128 x 128 tiles (``=2``), by default
    1 x 128 for activations and gradients and 128 x 128 for weights, the
    scales rounded down to powers of two under ``force_pow_2_scales``.
    Stateless."""

    fp8_format: Format = E4M3
    force_pow_2_scales: bool = True
    x_block_scaling_dim: int = 1
    w_block_scaling_dim: int = 2
    grad_block_scaling_dim: int = 1
    fp8_dpa: bool = False
    fp8_mha: bool = False

    def __post_init__(self):
        for f in ("x", "w", "grad"):
            dim = getattr(self, f"{f}_block_scaling_dim")
            if dim not in (1, 2):
                raise ValueError(f"{f}_block_scaling_dim must be 1 or 2, "
                                 f"got {dim}")


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


@dataclasses.dataclass(frozen=True)
class CustomRecipe(Recipe):
    """A quantizer factory of the caller's: ``qfactory(role)``, role "x",
    "kernel" or "dgrad", returns that role's quantizer, or None to leave
    the role in high precision (None for every role is the unquantized
    path)."""

    qfactory: Optional[Callable] = None
