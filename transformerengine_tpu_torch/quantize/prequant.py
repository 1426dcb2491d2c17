"""Prequantized (resident) weights for inference (counterpart of
transformerengine_tpu/quantize/prequant.py).

:func:`prequantize_kernels` replaces every projection kernel of a model,
in place, with a :class:`PrequantizedKernel`: a module whose buffers
hold only the forward GEMM's usage of the (K, ...) kernel, so decode
never re-quantizes. Under ``Float8CurrentScaling`` that is the (N, K)
e4m3 payload and its scale. Under ``MXFP8BlockScaling`` the kernel is
quantized once along K (the colwise usage) and then kept in one of the
reference's two forms, chosen by ``block_decode`` (the reference's
``TE_TPU_BLOCK_DECODE``):
- ``"bf16"``: dequantized once at load into a plain (N, K) bf16 weight;
- ``"quantized"``: a :class:`BlockResidentKernel`, the (K, N) e4m3
  payload with (K/32, N) bf16 block scales, which the KN decode kernel
  dequantizes in flight (one byte a weight instead of two).
Embedding and norm parameters stay in high precision.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..common.recipe import Float8CurrentScaling, MXFP8BlockScaling, Recipe
from ..ops.decode_matmul import dequantize_kn
from .quantizer import BlockScaleQuantizer, CurrentScaleQuantizer, \
    QuantizeLayout
from .tensor import ScaledTensor1x

_KERNEL_NAMES = ("kernel", "wi_kernel", "wo_kernel")


class BlockResidentKernel(nn.Module):
    """A block-scaled resident weight stored contraction-major (K, N) for
    the KN decode kernel.

    Buffers: ``payload`` (K, N) e4m3, or with ``packed`` (K/2, N) uint8
    split-plane e2m1 codes (byte row r holds code row r in its low nibble
    and code row r + K/2 in its high one); ``scale`` (K/block, N) bf16
    block scales, decoded once at load (exact: E8M0 and e4m3 scales are
    bf16 values); ``out_scale`` an optional (1,) f32 second-level scale
    (None for MXFP8)."""

    def __init__(self, payload: torch.Tensor, scale: torch.Tensor,
                 out_scale: Optional[torch.Tensor], block: int,
                 packed: bool = False):
        super().__init__()
        self.register_buffer("payload", payload)
        self.register_buffer("scale", scale)
        self.register_buffer("out_scale", out_scale)
        self.block = block
        self.packed = packed

    @property
    def k(self) -> int:
        return self.payload.shape[0] * (2 if self.packed else 1)

    @property
    def n(self) -> int:
        return self.payload.shape[1]

    def dequantize_kn(self) -> torch.Tensor:
        """(K, N) bf16 with the block scales applied, the kernel's own
        dequantization; ``out_scale`` is not folded in (both paths apply
        it to the f32 product)."""
        return dequantize_kn(self.payload, self.scale, self.block,
                             self.packed)


class PrequantizedKernel(nn.Module):
    """A kernel stored only as its forward GEMM's usage.

    The buffers are ``data`` (the (N, K) e4m3 payload, or for
    ``recipe=None`` and MXFP8's ``"bf16"`` form the (N, K) high-precision
    kernel) and ``scale_inv`` ((1,) f32, None for a high-precision
    ``data``); for MXFP8's ``"quantized"`` form both are None and the
    submodule ``kn`` (a :class:`BlockResidentKernel`) holds the weight.
    ``logical_shape`` is the original kernel's shape, contracting dim
    first."""

    def __init__(self, data: Optional[torch.Tensor],
                 scale_inv: Optional[torch.Tensor], logical_shape,
                 dq_dtype: torch.dtype,
                 kn: Optional[BlockResidentKernel] = None):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("scale_inv", scale_inv)
        self.kn = kn
        self.logical_shape = tuple(logical_shape)
        self.dq_dtype = dq_dtype

    @property
    def shape(self):
        return self.logical_shape

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the kernel had before it was prequantized."""
        return self.dq_dtype

    @property
    def colwise(self):
        """What the GEMMs read: a BlockResidentKernel, a resident
        ScaledTensor1x, or the plain (N, K) tensor."""
        if self.kn is not None:
            return self.kn
        if self.scale_inv is None:
            return self.data
        return ScaledTensor1x(self.data, self.scale_inv, None, self.dq_dtype,
                              layout="T", resident=True)


_BLOCK_DECODE = ("bf16", "quantized")


def _block_resident(t: ScaledTensor1x) -> BlockResidentKernel:
    """A colwise block-scaled ScaledTensor1x (stored (N, K), scales along
    K) -> the contraction-major (K, N) form."""
    n, k = t.data.shape
    bc = t.scaling_mode.block_shape[1]
    s = t.scaling_mode.decode_scale_inv(t.scale_inv)[:n, :k // bc]
    return BlockResidentKernel(t.data.t().contiguous(),
                               s.t().to(torch.bfloat16).contiguous(), None,
                               bc)


def prequantize_kernel_array(kernel: torch.Tensor, recipe: Optional[Recipe],
                             block_decode: str = "bf16"
                             ) -> PrequantizedKernel:
    """Quantizes one kernel (contracting dim first) to its forward GEMM's
    usage. ``recipe=None`` keeps the dtype and only stores it (N, K);
    ``block_decode`` picks MXFP8's resident form (module docstring)."""
    k2d = kernel.detach().reshape(kernel.shape[0], -1)
    if recipe is None:
        return PrequantizedKernel(k2d.t().contiguous(), None, kernel.shape,
                                  kernel.dtype)
    if isinstance(recipe, Float8CurrentScaling):
        q = CurrentScaleQuantizer(recipe.fp8_dtype, QuantizeLayout.COLWISE)
        t = q.quantize(k2d, dq_dtype=kernel.dtype)
        return PrequantizedKernel(t.data, t.scale_inv, kernel.shape,
                                  kernel.dtype)
    if isinstance(recipe, MXFP8BlockScaling):
        if block_decode not in _BLOCK_DECODE:
            raise ValueError(f"block_decode must be one of {_BLOCK_DECODE}, "
                             f"got {block_decode!r}")
        q = BlockScaleQuantizer(recipe.fp8_format.fwd_dtype,
                                QuantizeLayout.COLWISE)
        t = q.quantize(k2d, dq_dtype=kernel.dtype)
        if block_decode == "bf16":
            return PrequantizedKernel(t.dequantize().to(torch.bfloat16),
                                      None, kernel.shape, kernel.dtype)
        if k2d.shape[0] % t.scaling_mode.block_shape[1]:
            raise ValueError(f"block_decode='quantized' needs K a multiple "
                             f"of the block, got K={k2d.shape[0]}")
        return PrequantizedKernel(None, None, kernel.shape, kernel.dtype,
                                  kn=_block_resident(t))
    raise NotImplementedError(
        f"prequantization with {type(recipe).__name__} is not ported yet; "
        f"ported: Float8CurrentScaling, MXFP8BlockScaling and recipe=None")


def prequantize_kernels(model: nn.Module, recipe: Optional[Recipe], *,
                        block_decode: str = "bf16") -> nn.Module:
    """Converts ``model`` for resident-weight inference, in place: every
    projection kernel parameter becomes a :class:`PrequantizedKernel`
    submodule of the same name, and the source parameter is released.
    Returns ``model``."""
    for module in list(model.modules()):
        for name in _KERNEL_NAMES:
            param = getattr(module, name, None)
            if not isinstance(param, nn.Parameter) or param.dim() < 2:
                continue
            pk = prequantize_kernel_array(param, recipe, block_decode)
            delattr(module, name)
            setattr(module, name, pk)
    return model
