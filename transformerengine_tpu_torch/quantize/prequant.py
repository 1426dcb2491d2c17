"""Prequantized (resident) weights for inference (counterpart of
transformerengine_tpu/quantize/prequant.py).

:func:`prequantize_kernels` replaces every projection kernel of a model,
in place, with a :class:`PrequantizedKernel`: a module whose buffers
hold only the forward GEMM's usage of the (K, ...) kernel, so decode
never re-quantizes. Under ``Float8CurrentScaling`` that is the (N, K)
e4m3 payload and its scale. Under the block recipes
(``MXFP8BlockScaling``, ``Float8BlockScaling``, ``NVFP4BlockScaling``)
the kernel is quantized once along K (the colwise usage, with the
recipe's weight quantizer) and then kept in one of the reference's two
forms, chosen by ``block_decode`` (the reference's
``TE_TPU_BLOCK_DECODE``):
- ``"bf16"``: dequantized once at load into a plain (N, K) bf16 weight;
- ``"quantized"`` with 1-row weight blocks (MXFP8's 1 x 32, FP8 block
  scaling's 1 x 128 under ``w_block_scaling_dim=1``, NVFP4's 1 x 16): a
  :class:`BlockResidentKernel`, the (K, N) payload with (K / block, N)
  bf16 block scales, which the KN decode kernel dequantizes in flight:
  e4m3 bytes under MXFP8 and FP8 block scaling (one byte a weight
  instead of two; FP8 block scaling's f32 scales stored as bf16, exact
  only where they are powers of two, as the reference stores them);
  under NVFP4 the e2m1 codes two to a byte, split-plane, where K is a
  multiple of 32 (else e4m3 bytes), with the tensor scale as
  ``out_scale``;
- ``"quantized"`` with 2D weight blocks (FP8 block scaling's 128 x 128,
  NVFP4's 16 x 16): the (N, K) block-scaled payload and its scale grid,
  resident, which every GEMM dequantizes to bf16 as it runs (the
  reference's route for such a storage).
Embedding and norm parameters stay in high precision.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..common.recipe import (Float8BlockScaling, Float8CurrentScaling,
                             MXFP8BlockScaling, NVFP4BlockScaling, Recipe)
from ..ops.decode_matmul import dequantize_kn
from .helper import QuantizerFactory
from .quantizer import CurrentScaleQuantizer, QuantizeLayout
from .scaling_modes import ScalingMode
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
    (None for MXFP8, NVFP4's tensor scale)."""

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
    ``recipe=None`` and the block recipes' ``"bf16"`` form the (N, K)
    high-precision kernel) and ``scale_inv`` ((1,) f32, None for a
    high-precision ``data``; for the 2D-block ``"quantized"`` form the
    block scale grid of ``scaling_mode``, with NVFP4's second-level
    ``tensor_scale_inv``); for the 1-row-block ``"quantized"`` form both
    are None and the submodule ``kn`` (a :class:`BlockResidentKernel`)
    holds the weight. ``logical_shape`` is the original kernel's shape,
    contracting dim first."""

    def __init__(self, data: Optional[torch.Tensor],
                 scale_inv: Optional[torch.Tensor], logical_shape,
                 dq_dtype: torch.dtype,
                 kn: Optional[BlockResidentKernel] = None,
                 scaling_mode: ScalingMode = ScalingMode.CURRENT_TENSOR_SCALING,
                 tensor_scale_inv: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("scale_inv", scale_inv)
        self.register_buffer("tensor_scale_inv", tensor_scale_inv)
        self.kn = kn
        self.logical_shape = tuple(logical_shape)
        self.dq_dtype = dq_dtype
        self.scaling_mode = scaling_mode

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
                              layout="T", resident=True,
                              scaling_mode=self.scaling_mode,
                              tensor_scale_inv=self.tensor_scale_inv)


_BLOCK_DECODE = ("bf16", "quantized")


def _e4m3_bits_to_e2m1_code(byte: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes holding e2m1 values -> their 4-bit codes (int32), the
    inverse of ``ops/decode_matmul._e2m1_code_to_e4m3_bits``."""
    b = byte.to(torch.int32)
    m7 = b & 0x7F
    mag = torch.where(m7 == 0, 0, torch.where(m7 == 48, 1, (m7 - 48) >> 2))
    return ((b >> 7) << 3) | mag


def _block_resident(t: ScaledTensor1x) -> BlockResidentKernel:
    """A colwise block-scaled ScaledTensor1x (stored (N, K), scales along
    K) -> the contraction-major (K, N) form; NVFP4 codes are packed two to
    a byte where K is a multiple of twice the block."""
    n, k = t.data.shape
    bc = t.scaling_mode.block_shape[1]
    s = t.scaling_mode.decode_scale_inv(t.scale_inv)[:n, :k // bc]
    scale = s.t().to(torch.bfloat16).contiguous()
    if t.scaling_mode.is_nvfp4 and k % (2 * bc) == 0:
        codes = _e4m3_bits_to_e2m1_code(t.data.view(torch.uint8)).t()
        packed = (codes[:k // 2] | (codes[k // 2:] << 4)).to(torch.uint8)
        return BlockResidentKernel(packed.contiguous(), scale,
                                   t.tensor_scale_inv, bc, packed=True)
    return BlockResidentKernel(t.data.t().contiguous(), scale,
                               t.tensor_scale_inv, bc)


def prequantize_kernel_array(kernel: torch.Tensor, recipe: Optional[Recipe],
                             block_decode: str = "bf16"
                             ) -> PrequantizedKernel:
    """Quantizes one kernel (contracting dim first) to its forward GEMM's
    usage. ``recipe=None`` keeps the dtype and only stores it (N, K);
    ``block_decode`` picks the block-scaled resident form (module
    docstring)."""
    k2d = kernel.detach().reshape(kernel.shape[0], -1)
    if recipe is None:
        return PrequantizedKernel(k2d.t().contiguous(), None, kernel.shape,
                                  kernel.dtype)
    if isinstance(recipe, Float8CurrentScaling):
        q = CurrentScaleQuantizer(recipe.fp8_dtype, QuantizeLayout.COLWISE)
        t = q.quantize(k2d, dq_dtype=kernel.dtype)
        return PrequantizedKernel(t.data, t.scale_inv, kernel.shape,
                                  kernel.dtype)
    if isinstance(recipe, (MXFP8BlockScaling, Float8BlockScaling,
                           NVFP4BlockScaling)):
        if block_decode not in _BLOCK_DECODE:
            raise ValueError(f"block_decode must be one of {_BLOCK_DECODE}, "
                             f"got {block_decode!r}")
        q = QuantizerFactory.create(recipe, "kernel", QuantizeLayout.COLWISE)
        t = q.quantize(k2d, dq_dtype=kernel.dtype)
        if block_decode == "bf16":
            return PrequantizedKernel(t.dequantize().to(torch.bfloat16),
                                      None, kernel.shape, kernel.dtype)
        br, bc = t.scaling_mode.block_shape
        if br != 1:
            return PrequantizedKernel(t.data, t.scale_inv, kernel.shape,
                                      kernel.dtype,
                                      scaling_mode=t.scaling_mode,
                                      tensor_scale_inv=t.tensor_scale_inv)
        if k2d.shape[0] % bc:
            raise ValueError(f"block_decode='quantized' needs K a multiple "
                             f"of the block, got K={k2d.shape[0]}")
        return PrequantizedKernel(None, None, kernel.shape, kernel.dtype,
                                  kn=_block_resident(t))
    raise NotImplementedError(
        f"prequantization with {type(recipe).__name__} is not ported; "
        f"ported: Float8CurrentScaling, MXFP8BlockScaling, "
        f"Float8BlockScaling, NVFP4BlockScaling and recipe=None")


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
