"""Scaled matmuls (counterpart of transformerengine_tpu/ops/gemm.py), for
per-tensor-scaled, block-scaled (MXFP8, FP8 block scaling, NVFP4) and
plain operands.

Every product accumulates in f32 and returns f32. Per-tensor scales are
scalars, so any contraction axes are allowed and the scales apply to the
f32 result. Block-scaled operands must contract along their stored last
axis (their scales run along it); each is dequantized to bf16 first, as
the reference's ``_dq_block_to_bf16`` does: the payload times its block
scale (a power of two, or an e4m3 value times an e2m1 one), exact in
bf16, or under FP8 block scaling times an f32 scale in f32, rounded once
to bf16; an NVFP4 operand's second-level tensor scale then multiplies
the f32 result, as the per-tensor scales do. A resident block-scaled
(N, K) weight (FP8 block scaling's 128 x 128 tiles, NVFP4's 16 x 16) is
dequantized so at every call. A resident weight times a
small-M activation (decode) routes to a decode kernel
(ops/decode_matmul.py): the (N, K) kernel for per-tensor-scaled and bf16
weights, the (K, N) kernel for block-scaled ones
(:class:`~..quantize.prequant.BlockResidentKernel`); every other product
is a plain GEMM: an fp8 payload is widened to bf16 (exactly) and
multiplied with f32 accumulation, as XLA does for the reference."""
from __future__ import annotations

import torch

from ..checkpoint_policies import DOT, keep
from ..quantize.quantizer import QuantizeLayout
from ..quantize.tensor import ScaledTensor1x, dequantize_to_bf16, get_rowwise
from .decode_matmul import (decode_kn_matvec, decode_tn_matvec,
                            use_decode_matvec)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with exact products, f32 accumulation and an f32 result.
    bf16 operands on the card stay bf16 (cuBLAS accumulates in f32);
    elsewhere the operands widen to f32 first. Inside a checkpointed call
    whose policy keeps dots, the second forward takes the first's result
    (``checkpoint_policies``)."""
    return keep(DOT, lambda: _matmul_f32(a, b))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _is_scaled(t) -> bool:
    return isinstance(t, ScaledTensor1x)


def q_dot(lhs, rhs, lhs_cdim: int, rhs_cdim: int) -> torch.Tensor:
    """2D matmul contracting ``lhs_cdim`` of lhs with ``rhs_cdim`` of rhs;
    operands are plain tensors or ScaledTensor1x."""
    if (_is_scaled(rhs) and rhs.resident and rhs.data.dim() == 2
            and rhs_cdim % 2 == 1 and rhs.scaling_mode.is_tensor_scaling):
        lhs2d = lhs.data if _is_scaled(lhs) else lhs
        if (lhs2d.dim() == 2 and lhs_cdim % 2 == 1
                and use_decode_matvec(lhs2d.shape[0], rhs.data.shape[0],
                                      lhs2d.shape[1])):
            s = rhs.scale_inv.float()
            if _is_scaled(lhs):
                s = s * lhs.scale_inv.float()
            return decode_tn_matvec(lhs2d, rhs.data, s)

    scales = []

    def prep(t, cdim):
        if not _is_scaled(t):
            return t
        if not t.scaling_mode.is_tensor_scaling:
            if cdim % 2 != 1:
                raise ValueError("block-scaled operands must contract along "
                                 "their stored last axis (scales run along "
                                 "it)")
            if t.tensor_scale_inv is not None:
                scales.append(t.tensor_scale_inv.float().reshape(()))
            return dequantize_to_bf16(t)
        scales.append(t.scale_inv.float().reshape(()))
        return t.data.to(torch.bfloat16)

    a, b = prep(lhs, lhs_cdim), prep(rhs, rhs_cdim)
    if lhs_cdim % 2 == 0:
        a = a.t()
    if rhs_cdim % 2 == 1:
        b = b.t()
    out = matmul_f32(a, b)
    if not scales:
        return out
    post = scales[0] if len(scales) == 1 else scales[0] * scales[1]
    return out * post


def tn_dot(lhs, rhs) -> torch.Tensor:
    """``out[i, j] = sum_k lhs[i, k] * rhs[j, k]`` for 2D operands."""
    return q_dot(lhs, rhs, 1, 1)


def _is_block_resident(t) -> bool:
    """A :class:`~..quantize.prequant.BlockResidentKernel` (known by its
    method: ``quantize.prequant`` imports this module)."""
    return hasattr(t, "dequantize_kn")


def block_resident_dot(x2d: torch.Tensor, kern) -> torch.Tensor:
    """Forward GEMM against a BlockResidentKernel's (K, N) block-scaled
    payload. Small-M shapes at the kernel's K run the KN decode kernel;
    every other product (prefill) dequantizes the weight to bf16 (K, N)
    once and takes a plain GEMM, with ``out_scale`` on the f32 result."""
    m, k = x2d.shape
    if k == kern.k and use_decode_matvec(m, kern.n, k):
        return decode_kn_matvec(x2d, kern.payload, kern.scale, kern.out_scale,
                                block=kern.block, packed=kern.packed)
    out = matmul_f32(x2d, kern.dequantize_kn())
    if kern.out_scale is not None:
        out = out * kern.out_scale.float().reshape(())
    return out


def prequant_dot(x2d: torch.Tensor, colwise, x_quantizer=None
                 ) -> torch.Tensor:
    """Forward GEMM against a prequantized kernel's storage. With
    ``x_quantizer`` the activation is quantized first, in the quantizer's
    own layout, and its rowwise usage taken, as the reference does: both
    payloads enter an (N, K) product; a (K, N) block-resident weight takes
    the activation's dequantized bf16 values. An NVFP4 quantizer with the
    RHT cannot rotate the colwise usage along M unless 16 divides M, where
    the reference fails; there (a decode batch) it quantizes the rowwise
    usage alone, the same values."""
    if x_quantizer is not None:
        rowwise_only = (getattr(x_quantizer, "with_rht", False)
                        and x2d.shape[0] % 16 != 0)
        qx = get_rowwise(x_quantizer.quantize(
            x2d, layout=QuantizeLayout.ROWWISE if rowwise_only else None))
    if _is_block_resident(colwise):
        if x_quantizer is not None:
            x2d = qx.dequantize().to(torch.bfloat16)
        return block_resident_dot(x2d, colwise)
    if x_quantizer is not None:
        return tn_dot(qx, colwise)
    return resident_dot(x2d, colwise)


def resident_dot(x2d: torch.Tensor, colwise) -> torch.Tensor:
    """Forward GEMM against a prequantized kernel's storage: a (K, N)
    BlockResidentKernel, a resident (N, K) ScaledTensor1x or a plain
    (N, K) tensor. Small-M shapes route to a decode kernel for all, but
    for a plain f32 weight, which takes the plain GEMM."""
    if _is_block_resident(colwise):
        return block_resident_dot(x2d, colwise)
    if not _is_scaled(colwise) and not _is_scaled(x2d):
        m, k = x2d.shape
        if colwise.dtype == torch.bfloat16 and \
                use_decode_matvec(m, colwise.shape[0], k):
            return decode_tn_matvec(x2d, colwise, None)
    return tn_dot(x2d, colwise)
