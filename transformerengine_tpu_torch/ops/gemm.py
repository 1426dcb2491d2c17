"""Scaled matmuls (counterpart of transformerengine_tpu/ops/gemm.py), for
per-tensor-scaled, MXFP8 and plain operands.

Every product accumulates in f32 and returns f32. Per-tensor scales are
scalars, so any contraction axes are allowed and the scales apply to the
f32 result. MXFP8 operands must contract along their stored last axis
(their scales run along it); each is dequantized to bf16 first, the
payload times its power-of-two block scale, exact in bf16, as the
reference's ``_dq_block_to_bf16`` does. A resident weight times a
small-M activation (decode) routes to the decode kernel
(ops/decode_matmul.py); every other product is a plain GEMM: an fp8
payload is widened to bf16 (exactly) and multiplied with f32
accumulation, as XLA does for the reference."""
from __future__ import annotations

import torch

from ..quantize.tensor import ScaledTensor1x, dequantize_blocks, get_rowwise
from .decode_matmul import decode_tn_matvec, use_decode_matvec


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with exact products, f32 accumulation and an f32 result.
    bf16 operands on the card stay bf16 (cuBLAS accumulates in f32);
    elsewhere the operands widen to f32 first."""
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
            return dequantize_blocks(t, torch.bfloat16)
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


def prequant_dot(x2d: torch.Tensor, colwise, x_quantizer=None
                 ) -> torch.Tensor:
    """Forward GEMM against a prequantized kernel's (N, K) storage. With
    ``x_quantizer`` the activation is quantized first and both payloads
    enter the product."""
    if x_quantizer is not None:
        return tn_dot(get_rowwise(x_quantizer.quantize(x2d)), colwise)
    return resident_dot(x2d, colwise)


def resident_dot(x2d: torch.Tensor, colwise) -> torch.Tensor:
    """Forward GEMM against a prequantized kernel's (N, K) storage: a
    resident ScaledTensor1x or a plain tensor. Small-M shapes route to
    the decode kernel for both, but for a plain f32 weight, which takes
    the plain GEMM."""
    if not _is_scaled(colwise) and not _is_scaled(x2d):
        m, k = x2d.shape
        if colwise.dtype == torch.bfloat16 and \
                use_decode_matvec(m, colwise.shape[0], k):
            return decode_tn_matvec(x2d, colwise, None)
    return tn_dot(x2d, colwise)
