"""Dense layer, forward only (counterpart of transformerengine_tpu/dense.py
for a kernel without a quantizer set, or a prequantized kernel).
Autograd and activation quantization arrive with the training slice."""
from __future__ import annotations

import torch

from .ops.gemm import prequant_dot, q_dot
from .quantize.prequant import PrequantizedKernel


def forward_gemm(x2d: torch.Tensor, kernel) -> torch.Tensor:
    """(M, N) f32 ``x2d (M, K) . kernel`` for a (K, ...) kernel tensor or
    a :class:`PrequantizedKernel` (whose (N, K) storage small-M shapes
    read through the decode kernel)."""
    if isinstance(kernel, PrequantizedKernel):
        return prequant_dot(x2d, kernel.colwise)
    k = kernel.shape[0]
    return q_dot(x2d, kernel.reshape(k, -1), 1, 0)


def dense(x: torch.Tensor, kernel) -> torch.Tensor:
    """``out = x . kernel``, contracting the last dim of ``x`` with the
    first of ``kernel``; the result takes ``x``'s dtype."""
    if kernel.shape[0] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not contract "
                         f"with x {tuple(x.shape)}")
    out2d = forward_gemm(x.reshape(-1, x.shape[-1]), kernel)
    return out2d.reshape(*x.shape[:-1], *kernel.shape[1:]).to(x.dtype)
