"""Fused norm + dense with its backward (counterpart of
transformerengine_tpu/layernorm_dense.py): norm -> (quantize ->) GEMM
forward; dgrad and wgrad, then the norm backward from the saved
statistics. Branches and the quantizer-state update are those of
``dense.py``. Under per-tensor scaling the reference quantizes the norm's
output in one orientation and never takes its fused norm + quantize
kernel, and neither does the port."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .dense import (gemm_bwd, gemm_fwd, join_residuals, needs_grad,
                    split_residuals)
from .ops.normalization import norm_bwd, norm_fwd
from .quantize.quantizer import QuantizerSet, noop_quantizer_set


def _ln_dense_fwd(x, kernel, gamma, beta, qset, norm_type, zcg, eps):
    """(out, the GEMM's residuals, mu, rsigma)."""
    ln, mu, rsigma = norm_fwd(x, gamma, beta, norm_type,
                              zero_centered_gamma=zcg, epsilon=eps)
    out2d, res = gemm_fwd(ln.reshape(-1, x.shape[-1]), kernel, qset)
    out = out2d.reshape(*x.shape[:-1], *kernel.shape[1:]).to(x.dtype)
    return out, res, mu, rsigma


class _LayerNormDense(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, gamma, beta, qset, norm_type, zcg, eps):
        out, res, mu, rsigma = _ln_dense_fwd(x, kernel, gamma, beta, qset,
                                             norm_type, zcg, eps)
        tensors, ctx.tag = split_residuals(res)
        ctx.save_for_backward(x, mu, rsigma, gamma, *tensors)
        ctx.qset, ctx.norm = qset, (norm_type, zcg)
        ctx.k_meta = (tuple(kernel.shape), kernel.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mu, rsigma, gamma, *tensors = ctx.saved_tensors
        k_shape, k_dtype = ctx.k_meta
        dln2d, dw2d, new = gemm_bwd(g.reshape(-1, math.prod(k_shape[1:])),
                                    join_residuals(ctx.tag, tensors),
                                    ctx.qset,
                                    need_dw=ctx.needs_input_grad[1])
        if new is not None:
            ctx.qset.write_back(new)
        norm_type, zcg = ctx.norm
        dx, dgamma, dbeta = norm_bwd(dln2d.reshape(x.shape).to(x.dtype), x,
                                     mu, rsigma, gamma, norm_type,
                                     zero_centered_gamma=zcg)
        dw = dw2d.reshape(k_shape).to(k_dtype) if dw2d is not None else None
        return dx, dw, dgamma, dbeta, None, None, None, None


def layernorm_dense(x: torch.Tensor, kernel, gamma: torch.Tensor, *,
                    beta: Optional[torch.Tensor] = None,
                    norm_type: str = "rmsnorm",
                    zero_centered_gamma: bool = False, epsilon: float = 1e-6,
                    quantizer_set: QuantizerSet = noop_quantizer_set
                    ) -> torch.Tensor:
    """``out = norm(x) . kernel`` in ``x``'s dtype; ``beta`` is the
    LayerNorm bias (``norm_type="layernorm"`` only)."""
    if kernel.shape[0] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not contract "
                         f"with x {tuple(x.shape)}")
    if (beta is not None) != (norm_type == "layernorm"):
        raise ValueError("beta goes with norm_type='layernorm' and only "
                         "with it")
    args = (x, kernel, gamma, beta, quantizer_set, norm_type,
            zero_centered_gamma, float(epsilon))
    if needs_grad(x, kernel, gamma, beta):
        return _LayerNormDense.apply(*args)
    return _ln_dense_fwd(*args)[0]
