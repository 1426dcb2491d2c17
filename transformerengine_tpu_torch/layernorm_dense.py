"""Fused norm + dense with its backward (counterpart of
transformerengine_tpu/layernorm_dense.py): norm -> (quantize ->) GEMM
forward; dgrad and wgrad, then the norm backward from the saved
statistics. Branches and the quantizer-state update are those of
``dense.py``. Under per-tensor scaling the reference quantizes the norm's
output in one orientation and never takes its fused norm + quantize
kernel, and neither does the port. Under MXFP8 the training forward
takes the quantizer's ``quantize_normed`` (the norm fused with the 2x
quantize) where its shape rule holds; NVFP4's quantizer has none, so
its norm runs unfused and the GEMM quantizes; the forward without a
gradient runs the norm and then the one-orientation quantize, as the
reference excludes its ``inference`` primal from the fused path. A bias
is added and differentiated as in ``dense.py``, and ``kernel_cache``
taken as there. FP8 block scaling has no fused norm: it runs the norm
unfused, as NVFP4 does."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .dense import (add_bias, all_tensor_scaling, bias_grad, bias_meta,
                    check_bias, gemm_bwd, gemm_fwd, join_residuals,
                    needs_grad, split_residuals)
from .ops.normalization import norm_bwd, norm_fwd
from .quantize.prequant import PrequantizedKernel
from .quantize.quantizer import (QuantizeLayout, QuantizerSet,
                                 noop_quantizer_set)


def fused_norm_quantize(x, gamma, beta, kernel, qset, norm_type, zcg, eps,
                        inference):
    """(quantized norm output, mu, rsigma) from the x quantizer's
    ``quantize_normed`` (one orientation for ``inference``), the
    statistics shaped as ``x.shape[:-1]``; None where the reference runs
    the unfused norm: a prequantized kernel, no or a per-tensor recipe, a
    quantizer without a fused norm (NVFP4), or a shape the fused kernel
    does not take."""
    if (isinstance(kernel, PrequantizedKernel) or qset.x is None
            or all_tensor_scaling(qset)
            or not hasattr(qset.x, "quantize_normed")):
        return None
    out = qset.x.quantize_normed(
        x.reshape(-1, x.shape[-1]), gamma, beta, norm=norm_type,
        zero_centered_gamma=zcg, epsilon=eps,
        layout=QuantizeLayout.ROWWISE if inference else None)
    if out is None:
        return None
    qx, mu, rsigma = out
    lead = x.shape[:-1]
    return qx, None if mu is None else mu.reshape(lead), rsigma.reshape(lead)


def _ln_dense_fwd(x, kernel, gamma, beta, bias, qset, cache, norm_type, zcg,
                  eps, inference=False):
    """(out, the GEMM's residuals, mu, rsigma)."""
    fused = None if inference else fused_norm_quantize(
        x, gamma, beta, kernel, qset, norm_type, zcg, eps, False)
    if fused is not None:
        qx, mu, rsigma = fused
        out2d, res = gemm_fwd(None, kernel, qset, qx=qx, kernel_cache=cache)
    else:
        ln, mu, rsigma = norm_fwd(x, gamma, beta, norm_type,
                                  zero_centered_gamma=zcg, epsilon=eps)
        out2d, res = gemm_fwd(ln.reshape(-1, x.shape[-1]), kernel, qset,
                              inference=inference, kernel_cache=cache)
    out2d = add_bias(out2d, bias)
    out = out2d.reshape(*x.shape[:-1], *kernel.shape[1:]).to(x.dtype)
    return out, res, mu, rsigma


class _LayerNormDense(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, gamma, beta, bias, qset, cache, norm_type,
                zcg, eps):
        out, res, mu, rsigma = _ln_dense_fwd(x, kernel, gamma, beta, bias,
                                             qset, cache, norm_type, zcg, eps)
        tensors, ctx.tag = split_residuals(res)
        ctx.save_for_backward(x, mu, rsigma, gamma, *tensors)
        ctx.qset, ctx.cache, ctx.norm = qset, cache, (norm_type, zcg)
        ctx.k_meta = (tuple(kernel.shape), kernel.dtype)
        ctx.bias = bias_meta(bias)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mu, rsigma, gamma, *tensors = ctx.saved_tensors
        k_shape, k_dtype = ctx.k_meta
        g2d = g.reshape(-1, math.prod(k_shape[1:]))
        dln2d, dw2d, new = gemm_bwd(g2d, join_residuals(ctx.tag, tensors),
                                    ctx.qset,
                                    need_dw=ctx.needs_input_grad[1],
                                    kernel_cache=ctx.cache)
        if new is not None:
            ctx.qset.write_back(new)
        norm_type, zcg = ctx.norm
        dx, dgamma, dbeta = norm_bwd(dln2d.reshape(x.shape).to(x.dtype), x,
                                     mu, rsigma, gamma, norm_type,
                                     zero_centered_gamma=zcg)
        dw = dw2d.reshape(k_shape).to(k_dtype) if dw2d is not None else None
        return (dx, dw, dgamma, dbeta, bias_grad(g2d, ctx.bias), None, None,
                None, None, None)


def layernorm_dense(x: torch.Tensor, kernel, gamma: torch.Tensor, *,
                    beta: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    norm_type: str = "rmsnorm",
                    zero_centered_gamma: bool = False, epsilon: float = 1e-6,
                    quantizer_set: QuantizerSet = noop_quantizer_set,
                    kernel_cache=None) -> torch.Tensor:
    """``out = norm(x) . kernel + bias`` in ``x``'s dtype; ``beta`` is the
    LayerNorm bias (``norm_type="layernorm"`` only), ``bias`` the GEMM's
    (the kernel's feature shape, or None); ``kernel_cache`` as
    :func:`~.dense.dense` takes it."""
    if kernel.shape[0] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not contract "
                         f"with x {tuple(x.shape)}")
    if (beta is not None) != (norm_type == "layernorm"):
        raise ValueError("beta goes with norm_type='layernorm' and only "
                         "with it")
    check_bias(bias, kernel)
    args = (x, kernel, gamma, beta, bias, quantizer_set, kernel_cache,
            norm_type, zero_centered_gamma, float(epsilon))
    if needs_grad(x, kernel, gamma, beta, bias):
        return _LayerNormDense.apply(*args)
    return _ln_dense_fwd(*args, inference=True)[0]
