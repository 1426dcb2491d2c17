"""Fused norm + MLP block with its backward (counterpart of
transformerengine_tpu/layernorm_mlp.py): norm -> GEMM1 -> (gated)
activation -> GEMM2, and the mirrored chain back with ``dact_lu``.
Branches and the quantizer-state update of both GEMMs are those of
``dense.py``. Under block scaling GEMM1's input comes from the x
quantizer's ``quantize_normed`` where its shape rule holds: both
orientations in training, the rowwise one alone in the forward without a
gradient (the reference takes the fused path in its ``inference`` primal
too, unlike ``layernorm_dense``); FP8 block scaling has no fused norm.
``kernel_caches`` (one cache for each kernel, or None) as ``dense.py``
takes them."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .dense import (gemm_bwd, gemm_fwd, join_residuals, needs_grad,
                    split_residuals)
from .layernorm_dense import fused_norm_quantize
from .ops.activation import (act_lu, dact_lu, normalize_activation_type,
                             num_halves)
from .ops.normalization import norm_bwd, norm_fwd
from .quantize.quantizer import QuantizerSet, noop_quantizer_set


def _ln_mlp_fwd(x, gamma, beta, kernel1, kernel2, qset1, qset2, caches,
                norm_type, zcg, eps, acts, inference=False):
    """(out, each GEMM's residuals, mu, rsigma, z2d)."""
    kc1, kc2 = caches
    hidden = x.shape[-1]
    ffn = kernel1.shape[-1]
    fused = fused_norm_quantize(x, gamma, beta, kernel1, qset1, norm_type,
                                zcg, eps, inference)
    if fused is not None:
        qx, mu, rsigma = fused
        z2d, res1 = gemm_fwd(None, kernel1, qset1, inference=inference,
                             qx=qx, kernel_cache=kc1)
    else:
        ln, mu, rsigma = norm_fwd(x, gamma, beta, norm_type,
                                  zero_centered_gamma=zcg, epsilon=eps)
        z2d, res1 = gemm_fwd(ln.reshape(-1, hidden), kernel1, qset1,
                             inference=inference, kernel_cache=kc1)
    z2d = z2d.to(x.dtype)
    a2d = act_lu(z2d.reshape(-1, 2, ffn) if num_halves(acts) == 2 else z2d,
                 acts)
    out2d, res2 = gemm_fwd(a2d.reshape(-1, ffn), kernel2, qset2,
                           inference=inference, kernel_cache=kc2)
    return out2d.reshape(x.shape).to(x.dtype), res1, res2, mu, rsigma, z2d


class _LayerNormMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, kernel1, kernel2, qset1, qset2, caches,
                norm_type, zcg, eps, acts):
        out, res1, res2, mu, rsigma, z2d = _ln_mlp_fwd(
            x, gamma, beta, kernel1, kernel2, qset1, qset2, caches,
            norm_type, zcg, eps, acts)
        t1, tag1 = split_residuals(res1)
        t2, tag2 = split_residuals(res2)
        ctx.save_for_backward(x, mu, rsigma, gamma, z2d, *t1, *t2)
        ctx.tags = (tag1, tag2, len(t1))
        ctx.qsets, ctx.norm, ctx.acts = (qset1, qset2), (norm_type, zcg), acts
        ctx.caches = caches
        ctx.k_meta = ((tuple(kernel1.shape), kernel1.dtype),
                      (tuple(kernel2.shape), kernel2.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        x, mu, rsigma, gamma, z2d, *tensors = ctx.saved_tensors
        tag1, tag2, n1 = ctx.tags
        res1 = join_residuals(tag1, tensors[:n1])
        res2 = join_residuals(tag2, tensors[n1:])
        qset1, qset2 = ctx.qsets
        kc1, kc2 = ctx.caches
        (k1_shape, k1_dtype), (k2_shape, k2_dtype) = ctx.k_meta
        m, hidden = z2d.shape[0], x.shape[-1]
        n_act, ffn = num_halves(ctx.acts), k1_shape[-1]
        da2d, dw2, new2 = gemm_bwd(g.reshape(m, hidden), res2, qset2,
                                   need_dw=ctx.needs_input_grad[4],
                                   kernel_cache=kc2)
        da = da2d.to(x.dtype)
        if n_act == 2:
            dz2d = dact_lu(da, z2d.reshape(m, 2, ffn), ctx.acts)
        else:
            dz2d = dact_lu(da, z2d, ctx.acts)
        dln2d, dw1, new1 = gemm_bwd(dz2d.reshape(m, n_act * ffn), res1,
                                    qset1, need_dw=ctx.needs_input_grad[3],
                                    kernel_cache=kc1)
        for qset, new in ((qset1, new1), (qset2, new2)):
            if new is not None:
                qset.write_back(new)
        norm_type, zcg = ctx.norm
        dx, dgamma, dbeta = norm_bwd(dln2d.reshape(x.shape).to(x.dtype), x,
                                     mu, rsigma, gamma, norm_type,
                                     zero_centered_gamma=zcg)
        dk1 = dw1.reshape(k1_shape).to(k1_dtype) if dw1 is not None else None
        dk2 = dw2.reshape(k2_shape).to(k2_dtype) if dw2 is not None else None
        return (dx, dgamma, dbeta, dk1, dk2) + (None,) * 7


def layernorm_mlp(x: torch.Tensor, gamma: torch.Tensor, kernel1, kernel2, *,
                  beta: Optional[torch.Tensor] = None,
                  norm_type: str = "rmsnorm",
                  zero_centered_gamma: bool = False, epsilon: float = 1e-6,
                  activation_type: Union[str, Sequence[str]] = "swiglu",
                  quantizer_sets: Tuple[QuantizerSet, QuantizerSet] = (
                      noop_quantizer_set, noop_quantizer_set),
                  kernel_caches=None) -> torch.Tensor:
    """``dense(act(dense(norm(x))))``. ``kernel1`` is (hidden, n_act, ffn),
    with n_act = 2 for gated activations; ``kernel2`` is (ffn, hidden);
    ``beta`` is the LayerNorm bias (``norm_type="layernorm"`` only);
    ``kernel_caches`` the two kernels' caches (``quantize/microbatch.py``)
    or None."""
    acts = normalize_activation_type(activation_type)
    if len(kernel1.shape) == 3 and kernel1.shape[1] != num_halves(acts):
        raise ValueError(f"kernel1 n_act dim {kernel1.shape[1]} != "
                         f"{num_halves(acts)} for {acts}")
    if (beta is not None) != (norm_type == "layernorm"):
        raise ValueError("beta goes with norm_type='layernorm' and only "
                         "with it")
    qset1, qset2 = quantizer_sets
    caches = tuple(kernel_caches) if kernel_caches is not None \
        else (None, None)
    args = (x, gamma, beta, kernel1, kernel2, qset1, qset2, caches,
            norm_type, zero_centered_gamma, float(epsilon), acts)
    if needs_grad(x, gamma, beta, kernel1, kernel2):
        return _LayerNormMLP.apply(*args)
    return _ln_mlp_fwd(*args, inference=True)[0]
