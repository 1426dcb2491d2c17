"""Functional LayerNorm / RMSNorm with its backward (counterpart of
transformerengine_tpu/layernorm.py): the forward saves (mu, rsigma) and
the backward reuses them, as the reference's custom VJP does."""
from __future__ import annotations

from typing import Optional

import torch

from .dense import needs_grad
from .ops.normalization import norm_bwd, norm_fwd


class _Norm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, norm_type, zcg, eps):
        out, mu, rsigma = norm_fwd(x, gamma, beta, norm_type,
                                   zero_centered_gamma=zcg, epsilon=eps)
        ctx.save_for_backward(x, mu, rsigma, gamma)
        ctx.cfg = (norm_type, zcg)
        return out

    @staticmethod
    def backward(ctx, dz):
        x, mu, rsigma, gamma = ctx.saved_tensors
        norm_type, zcg = ctx.cfg
        dx, dgamma, dbeta = norm_bwd(dz, x, mu, rsigma, gamma, norm_type,
                                     zero_centered_gamma=zcg)
        return dx, dgamma, dbeta, None, None, None


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor], norm_type: str = "layernorm",
              zero_centered_gamma: bool = False,
              epsilon: float = 1e-6) -> torch.Tensor:
    """Normalizes ``x`` along its last axis; ``norm_type`` is "layernorm"
    or "rmsnorm" (``beta`` None for rmsnorm)."""
    if needs_grad(x, gamma, beta):
        return _Norm.apply(x, gamma, beta, norm_type, zero_centered_gamma,
                           float(epsilon))
    return norm_fwd(x, gamma, beta, norm_type,
                    zero_centered_gamma=zero_centered_gamma,
                    epsilon=epsilon)[0]
