"""RMSNorm forward (counterpart of transformerengine_tpu/ops/
normalization.py rmsnorm_fwd). Statistics in f32, output in the input
dtype; LayerNorm and the backward passes arrive with the training
slice."""
from __future__ import annotations

import torch


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, *,
                epsilon: float = 1e-6):
    """Returns (out, rsigma)."""
    xf = x.float()
    rsigma = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    out = (xf * rsigma * gamma.float()).to(x.dtype)
    return out, rsigma.squeeze(-1)
