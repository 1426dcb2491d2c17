"""LayerNorm and RMSNorm, forward and backward (counterpart of
transformerengine_tpu/ops/normalization.py). Statistics in f32, outputs in
the input dtype; the forward returns the statistics (mu, rsigma) that the
backward takes, so the backward never recomputes them. With
``zero_centered_gamma`` the stored gamma is offset by one."""
from __future__ import annotations

import torch


def _gamma(gamma: torch.Tensor, zero_centered: bool) -> torch.Tensor:
    g = gamma.float()
    return g + 1.0 if zero_centered else g


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  *, zero_centered_gamma: bool = False,
                  epsilon: float = 1e-6):
    """Returns (out, mu, rsigma)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rsigma = torch.rsqrt(var + epsilon)
    y = (xf - mu) * rsigma * _gamma(gamma, zero_centered_gamma) \
        + beta.float()
    return y.to(x.dtype), mu.squeeze(-1), rsigma.squeeze(-1)


def layernorm_bwd(dz: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                  rsigma: torch.Tensor, gamma: torch.Tensor, *,
                  zero_centered_gamma: bool = False):
    """Returns (dx, dgamma, dbeta)."""
    xf, dzf = x.float(), dz.float()
    rs = rsigma[..., None]
    xhat = (xf - mu[..., None]) * rs
    dxhat = dzf * _gamma(gamma, zero_centered_gamma)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rs * (dxhat - m1 - xhat * m2)).to(x.dtype)
    red = tuple(range(x.dim() - 1))
    dgamma = (dzf * xhat).sum(dim=red).to(gamma.dtype)
    dbeta = dzf.sum(dim=red).to(gamma.dtype)
    return dx, dgamma, dbeta


def rmsnorm_fwd(x: torch.Tensor, gamma: torch.Tensor, *,
                zero_centered_gamma: bool = False, epsilon: float = 1e-6):
    """Returns (out, rsigma)."""
    xf = x.float()
    rsigma = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    out = (xf * rsigma * _gamma(gamma, zero_centered_gamma)).to(x.dtype)
    return out, rsigma.squeeze(-1)


def rmsnorm_bwd(dz: torch.Tensor, x: torch.Tensor, rsigma: torch.Tensor,
                gamma: torch.Tensor, *, zero_centered_gamma: bool = False):
    """Returns (dx, dgamma)."""
    xf, dzf = x.float(), dz.float()
    rs = rsigma[..., None]
    xhat = xf * rs
    dxhat = dzf * _gamma(gamma, zero_centered_gamma)
    m = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rs * (dxhat - xhat * m)).to(x.dtype)
    red = tuple(range(x.dim() - 1))
    dgamma = (dzf * xhat).sum(dim=red).to(gamma.dtype)
    return dx, dgamma


def norm_fwd(x, gamma, beta, norm_type: str, *, zero_centered_gamma: bool,
             epsilon: float):
    """(out, mu or None, rsigma) of ``norm_type`` "layernorm" or
    "rmsnorm"."""
    if norm_type == "layernorm":
        return layernorm_fwd(x, gamma, beta,
                             zero_centered_gamma=zero_centered_gamma,
                             epsilon=epsilon)
    if norm_type != "rmsnorm":
        raise ValueError(f"norm_type must be layernorm or rmsnorm, got "
                         f"{norm_type!r}")
    out, rsigma = rmsnorm_fwd(x, gamma,
                              zero_centered_gamma=zero_centered_gamma,
                              epsilon=epsilon)
    return out, None, rsigma


def norm_bwd(dz, x, mu, rsigma, gamma, norm_type: str, *,
             zero_centered_gamma: bool):
    """(dx, dgamma, dbeta or None), the backward of :func:`norm_fwd`."""
    if norm_type == "layernorm":
        return layernorm_bwd(dz, x, mu, rsigma, gamma,
                             zero_centered_gamma=zero_centered_gamma)
    dx, dgamma = rmsnorm_bwd(dz, x, rsigma, gamma,
                             zero_centered_gamma=zero_centered_gamma)
    return dx, dgamma, None
