"""Fused per-tensor quantize kernels (counterpart of the tensor-scaling
half of transformerengine_tpu/ops/quantize_kernels.py): one read of the
input gives the rowwise FP8 payload, the colwise (transposed) payload and
the amax.

* :func:`cast_transpose` replaces ``cast_transpose``; kernel in
  ``csrc/cast_transpose.cu``.
* :func:`norm_cast_transpose` replaces ``norm_cast_transpose``: RMSNorm or
  LayerNorm fused with the same cast, which also returns rsigma and mu;
  kernel in ``csrc/norm_cast_transpose.cu``.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version. Both are bit-exact to ``quantize/qmath.py``:
``clip(x * scale, -q_max, q_max)`` then a round-to-nearest-even cast, and
the fused norm rounds the normalized value to the input dtype before the
amax and the cast, as the unfused chain does.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..quantize.dtypes import dtype_max

_X_DTYPES = (torch.float32, torch.bfloat16)
_Q_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def cast_transpose_plain(x2d: torch.Tensor, scale: torch.Tensor,
                         q_dtype: torch.dtype):
    m = dtype_max(q_dtype)
    xf = x2d.float()
    amax = xf.abs().amax().reshape(1)
    row = (xf * scale.float().reshape(())).clamp(-m, m).to(q_dtype)
    return row, row.t().contiguous(), amax


def _check_q_dtype(q_dtype):
    if q_dtype not in _Q_DTYPES:
        raise TypeError(f"q_dtype must be e4m3 or e5m2, got {q_dtype}")


def cast_transpose(x2d: torch.Tensor, scale: torch.Tensor,
                   q_dtype: torch.dtype):
    """(rowwise (M, N), colwise (N, M), amax (1,) f32) of ``x2d`` (M, N)
    quantized with the (1,) f32 ``scale``, for any M and N."""
    if x2d.dim() != 2 or scale.numel() != 1:
        raise ValueError(f"expected x (M, N) and a one-element scale, got "
                         f"{tuple(x2d.shape)} and {tuple(scale.shape)}")
    _check_q_dtype(q_dtype)
    if _build.on_cpu(x2d, scale):
        return cast_transpose_plain(x2d, scale, q_dtype)
    m, n = x2d.shape
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    scale = scale.float().reshape(1).contiguous()
    _build.check_aligned(x2d, scale)
    row = torch.empty((m, n), dtype=q_dtype, device=x2d.device)
    col = torch.empty((n, m), dtype=q_dtype, device=x2d.device)
    amax = torch.zeros((1,), dtype=torch.float32, device=x2d.device)
    _build.launch("te_cast_transpose", _build.ptr(x2d), x_code,
                  _build.ptr(scale), _build.DTYPE_CODES[q_dtype],
                  _build.ptr(row), _build.ptr(col), _build.ptr(amax), m, n,
                  _build.stream(x2d))
    _build.LAUNCHES["cast_transpose"] += 1
    return row, col, amax


def norm_cast_transpose_plain(x2d, gamma, beta, scale, q_dtype, *, norm,
                              zero_centered_gamma, epsilon):
    x = x2d.float()
    g = gamma.float() + 1.0 if zero_centered_gamma else gamma.float()
    mu = None
    if norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
    else:
        xc = x
    rsigma = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + epsilon)
    y = xc * rsigma * g
    if beta is not None:
        y = y + beta.float()
    y = y.to(x2d.dtype).float()
    amax = y.abs().amax().reshape(1)
    m = dtype_max(q_dtype)
    row = (y * scale.float().reshape(())).clamp(-m, m).to(q_dtype)
    outs = [row, row.t().contiguous(), amax, rsigma]
    if mu is not None:
        outs.append(mu)
    return tuple(outs)


def norm_cast_transpose(x2d: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor], scale: torch.Tensor,
                        q_dtype: torch.dtype, *, norm: str = "rmsnorm",
                        zero_centered_gamma: bool = False,
                        epsilon: float = 1e-6):
    """RMSNorm or LayerNorm of ``x2d`` (M, H) fused with the quantize of
    both orientations. Returns (row (M, H), col (H, M), amax (1,) of the
    normalized values, rsigma (M, 1)) and, for LayerNorm, mu (M, 1)."""
    if norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"norm must be rmsnorm or layernorm, got {norm!r}")
    if x2d.dim() != 2 or gamma.shape != (x2d.shape[1],) or \
            (beta is not None and beta.shape != gamma.shape) or \
            scale.numel() != 1:
        raise ValueError(f"expected x (M, H), gamma and beta (H,) and a "
                         f"one-element scale, got {tuple(x2d.shape)}, "
                         f"{tuple(gamma.shape)}")
    _check_q_dtype(q_dtype)
    m, h = x2d.shape
    if m % 8 or h % 128:
        raise ValueError(f"norm_cast_transpose takes M % 8 == 0 and "
                         f"H % 128 == 0, got {tuple(x2d.shape)}")
    if _build.on_cpu(x2d, gamma, beta, scale):
        return norm_cast_transpose_plain(
            x2d, gamma, beta, scale, q_dtype, norm=norm,
            zero_centered_gamma=zero_centered_gamma, epsilon=epsilon)
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous() if beta is not None else None
    scale = scale.float().reshape(1).contiguous()
    _build.check_aligned(x2d, gamma, beta, scale)
    dev = x2d.device
    row = torch.empty((m, h), dtype=q_dtype, device=dev)
    col = torch.empty((h, m), dtype=q_dtype, device=dev)
    amax = torch.zeros((1,), dtype=torch.float32, device=dev)
    rsigma = torch.empty((m, 1), dtype=torch.float32, device=dev)
    layernorm = norm == "layernorm"
    mu = torch.empty((m, 1), dtype=torch.float32, device=dev) \
        if layernorm else None
    _build.launch("te_norm_cast_transpose", _build.ptr(x2d), x_code,
                  _build.ptr(gamma), _build.ptr(beta), _build.ptr(scale),
                  _build.DTYPE_CODES[q_dtype], _build.ptr(row),
                  _build.ptr(col), _build.ptr(amax), _build.ptr(rsigma),
                  _build.ptr(mu), m, h, int(layernorm),
                  int(zero_centered_gamma), float(epsilon),
                  _build.stream(x2d))
    _build.LAUNCHES["norm_cast_transpose"] += 1
    outs = [row, col, amax, rsigma]
    if layernorm:
        outs.append(mu)
    return tuple(outs)
