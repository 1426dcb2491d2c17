"""Per-tensor quantization math (counterpart of the tensor-scaling half of
transformerengine_tpu/quantize/qmath.py), for current and delayed
scaling. These functions are bit-exact
to the reference: f32 amax, f32 scale = q_max / amax, and a clip to the
format's range BEFORE the round-to-nearest-even cast, so no value relies
on the cast's own overflow behaviour."""
from __future__ import annotations

import torch

from .dtypes import dtype_max


def compute_amax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def compute_scale_from_amax(amax, q_dtype: torch.dtype,
                            margin: float = 0.0) -> torch.Tensor:
    """f32 scale with ``amax * scale ~= q_max``; 1 for a zero or
    non-finite amax."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    # A tensor numerator: ``float / tensor`` multiplies by the reciprocal
    # and can land one ulp away from the correctly rounded quotient.
    scale = (torch.full_like(amax, dtype_max(q_dtype)) / amax) \
        * (2.0 ** -margin)
    ok = (torch.isfinite(scale) & (scale > 0) & (amax > 0)
          & torch.isfinite(amax))
    return torch.where(ok, scale, torch.ones_like(scale))


def saturate_cast(x: torch.Tensor, q_dtype: torch.dtype) -> torch.Tensor:
    m = dtype_max(q_dtype)
    return x.float().clamp(-m, m).to(q_dtype)


def tensor_scale_quantize(x: torch.Tensor, q_dtype: torch.dtype,
                          scale: torch.Tensor):
    """Quantizes with a given f32 scale (delayed scaling). Returns (data,
    scale_inv (1,), amax)."""
    amax = compute_amax(x)
    scale = scale.float().reshape(())
    data = saturate_cast(x.float() * scale, q_dtype)
    return data, (1.0 / scale).reshape(1), amax


def current_scale_quantize(x: torch.Tensor, q_dtype: torch.dtype):
    """Returns (data, scale_inv (1,), amax)."""
    amax = compute_amax(x)
    scale = compute_scale_from_amax(amax, q_dtype)
    data = saturate_cast(x.float() * scale, q_dtype)
    return data, (1.0 / scale).reshape(1), amax
