"""Quantization math (counterpart of transformerengine_tpu/quantize/
qmath.py) for current and delayed scaling and for MXFP8. These functions
are bit-exact to the reference and are the ground truth of the port's
quantize kernels: f32 amax, f32 scale = q_max / amax (per tensor) or an
E8M0 power of two per 32-element block (MXFP8), and a clip to the
format's range BEFORE the round-to-nearest-even cast, so no value relies
on the cast's own overflow behaviour."""
from __future__ import annotations

import torch

import torch.nn.functional as F

from .dtypes import E8M0_BIAS, dtype_max

_F32_TINY = 2.0 ** -126
# The MXFP8 element emax: the reference takes 8 (e4m3's) for every element
# dtype, e5m2 included (upstream TransformerEngine takes 15 for e5m2).
MXFP8_EMAX = 8


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


def _block_amax(x2d: torch.Tensor, br: int, bc: int) -> torch.Tensor:
    """Per-(br, bc)-block amax of a 2D tensor; ragged edges are padded
    with zeros, so the last block's amax is over the elements that
    exist."""
    r, c = x2d.shape
    gr, gc = -(-r // br), -(-c // bc)
    xp = F.pad(x2d.float().abs(), (0, gc * bc - c, 0, gr * br - r))
    return xp.reshape(gr, br, gc, bc).amax(dim=(1, 3))


def _expand_scales(s: torch.Tensor, br: int, bc: int, r: int, c: int):
    return s.repeat_interleave(br, dim=0).repeat_interleave(bc, dim=1)[
        :r, :c]


def _pow2_floor_exp(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) from the f32 exponent bits (exact, no libm), for
    v >= 2^-126 (smaller v count as 2^-126)."""
    bits = v.float().clamp_min(_F32_TINY).view(torch.int32)
    return (bits >> 23) - 127


def mxfp8_quantize(x2d: torch.Tensor, q_dtype: torch.dtype):
    """OCP MX quantization along the last axis: one E8M0 scale per (1, 32)
    block. The block's exponent is floor(log2(amax)) - 8, clipped to
    [-127, 127], and 0 where the amax is 0; the payload is
    clip(x * 2^-exponent, +-q_max) cast round-to-nearest-even. Returns
    (data, the biased exponents as uint8 (rows, ceil(cols / 32)))."""
    r, c = x2d.shape
    amax = _block_amax(x2d, 1, 32)
    exp = (_pow2_floor_exp(amax) - MXFP8_EMAX).clamp(-E8M0_BIAS, E8M0_BIAS)
    exp = torch.where(amax > 0, exp, torch.zeros_like(exp))
    # 2^-exp from its bits. An f32 amax gives exp <= 120 (inf gives 120),
    # so 127 - exp >= 7 and the multiplier is a normal number.
    mult = ((127 - exp) << 23).view(torch.float32)
    data = saturate_cast(x2d.float() * _expand_scales(mult, 1, 32, r, c),
                         q_dtype)
    return data, (exp + E8M0_BIAS).to(torch.uint8)
