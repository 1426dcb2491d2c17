"""Quantization math (counterpart of transformerengine_tpu/quantize/
qmath.py) for current and delayed scaling, MXFP8, FP8 block scaling and
NVFP4. These functions are bit-exact to the reference and are the ground
truth of the port's quantize kernels: f32 amax, f32 scale = q_max / amax
(per tensor), an E8M0 power of two per 32-element block (MXFP8) or an f32
scale per 1 x 128 block or 128 x 128 tile (FP8 block scaling), and a
clip to the format's range BEFORE the round-to-nearest-even cast, so no
value relies on the cast's own overflow behaviour. FP8 stochastic
rounding (:func:`stochastic_cast`) adds random bits below the target
mantissa and truncates, as the reference does. NVFP4 rounds onto the e2m1 grid by
the reference's table of bounds and ties (``_FP4_BOUNDS``,
``_FP4_TIE_UP``), not by torch's fp4 cast, and draws the bits of its
stochastic rounding from a counter-based hash (:func:`sr_bits`), which
the CUDA kernel computes alike."""
from __future__ import annotations

import torch

import torch.nn.functional as F

from .dtypes import (E8M0_BIAS, FP4_MAX, FP4_STORAGE_DTYPE, dtype_max,
                     float8_e4m3)
from .scaling_modes import ScalingMode

_F32_TINY = 2.0 ** -126
# The MXFP8 element emax: the reference takes 8 (e4m3's) for every element
# dtype, e5m2 included (upstream TransformerEngine takes 15 for e5m2).
MXFP8_EMAX = 8


def decode_scale_inv(scale_inv: torch.Tensor,
                     mode: ScalingMode) -> torch.Tensor:
    """Stored scales -> f32 dequantization multipliers."""
    return mode.decode_scale_inv(scale_inv)


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


def stochastic_cast(x: torch.Tensor, q_dtype: torch.dtype,
                    ubits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding to an FP8 dtype: |x| clipped to the format's
    range, uniform random bits (the low 20 of ``ubits`` for e4m3, 21 for
    e5m2: ``ubits`` holds uint32 values, in any integer dtype) added to
    the f32 word below the target mantissa, the sum truncated to it, then
    clipped and cast (exact, but for results in the format's subnormal
    range, which the cast rounds to nearest), as the reference does."""
    drop = 23 - (3 if q_dtype == float8_e4m3 else 2)
    m = dtype_max(q_dtype)
    word = x.float().clamp(-m, m).contiguous().view(torch.int32)
    r = (ubits.long() & ((1 << drop) - 1)).to(torch.int32)
    word = (word + r) & -(1 << drop)
    return word.view(torch.float32).clamp(-m, m).to(q_dtype)


def cast(x: torch.Tensor, q_dtype: torch.dtype, ubits=None) -> torch.Tensor:
    """:func:`saturate_cast`, or :func:`stochastic_cast` with ``ubits``."""
    if ubits is None:
        return saturate_cast(x, q_dtype)
    return stochastic_cast(x, q_dtype, ubits)


def tensor_scale_quantize(x: torch.Tensor, q_dtype: torch.dtype,
                          scale: torch.Tensor, ubits=None):
    """Quantizes with a given f32 scale (delayed scaling). Returns (data,
    scale_inv (1,), amax)."""
    amax = compute_amax(x)
    scale = scale.float().reshape(())
    data = cast(x.float() * scale, q_dtype, ubits)
    return data, (1.0 / scale).reshape(1), amax


def current_scale_quantize(x: torch.Tensor, q_dtype: torch.dtype,
                           ubits=None):
    """Returns (data, scale_inv (1,), amax)."""
    amax = compute_amax(x)
    scale = compute_scale_from_amax(amax, q_dtype)
    data = cast(x.float() * scale, q_dtype, ubits)
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


def mxfp8_quantize(x2d: torch.Tensor, q_dtype: torch.dtype, ubits=None):
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
    data = cast(x2d.float() * _expand_scales(mult, 1, 32, r, c), q_dtype,
                ubits)
    return data, (exp + E8M0_BIAS).to(torch.uint8)


def pow2_scale(q_max: float, amax: torch.Tensor) -> torch.Tensor:
    """The largest power of two at or below q_max / max(amax, 2^-126), from
    its exponent's bits (exact at every exponent; inf where the quotient
    reaches 2^128)."""
    quot = torch.full_like(amax, q_max) / amax.clamp_min(_F32_TINY)
    return ((_pow2_floor_exp(quot) + 127) << 23).view(torch.float32)


def block_quantize(x2d: torch.Tensor, q_dtype: torch.dtype, br: int, bc: int,
                   pow2_scales: bool = True, ubits=None):
    """FP8 block scaling along the last axis: one f32 scale per (br, bc)
    block ((1, 128) or (128, 128)), ragged edge blocks padded with zeros.
    The scale is q_max / max(amax, 2^-126), under ``pow2_scales`` rounded
    down to a power of two, and 1 where the amax is 0 or the scale is not
    finite; the payload is the cast of clip(x * scale). Returns (data,
    scale_inv (rows / br, cols / bc) f32 = 1 / scale)."""
    r, c = x2d.shape
    amax = _block_amax(x2d, br, bc)
    q_max = dtype_max(q_dtype)
    if pow2_scales:
        scale = pow2_scale(q_max, amax)
    else:
        scale = torch.full_like(amax, q_max) / amax.clamp_min(_F32_TINY)
    scale = torch.where((amax > 0) & torch.isfinite(scale), scale,
                        torch.ones_like(scale))
    data = cast(x2d.float() * _expand_scales(scale, br, bc, r, c), q_dtype,
                ubits)
    return data, torch.ones_like(scale) / scale


# ---------------------------------------------------------------------------
# NVFP4
# ---------------------------------------------------------------------------

# Midpoints between neighbouring e2m1 magnitudes; a value on a midpoint
# goes to the neighbour with the even mantissa (up where _FP4_TIE_UP).
_FP4_BOUNDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
_FP4_TIE_UP = (False, True, False, True, False, True, False)
# The divisor of the per-tensor scale: the largest block scale (amax / 6)
# maps to e4m3's 448.
NVFP4_TS_DIVISOR = FP4_MAX * 448.0

_M32 = 0xFFFFFFFF


# The tables are built on the tensor's device from arange (no host-to-
# device copy, so a CUDA graph can capture the plain versions).
def _fp4_bounds(device) -> torch.Tensor:
    """_FP4_BOUNDS: 0.25 + 0.5 k for k < 4, then 2.5, 3.5, 5.0."""
    k = torch.arange(7, device=device, dtype=torch.float32)
    return torch.where(k < 4, 0.25 + 0.5 * k, k - 1.5 + 0.5 * (k == 6))


def _fp4_grid(device) -> torch.Tensor:
    """dtypes.FP4_GRID: 0.5 k for k < 4, then 2, 3, 4, 6."""
    k = torch.arange(8, device=device, dtype=torch.float32)
    return torch.where(k < 4, 0.5 * k, (2 + k % 2) * (1 + (k >= 6)))


def cast_to_fp4_grid(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest onto the e2m1 grid (|x| clipped to 6), ties by the
    table, the sign kept (a negative value that rounds to 0 is -0); the
    values in e4m3 bytes (FP4_STORAGE_DTYPE)."""
    xf = x.float().contiguous()
    ax = xf.abs().clamp(0.0, FP4_MAX)
    bounds = _fp4_bounds(x.device)
    lo = torch.bucketize(ax, bounds)              # bounds below ax
    hi = torch.bucketize(ax, bounds, right=True)  # bounds at or below ax
    # On a bound (lo != hi) _FP4_TIE_UP[lo] is lo odd.
    idx = torch.where((lo != hi) & (lo % 2 == 1), hi, lo)
    return torch.copysign(_fp4_grid(x.device)[idx], xf).to(FP4_STORAGE_DTYPE)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_key(seed: int, stream: int) -> int:
    """The 32-bit key of one stream of stochastic-rounding bits (stream 0
    rowwise, 1 colwise) drawn from ``seed``."""
    return int(_lowbias32(torch.tensor((seed + 0x9E3779B9 * stream) & _M32)))


def sr_bits(seed: int, stream: int, shape, device=None) -> torch.Tensor:
    """Random uint32 values (in int64) for the elements of a payload of
    ``shape`` (rows, cols): lowbias32(row-major index ^ key). The kernel
    computes the same bits for the same (seed, stream, index)."""
    rows, cols = shape
    idx = torch.arange(rows * cols, dtype=torch.int64,
                       device=device).reshape(rows, cols)
    return _lowbias32(idx ^ sr_key(seed, stream))


def _stochastic_cast_fp4(x: torch.Tensor, ubits: torch.Tensor
                         ) -> torch.Tensor:
    """Stochastic rounding onto the e2m1 grid, exactly unbiased between
    the two neighbours: the upper one with probability (|x| - lo) /
    (up - lo), from u = (bits >> 8) * 2^-24 < p; e4m3 bytes."""
    xf = x.float().contiguous()
    ax = xf.abs().clamp(0.0, FP4_MAX)
    grid = _fp4_grid(x.device)
    il = (torch.bucketize(ax, grid, right=True) - 1).clamp(0, 7)
    iu = (il + 1).clamp(0, 7)
    lo, up = grid[il], grid[iu]
    p = torch.where(up > lo, (ax - lo) / torch.clamp_min(up - lo, _F32_TINY),
                    torch.zeros_like(ax))
    u = (ubits >> 8).float() * 2.0 ** -24
    mag = torch.where(u < p, up, lo)
    return torch.copysign(mag, xf).to(FP4_STORAGE_DTYPE)


def nvfp4_tensor_scale(amax: torch.Tensor) -> torch.Tensor:
    """The second-level f32 scale amax / (6 * 448), and 1 for a zero
    amax."""
    amax = amax.float()
    return torch.where(amax > 0, amax / torch.full_like(amax,
                                                        NVFP4_TS_DIVISOR),
                       torch.ones_like(amax))


def _nvfp4_encode(x2d, s_dec, tensor_scale, br, bc, ubits):
    """(payload, e4m3 block scales, f32 effective block scales) of one
    candidate: s_e4m3 = e4m3(clip(s_dec / ts, +-448)), s_eff = s_e4m3 * ts,
    payload = grid(x * (1 / s_eff)), 0 where s_eff is 0."""
    r, c = x2d.shape
    s_e4m3 = saturate_cast(s_dec / tensor_scale, float8_e4m3)
    s_eff = s_e4m3.float() * tensor_scale
    inv = torch.where(s_eff > 0,
                      torch.ones_like(s_eff) / torch.clamp_min(s_eff,
                                                               _F32_TINY),
                      torch.zeros_like(s_eff))
    y = x2d.float() * _expand_scales(inv, br, bc, r, c)
    data = cast_to_fp4_grid(y) if ubits is None \
        else _stochastic_cast_fp4(y, ubits)
    return data, s_e4m3, s_eff


def nvfp4_encode(x2d: torch.Tensor, tensor_scale: torch.Tensor,
                 block_shape=(1, 16), ubits=None, four_over_six=False):
    """NVFP4 payload and e4m3 block scales of ``x2d`` under a given f32
    ``tensor_scale`` (the rule of :func:`nvfp4_quantize`)."""
    r, c = x2d.shape
    br, bc = block_shape
    ts = tensor_scale.float().reshape(())
    block_amax = _block_amax(x2d, br, bc)
    data, s_e4m3, s_eff = _nvfp4_encode(
        x2d, block_amax / torch.full_like(block_amax, FP4_MAX), ts, br, bc,
        ubits)
    if four_over_six:
        # A second candidate with the block scale 1.5x larger, so e2m1's 4
        # covers what 6 covers; each block keeps the candidate with the
        # smaller squared error (ties to 6).
        data4, s4_e4m3, s4_eff = _nvfp4_encode(
            x2d, block_amax / torch.full_like(block_amax, 4.0), ts, br, bc,
            ubits)

        def block_err(d, eff):
            e = (x2d.float() - d.float() * _expand_scales(eff, br, bc, r, c)
                 ) ** 2
            gr, gc = -(-r // br), -(-c // bc)
            e = F.pad(e, (0, gc * bc - c, 0, gr * br - r))
            return e.reshape(gr, br, gc, bc).sum(dim=(1, 3))

        use4 = block_err(data4, s4_eff) < block_err(data, s_eff)
        s_e4m3 = torch.where(use4, s4_e4m3, s_e4m3)
        data = torch.where(_expand_scales(use4, br, bc, r, c), data4, data)
    return data, s_e4m3


def nvfp4_quantize(x2d: torch.Tensor, seed=None, stream: int = 0,
                   global_amax=None, block_shape=(1, 16),
                   four_over_six: bool = False):
    """NVFP4 along the last axis: e2m1 values (in e4m3 bytes), an e4m3
    scale per ``block_shape`` block ((1, 16), or (16, 16) for 2D weights)
    and an f32 tensor scale from the tensor's amax. ``seed`` rounds
    stochastically with :func:`sr_bits` of (``seed``, ``stream``).
    Returns (data, block scales (rows / br, cols / 16) e4m3, tensor scale
    (1,) f32, amax)."""
    amax = compute_amax(x2d) if global_amax is None \
        else torch.as_tensor(global_amax, dtype=torch.float32,
                             device=x2d.device)
    ts = nvfp4_tensor_scale(amax)
    ubits = None if seed is None else sr_bits(seed, stream, x2d.shape,
                                              x2d.device)
    data, s_e4m3 = nvfp4_encode(x2d, ts, block_shape, ubits, four_over_six)
    return data, s_e4m3, ts.reshape(1), amax
