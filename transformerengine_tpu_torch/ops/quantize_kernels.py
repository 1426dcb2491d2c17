"""Fused quantize kernels (counterpart of transformerengine_tpu/ops/
quantize_kernels.py): one read of the input gives the rowwise FP8
payload, the colwise (transposed) payload and their scales.

Per-tensor scaling:

* :func:`cast_transpose` replaces ``cast_transpose``; kernel in
  ``csrc/cast_transpose.cu``.
* :func:`norm_cast_transpose` replaces ``norm_cast_transpose``: RMSNorm or
  LayerNorm fused with the same cast, which also returns rsigma and mu;
  kernel in ``csrc/norm_cast_transpose.cu`` over ``csrc/norm_quant.cuh``.

MXFP8 (one E8M0 scale per 32 elements along the quantized axis, stored as
uint8 biased exponents):

* :func:`mxfp8_quantize_2x` replaces ``mxfp8_quantize_2x`` and
  :func:`mxfp8_quantize_1x` replaces ``mxfp8_quantize_1x``; kernels in
  ``csrc/mxfp8_quantize.cu``. The colwise usage of an (M, N) input is the
  (N, M) transpose quantized along M (32 x 1 blocks of the input), not
  the transpose of the rowwise payload.
* :func:`mxfp8_norm_quantize_2x` replaces ``mxfp8_norm_quantize_2x``: the
  norm fused with the MXFP8 quantize; kernel in
  ``csrc/mxfp8_norm_quantize.cu``.
* :func:`mxfp8_qdq_2x_grouped` replaces ``mxfp8_qdq_2x_grouped``: stacked
  (E, K, M) expert kernels quantized along K and dequantized to bf16, in
  both orientations (E, K, M) and (E, M, K); kernel in
  ``csrc/mxfp8_qdq_grouped.cu``. Like the reference it returns None for
  the shapes its kernel does not take (K % 32 or M % 128 not 0), whose
  caller then runs the chain of quantize, dequantize and transpose.

NVFP4 (e2m1 values in e4m3 bytes, an e4m3 scale per 16 elements along the
quantized axis under an f32 scale per tensor):

* :func:`nvfp4_amax_2x` replaces ``nvfp4_amax_2x`` (the two amaxes of the
  per-tensor scales) and :func:`nvfp4_quantize_2x` replaces
  ``nvfp4_quantize_2x`` (both orientations, the colwise one after the
  random Hadamard transform when asked); kernels in
  ``csrc/nvfp4_quantize.cu``. They take M and N multiples of 16; the RHT
  is given by its sign mask, and stochastic rounding by a seed.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain version. Both are bit-exact to ``quantize/qmath.py``:
``clip(x * scale, -q_max, q_max)`` then a round-to-nearest-even cast, and
the fused norms round the normalized value to the input dtype before the
amax and the cast, as the unfused chain does. The MXFP8 kernels take any
shape: ragged edges are masked, with ceil(. / 32) scale columns and the
last block's amax over the elements that exist.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..quantize import qmath
from ..quantize.dtypes import FP4_STORAGE_DTYPE, decode_e8m0, dtype_max
from ..quantize.hadamard import rht_matrix, rotate

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


def normed_plain(x2d, gamma, beta, *, norm, zero_centered_gamma, epsilon,
                 stats=None):
    """(y, mu (M, 1) or None, rsigma (M, 1)) of the fused norms: the
    normalized f32 values rounded to the input dtype, as the unfused
    chain (``ops/normalization``) gives them. ``stats`` (mu, rsigma)
    replaces the statistics (to hold a kernel's normalize and quantize to
    its own statistics)."""
    x = x2d.float()
    g = gamma.float() + 1.0 if zero_centered_gamma else gamma.float()
    mu = None
    if norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True) if stats is None else stats[0]
        xc = x - mu
    else:
        xc = x
    rsigma = (torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + epsilon)
              if stats is None else stats[1])
    y = xc * rsigma * g
    if beta is not None:
        y = y + beta.float()
    return y.to(x2d.dtype).float(), mu, rsigma


def _check_norm_args(x2d, gamma, beta, norm):
    if norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"norm must be rmsnorm or layernorm, got {norm!r}")
    if x2d.dim() != 2 or gamma.shape != (x2d.shape[1],) or \
            (beta is not None and beta.shape != gamma.shape):
        raise ValueError(f"expected x (M, H), gamma and beta (H,), got "
                         f"{tuple(x2d.shape)}, {tuple(gamma.shape)}")


def norm_cast_transpose_plain(x2d, gamma, beta, scale, q_dtype, *, norm,
                              zero_centered_gamma, epsilon, stats=None):
    y, mu, rsigma = normed_plain(x2d, gamma, beta, norm=norm,
                                 zero_centered_gamma=zero_centered_gamma,
                                 epsilon=epsilon, stats=stats)
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
    _check_norm_args(x2d, gamma, beta, norm)
    if scale.numel() != 1:
        raise ValueError(f"expected a one-element scale, got "
                         f"{tuple(scale.shape)}")
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
    amax = torch.empty((1,), dtype=torch.float32, device=dev)
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


# ---------------------------------------------------------------------------
# MXFP8
# ---------------------------------------------------------------------------

def _scale_cols(n: int) -> int:
    return -(-n // 32)


def mxfp8_quantize_2x_plain(x2d: torch.Tensor, q_dtype: torch.dtype):
    row, srow = qmath.mxfp8_quantize(x2d, q_dtype)
    col, scol = qmath.mxfp8_quantize(x2d.t(), q_dtype)
    return row, col, srow, scol


def mxfp8_quantize_1x_plain(x2d: torch.Tensor, q_dtype: torch.dtype, *,
                            colwise: bool):
    return qmath.mxfp8_quantize(x2d.t() if colwise else x2d, q_dtype)


def _check_mxfp8_input(x2d, q_dtype):
    if x2d.dim() != 2 or x2d.numel() == 0:
        raise ValueError(f"expected a non-empty (M, N) tensor, got "
                         f"{tuple(x2d.shape)}")
    _check_q_dtype(q_dtype)


def mxfp8_quantize_2x(x2d: torch.Tensor,
                      q_dtype: torch.dtype = torch.float8_e4m3fn):
    """MXFP8 quantize of ``x2d`` (M, N) in both orientations from one
    read: (row (M, N), col (N, M), srow (M, ceil(N/32)) uint8,
    scol (N, ceil(M/32)) uint8), for any M and N."""
    _check_mxfp8_input(x2d, q_dtype)
    if _build.on_cpu(x2d):
        return mxfp8_quantize_2x_plain(x2d, q_dtype)
    m, n = x2d.shape
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    dev = x2d.device
    row = torch.empty((m, n), dtype=q_dtype, device=dev)
    col = torch.empty((n, m), dtype=q_dtype, device=dev)
    srow = torch.empty((m, _scale_cols(n)), dtype=torch.uint8, device=dev)
    scol = torch.empty((n, _scale_cols(m)), dtype=torch.uint8, device=dev)
    _build.launch("te_mxfp8_quantize_2x", _build.ptr(x2d), x_code,
                  _build.DTYPE_CODES[q_dtype], _build.ptr(row),
                  _build.ptr(col), _build.ptr(srow), _build.ptr(scol), m, n,
                  _build.stream(x2d))
    _build.LAUNCHES["mxfp8_quantize_2x"] += 1
    return row, col, srow, scol


def mxfp8_quantize_1x(x2d: torch.Tensor,
                      q_dtype: torch.dtype = torch.float8_e4m3fn, *,
                      colwise: bool = False):
    """One orientation of :func:`mxfp8_quantize_2x`, from the untransposed
    (M, N) input: (data, scale) with data (M, N) and scale (M, ceil(N/32))
    rowwise, data (N, M) and scale (N, ceil(M/32)) colwise."""
    _check_mxfp8_input(x2d, q_dtype)
    if _build.on_cpu(x2d):
        return mxfp8_quantize_1x_plain(x2d, q_dtype, colwise=colwise)
    m, n = x2d.shape
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    rows, cols = (n, m) if colwise else (m, n)
    data = torch.empty((rows, cols), dtype=q_dtype, device=x2d.device)
    scale = torch.empty((rows, _scale_cols(cols)), dtype=torch.uint8,
                        device=x2d.device)
    _build.launch("te_mxfp8_quantize_1x", _build.ptr(x2d), x_code,
                  _build.DTYPE_CODES[q_dtype], _build.ptr(data),
                  _build.ptr(scale), int(colwise), m, n, _build.stream(x2d))
    _build.LAUNCHES["mxfp8_quantize_1x"] += 1
    return data, scale


def mxfp8_norm_quantize_2x_plain(x2d, gamma, beta, q_dtype, *, norm,
                                 zero_centered_gamma, epsilon,
                                 rowwise_only=False, stats=None):
    y, mu, rsigma = normed_plain(x2d, gamma, beta, norm=norm,
                                 zero_centered_gamma=zero_centered_gamma,
                                 epsilon=epsilon, stats=stats)
    row, srow = qmath.mxfp8_quantize(y, q_dtype)
    col = scol = None
    if not rowwise_only:
        col, scol = qmath.mxfp8_quantize(y.t(), q_dtype)
    outs = [row, col, srow, scol, rsigma]
    if mu is not None:
        outs.append(mu)
    return tuple(outs)


def mxfp8_norm_quantize_2x(x2d: torch.Tensor, gamma: torch.Tensor,
                           beta: Optional[torch.Tensor],
                           q_dtype: torch.dtype = torch.float8_e4m3fn, *,
                           norm: str = "rmsnorm",
                           zero_centered_gamma: bool = False,
                           epsilon: float = 1e-6,
                           rowwise_only: bool = False):
    """RMSNorm or LayerNorm of ``x2d`` (M, H), M and H multiples of 32,
    fused with the MXFP8 quantize. Returns (row (M, H), col (H, M) or
    None, srow (M, H/32), scol (H, M/32) or None, rsigma (M, 1)) and, for
    LayerNorm, mu (M, 1); ``rowwise_only`` skips the colwise usage."""
    _check_norm_args(x2d, gamma, beta, norm)
    _check_q_dtype(q_dtype)
    m, h = x2d.shape
    if m % 32 or h % 32 or m == 0:
        raise ValueError(f"mxfp8_norm_quantize_2x takes M and H multiples "
                         f"of 32, got {tuple(x2d.shape)}")
    kw = dict(norm=norm, zero_centered_gamma=zero_centered_gamma,
              epsilon=epsilon, rowwise_only=rowwise_only)
    if _build.on_cpu(x2d, gamma, beta):
        return mxfp8_norm_quantize_2x_plain(x2d, gamma, beta, q_dtype, **kw)
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous() if beta is not None else None
    _build.check_aligned(x2d, gamma, beta)
    dev = x2d.device
    row = torch.empty((m, h), dtype=q_dtype, device=dev)
    srow = torch.empty((m, h // 32), dtype=torch.uint8, device=dev)
    col = scol = None
    if not rowwise_only:
        col = torch.empty((h, m), dtype=q_dtype, device=dev)
        scol = torch.empty((h, m // 32), dtype=torch.uint8, device=dev)
    rsigma = torch.empty((m, 1), dtype=torch.float32, device=dev)
    layernorm = norm == "layernorm"
    mu = torch.empty((m, 1), dtype=torch.float32, device=dev) \
        if layernorm else None
    _build.launch("te_mxfp8_norm_quantize", _build.ptr(x2d), x_code,
                  _build.ptr(gamma), _build.ptr(beta),
                  _build.DTYPE_CODES[q_dtype], _build.ptr(row),
                  _build.ptr(col), _build.ptr(srow), _build.ptr(scol),
                  _build.ptr(rsigma), _build.ptr(mu), m, h, int(layernorm),
                  int(zero_centered_gamma), float(epsilon),
                  _build.stream(x2d))
    _build.LAUNCHES["mxfp8_norm_quantize_2x"] += 1
    outs = [row, col, srow, scol, rsigma]
    if layernorm:
        outs.append(mu)
    return tuple(outs)


def mxfp8_qdq_2x_grouped_plain(kernel_ekm: torch.Tensor,
                               q_dtype: torch.dtype = torch.float8_e4m3fn):
    """The reference's chain for any shape: the (E, M, K) view quantized
    along K (``qmath.mxfp8_quantize``), dequantized in bf16 (payload times
    its power-of-two scale, both exact in bf16), and transposed back."""
    e, k, m = kernel_ekm.shape
    swapped = kernel_ekm.transpose(1, 2).reshape(e * m, k)
    data, scale = qmath.mxfp8_quantize(swapped, q_dtype)
    mult = decode_e8m0(scale).to(torch.bfloat16).repeat_interleave(
        32, dim=1)[:, :k]
    tn = (data.to(torch.bfloat16) * mult).reshape(e, m, k)
    return tn.transpose(1, 2).contiguous(), tn


def mxfp8_qdq_2x_grouped(kernel_ekm: torch.Tensor,
                         q_dtype: torch.dtype = torch.float8_e4m3fn):
    """(nn (E, K, M), tn (E, M, K)), both bf16: the (E, K, M) expert
    kernels quantized to MXFP8 along K (E8M0 scales per 32, emax 8 for
    both element types) and dequantized, from one read. None where the
    reference's kernel returns None (K % 32 or M % 128 not 0)."""
    if kernel_ekm.dim() != 3 or kernel_ekm.numel() == 0:
        raise ValueError(f"expected a non-empty (E, K, M) tensor, got "
                         f"{tuple(kernel_ekm.shape)}")
    _check_q_dtype(q_dtype)
    e, k, m = kernel_ekm.shape
    if k % 32 or m % 128:
        return None
    if _build.on_cpu(kernel_ekm):
        return mxfp8_qdq_2x_grouped_plain(kernel_ekm, q_dtype)
    x_code = _build.dtype_code(kernel_ekm, _X_DTYPES)
    x = kernel_ekm.contiguous()
    _build.check_aligned(x)
    nn = torch.empty((e, k, m), dtype=torch.bfloat16, device=x.device)
    tn = torch.empty((e, m, k), dtype=torch.bfloat16, device=x.device)
    _build.launch("te_mxfp8_qdq_2x_grouped", _build.ptr(x), x_code,
                  _build.DTYPE_CODES[q_dtype], _build.ptr(nn), _build.ptr(tn),
                  e, k, m, _build.stream(x))
    _build.LAUNCHES["mxfp8_qdq_2x_grouped"] += 1
    return nn, tn


# ---------------------------------------------------------------------------
# NVFP4
# ---------------------------------------------------------------------------

def _check_nvfp4_input(x2d):
    if x2d.dim() != 2 or x2d.numel() == 0 or x2d.shape[0] % 16 or \
            x2d.shape[1] % 16:
        raise ValueError(f"the NVFP4 kernels take (M, N) with M and N "
                         f"multiples of 16, got {tuple(x2d.shape)}")
    if x2d.numel() >= 2 ** 32:
        raise ValueError(f"the NVFP4 kernels index elements with 32 bits, "
                         f"got {tuple(x2d.shape)}")


def _rotated_t(x2d, rht_mask):
    """x^T, rotated along its last axis when ``rht_mask`` is not None."""
    xt = x2d.t().float()
    return xt if rht_mask is None else rotate(xt, rht_matrix(rht_mask,
                                                             x2d.device))


def nvfp4_amax_2x_plain(x2d: torch.Tensor, rht_mask: Optional[int] = None):
    arow = qmath.compute_amax(x2d)
    if rht_mask is None:
        return arow, arow
    return arow, _rotated_t(x2d, rht_mask).abs().amax()


def nvfp4_amax_2x(x2d: torch.Tensor, rht_mask: Optional[int] = None):
    """(amax(|x|), amax(|RHT(x^T)|)), two 0-d f32 tensors, of ``x2d``
    (M, N) from one read; without ``rht_mask`` the second equals the
    first. ``rht_mask`` is the RHT's sign mask
    (``quantize/hadamard.py``)."""
    _check_nvfp4_input(x2d)
    if _build.on_cpu(x2d):
        return nvfp4_amax_2x_plain(x2d, rht_mask)
    m, n = x2d.shape
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    _build.check_aligned(x2d)
    out = torch.empty((2,), dtype=torch.float32, device=x2d.device)
    _build.launch("te_nvfp4_amax_2x", _build.ptr(x2d), x_code,
                  int(rht_mask is not None), rht_mask or 0, _build.ptr(out),
                  m, n, _build.stream(x2d))
    _build.LAUNCHES["nvfp4_amax_2x"] += 1
    return out.unbind()


def nvfp4_quantize_2x_plain(x2d: torch.Tensor, ts_row: torch.Tensor,
                            ts_col: torch.Tensor,
                            rht_mask: Optional[int] = None,
                            seed: Optional[int] = None):
    m, n = x2d.shape
    ubits = [None, None] if seed is None else [
        qmath.sr_bits(seed, stream, shape, x2d.device)
        for stream, shape in ((0, (m, n)), (1, (n, m)))]
    row, srow = qmath.nvfp4_encode(x2d, ts_row, (1, 16), ubits[0])
    col, scol = qmath.nvfp4_encode(_rotated_t(x2d, rht_mask), ts_col,
                                   (1, 16), ubits[1])
    return row, srow, col, scol


def nvfp4_quantize_2x(x2d: torch.Tensor, ts_row: torch.Tensor,
                      ts_col: torch.Tensor, rht_mask: Optional[int] = None,
                      seed: Optional[int] = None):
    """NVFP4 quantize of ``x2d`` (M, N), M and N multiples of 16, in both
    orientations from one read, under the one-element f32 tensor scales
    ``ts_row`` and ``ts_col``: (row (M, N), srow (M, N/16), col (N, M),
    scol (N, M/16)), payloads and scales in e4m3 bytes. The colwise usage
    is x^T, rotated along M in runs of 16 when ``rht_mask`` is given.
    ``seed`` (0 <= seed < 2^32) rounds stochastically with the bits of
    ``qmath.sr_bits``; without it, to nearest."""
    _check_nvfp4_input(x2d)
    if ts_row.numel() != 1 or ts_col.numel() != 1:
        raise ValueError("ts_row and ts_col must hold one value each")
    if seed is not None and not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    if _build.on_cpu(x2d, ts_row, ts_col):
        return nvfp4_quantize_2x_plain(x2d, ts_row, ts_col, rht_mask, seed)
    m, n = x2d.shape
    x_code = _build.dtype_code(x2d, _X_DTYPES)
    x2d = x2d.contiguous()
    ts = torch.stack([ts_row.reshape(()), ts_col.reshape(())]).float()
    _build.check_aligned(x2d, ts)
    dev = x2d.device
    row = torch.empty((m, n), dtype=FP4_STORAGE_DTYPE, device=dev)
    col = torch.empty((n, m), dtype=FP4_STORAGE_DTYPE, device=dev)
    srow = torch.empty((m, n // 16), dtype=torch.float8_e4m3fn, device=dev)
    scol = torch.empty((n, m // 16), dtype=torch.float8_e4m3fn, device=dev)
    keys = (0, 0) if seed is None else (qmath.sr_key(seed, 0),
                                        qmath.sr_key(seed, 1))
    _build.launch("te_nvfp4_quantize_2x", _build.ptr(x2d), x_code,
                  _build.ptr(ts), int(rht_mask is not None), rht_mask or 0,
                  int(seed is not None), *keys, _build.ptr(row),
                  _build.ptr(srow), _build.ptr(col), _build.ptr(scol), m, n,
                  _build.stream(x2d))
    _build.LAUNCHES["nvfp4_quantize_2x"] += 1
    return row, srow, col, scol
