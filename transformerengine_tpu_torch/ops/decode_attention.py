"""Decode attention: one query token per sequence over a BSHD KV cache
(counterpart of transformerengine_tpu/ops/decode_attention.py
decode_attention).

On CUDA tensors it launches the kernel in ``csrc/decode_attention.cu``,
which follows the reference's Pallas form (``_decode_kernel``: K and V
dequantized to f32 before both products, online softmax), with a
sequence's keys split across blocks and their partial softmaxes combined
in the same launch. On CPU tensors
it runs :func:`decode_attention_plain`, the reference's default einsum
form: bf16 operands for fp8 and bf16 caches (so the softmax weights are
rounded to bf16 before the PV product) with ``kv_scale`` applied to the
f32 scores and output. The two forms differ by that rounding.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30

_Q_DTYPES = (torch.float32, torch.bfloat16)
_CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)

# The decode kernels' keys a tile, splits of a sequence at most, and
# (batch row, kv head) pairs at most (kBS, kMaxSplits and kMaxRows in
# csrc/decode_attn.cuh).
TILE = 64
MAX_SPLITS = 64
MAX_ROWS = 16384


def split_workspace(b: int, hq: int, hkv: int, d: int, span: int, device):
    """The f32 workspace of the decode kernels' partial softmaxes for rows
    that reach at most ``span`` keys, and the splits it holds: (None, 1)
    where a row is one tile. Raises where B * Hkv exceeds the kernels'
    ticket counters."""
    if b * hkv > MAX_ROWS:
        raise ValueError(f"the decode kernels take B * Hkv <= {MAX_ROWS}, "
                         f"got {b} * {hkv}")
    splits = min(-(-span // TILE), MAX_SPLITS)
    if splits <= 1:
        return None, 1
    return torch.empty(splits * b * hq * (d + 2), dtype=torch.float32,
                       device=device), splits


def decode_attention_plain(q, k_cache, v_cache, lengths, *, kv_scale,
                           scale: float, window_left: int = -1,
                           out_dtype, softmax_sink=None) -> torch.Tensor:
    """q (B, 1, Hq, D); caches (B, S, Hkv, D); kv_scale (1,) or (B,)."""
    b, _, hq, d = q.shape
    s_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    op_dtype = torch.float32 if k_cache.dtype == torch.float32 \
        else torch.bfloat16
    qg = q[:, 0].reshape(b, hkv, g, d).to(op_dtype)
    kv = kv_scale.float().reshape(-1, 1, 1, 1)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    s = s * kv
    kpos = torch.arange(s_len, device=q.device)[None, None, None, :]
    lens = lengths.reshape(-1, 1, 1, 1)
    mask = kpos < lens
    if window_left >= 0:
        mask = mask & (kpos >= lens - 1 - window_left)
    s = torch.where(mask, s, NEG_INF)
    if softmax_sink is not None:
        s0 = softmax_sink.float().reshape(1, hkv, g, 1).expand(b, hkv, g, 1)
        p = torch.softmax(torch.cat([s, s0], dim=-1), dim=-1)[..., :-1]
    else:
        p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(op_dtype).float(),
                     v_cache.float()) * kv
    return o.reshape(b, 1, hq, d).to(out_dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     kv_scale=None, scaling_factor: Optional[float] = None,
                     window_left: int = -1, out_dtype=None,
                     softmax_sink: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(B, 1, Hq, D) attention output of the newest token.

    ``q`` is (B, 1, Hq, D) or (B, Hq, D); the caches are (B, S, Hkv, D)
    e4m3, bf16 or f32 payloads; ``lengths`` (B,) counts each sequence's
    valid cache entries; ``kv_scale`` is the (1,) or (B,) dequant scale;
    ``window_left`` >= 0 limits attention to that many earlier tokens;
    ``softmax_sink`` (Hq,) adds one virtual key per head."""
    if q.dim() == 3:
        q = q[:, None]
    b, one, hq, d = q.shape
    if one != 1 or k_cache.shape != v_cache.shape or k_cache.dim() != 4 \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"expected q (B, 1, Hq, D) and caches (B, S, Hkv, "
                         f"D), got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    scale = float(scaling_factor if scaling_factor is not None
                  else 1.0 / d ** 0.5)
    out_dtype = out_dtype or (q.dtype if q.dtype in _Q_DTYPES
                              else torch.bfloat16)
    if kv_scale is None:
        kv_scale = torch.ones((1,), dtype=torch.float32, device=q.device)
    kv_scale = torch.as_tensor(kv_scale, dtype=torch.float32,
                               device=q.device).reshape(-1)
    if kv_scale.numel() not in (1, b):
        raise ValueError(f"kv_scale must hold 1 or B={b} values")
    if _build.on_cpu(q, k_cache, v_cache, lengths, softmax_sink):
        return decode_attention_plain(
            q, k_cache, v_cache, lengths, kv_scale=kv_scale, scale=scale,
            window_left=window_left, out_dtype=out_dtype,
            softmax_sink=softmax_sink)
    if out_dtype != q.dtype:
        raise TypeError("the decode kernel writes the output in q's dtype")
    if hq // hkv > 32 or d > 256 or d % 16:
        raise ValueError(f"the decode kernel takes Hq/Hkv <= 32, D <= 256 "
                         f"and D % 16 == 0, got {hq}/{hkv} and {d}")
    q_code = _build.dtype_code(q, _Q_DTYPES)
    c_code = _build.dtype_code(k_cache, _CACHE_DTYPES)
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("k_cache and v_cache must share one dtype")
    q3 = q.reshape(b, hq, d).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if softmax_sink is not None:
        softmax_sink = softmax_sink.float().reshape(hq).contiguous()
    _build.check_aligned(q3, k_cache, v_cache, lengths, kv_scale,
                         softmax_sink)
    span = s_max if window_left < 0 else min(s_max, window_left + TILE)
    ws, max_splits = split_workspace(b, hq, hkv, d, span, q3.device)
    out = torch.empty_like(q3)
    _build.launch("te_decode_attention", _build.ptr(q3), q_code,
                  _build.ptr(k_cache), _build.ptr(v_cache), c_code,
                  _build.ptr(lengths), _build.ptr(kv_scale),
                  int(kv_scale.numel() > 1), _build.ptr(softmax_sink),
                  _build.ptr(out), _build.ptr(ws), max_splits, b, s_max, hq,
                  hkv, d, scale, window_left, _build.stream(q3))
    _build.LAUNCHES["decode_attention"] += 1
    return out.reshape(b, 1, hq, d)
