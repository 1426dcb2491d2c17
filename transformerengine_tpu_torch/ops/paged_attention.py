"""Paged decode attention: one query token per sequence over a paged KV
cache, read through the page table (counterpart of
transformerengine_tpu/ops/paged_attention.py paged_decode_attention).

On CUDA tensors it launches the kernel in
``csrc/paged_decode_attention.cu``, which reads the (num_pages, page,
Hkv, D) pool in place; on CPU tensors it runs
:func:`paged_decode_attention_plain`. Both follow the reference's only
form, its Pallas kernel ``_paged_kernel``: K and V dequantized to f32 by
the slot's scale, f32 scores times the softmax scale, a masked
natural-exp softmax (a row with no valid key gives 0), and the sink as
one more no-value key in the denominator.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30

_Q_DTYPES = (torch.float32, torch.bfloat16)
_CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)


def paged_decode_attention_plain(q, pages_k, pages_v, page_table, lengths, *,
                                 kv_scale, scale: float, out_dtype,
                                 softmax_sink=None) -> torch.Tensor:
    """q (B, 1, Hq, D); pages (P, page, Hkv, D); page_table (B, max_pages);
    kv_scale (1,) or (B,) dequant scales. Table entries are clamped into
    the pool, and a sequence reads at most ``max_pages * page`` entries."""
    b, _, hq, d = q.shape
    n_pages, page, hkv, _ = pages_k.shape
    g = hq // hkv
    idx = page_table.long().clamp(0, n_pages - 1)
    kv = kv_scale.float().reshape(-1, 1, 1, 1)
    k = pages_k[idx].float().reshape(b, -1, hkv, d) * kv     # (B, S, Hkv, D)
    v = pages_v[idx].float().reshape(b, -1, hkv, d) * kv
    qg = q[:, 0].float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, None, :] < lengths.reshape(-1, 1, 1, 1)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if softmax_sink is not None:
        s0 = softmax_sink.float().reshape(1, hkv, g, 1)
        m = torch.maximum(m, s0)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if softmax_sink is not None:
        l = l + torch.exp(s0 - m)
    else:
        l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / l
    return o.reshape(b, 1, hq, d).to(out_dtype)


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                           pages_v: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, kv_scale=None,
                           scaling_factor: Optional[float] = None,
                           out_dtype=None,
                           softmax_sink: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(B, 1, Hq, D) attention output of the newest token.

    ``q`` is (B, 1, Hq, D) or (B, Hq, D); the pages are (num_pages, page,
    Hkv, D) e4m3, bf16 or f32 payloads; ``page_table`` (B, max_pages)
    int32 maps each sequence's logical pages to physical ones (-1
    unallocated); ``lengths`` (B,) counts valid entries; ``kv_scale`` is
    the (1,) or (B,) dequant scale; ``softmax_sink`` (Hq,) adds one
    virtual key per head."""
    if q.dim() == 3:
        q = q[:, None]
    b, one, hq, d = q.shape
    if one != 1 or pages_k.shape != pages_v.shape or pages_k.dim() != 4 \
            or pages_k.shape[3] != d or page_table.dim() != 2 \
            or page_table.shape[0] != b:
        raise ValueError(f"expected q (B, 1, Hq, D), pages (P, page, Hkv, D) "
                         f"and a table (B, max_pages), got {tuple(q.shape)}, "
                         f"{tuple(pages_k.shape)}, {tuple(page_table.shape)}")
    n_pages, page, hkv, _ = pages_k.shape
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
    if _build.on_cpu(q, pages_k, pages_v, page_table, lengths, softmax_sink):
        return paged_decode_attention_plain(
            q, pages_k, pages_v, page_table, lengths, kv_scale=kv_scale,
            scale=scale, out_dtype=out_dtype, softmax_sink=softmax_sink)
    if out_dtype != q.dtype:
        raise TypeError("the paged kernel writes the output in q's dtype")
    if hq // hkv > 32 or d > 256 or d % 16:
        raise ValueError(f"the paged kernel takes Hq/Hkv <= 32, D <= 256 and "
                         f"D % 16 == 0, got {hq}/{hkv} and {d}")
    q_code = _build.dtype_code(q, _Q_DTYPES)
    c_code = _build.dtype_code(pages_k, _CACHE_DTYPES)
    if pages_v.dtype != pages_k.dtype:
        raise TypeError("pages_k and pages_v must share one dtype")
    q3 = q.reshape(b, hq, d).contiguous()
    table = page_table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if softmax_sink is not None:
        softmax_sink = softmax_sink.float().reshape(hq).contiguous()
    _build.check_aligned(q3, pages_k, pages_v, table, lengths, kv_scale,
                         softmax_sink)
    out = torch.empty_like(q3)
    _build.launch("te_paged_decode_attention", _build.ptr(q3), q_code,
                  _build.ptr(pages_k), _build.ptr(pages_v), c_code,
                  _build.ptr(table), _build.ptr(lengths),
                  _build.ptr(kv_scale), int(kv_scale.numel() > 1),
                  _build.ptr(softmax_sink), _build.ptr(out), b, n_pages,
                  page, table.shape[1], hq, hkv, d, scale, _build.stream(q3))
    _build.LAUNCHES["paged_decode_attention"] += 1
    return out.reshape(b, 1, hq, d)
