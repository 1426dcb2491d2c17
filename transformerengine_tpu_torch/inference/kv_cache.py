"""KV caches (counterpart of transformerengine_tpu/inference/kv_cache.py):
quantized cache payloads, FP8 scale calibration, the contiguous BSHD
cache and the paged cache.

Both caches are per-layer dataclasses that the model updates in place
(the reference threads the same arrays through Flax's functional "cache"
collection). No append indexes past its storage:
- the contiguous cache drops a decode token past its ``S_alloc`` rows and
  clamps a prompt's start so that the prompt fits, as the reference's
  scatter and ``dynamic_update_slice`` do (an idle continuous-batching
  slot keeps decoding, and its length keeps growing);
- the paged cache checks its pool and page table: on the CPU it raises at
  once; on the card a write that would leave them is dropped and the
  cache's ``out_of_pages`` flag is set, which :func:`check_pages` turns
  into an error after the engine's steps (no host sync per append).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..quantize.dtypes import dtype_max, float8_e4m3, is_fp8_dtype


@dataclasses.dataclass(frozen=True)
class InferenceParams:
    """Static generation-session parameters. ``is_paged`` selects the
    paged cache of ``page_size`` entries a page. An FP8 cache calibrates
    one scale per slot from each prompt's K/V, unless ``fixed_kv_scale``
    pins it (offline-calibrated serving)."""

    max_batch_size: int
    max_sequence_length: int
    kv_cache_dtype: torch.dtype = torch.bfloat16
    is_paged: bool = False
    page_size: int = 128
    fixed_kv_scale: Optional[float] = None

    @property
    def is_fp8(self) -> bool:
        return is_fp8_dtype(self.kv_cache_dtype)


@dataclasses.dataclass
class KVCache:
    """One attention layer's contiguous cache: ``k`` and ``v`` (B,
    S_alloc, Hkv, D) payloads, ``length`` (B,) int32 filled entries per
    sequence, and ``kv_scale`` (B,) f32 quantization scales of an FP8
    cache (one per slot; the dequant scale is its inverse), which a
    prompt sets to ``fixed_kv_scale`` when that is given."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    kv_scale: torch.Tensor
    fixed_kv_scale: Optional[float] = None

    @classmethod
    def allocate(cls, ip: InferenceParams, num_kv_heads: int, head_dim: int,
                 device) -> "KVCache":
        """Zeros at ``ceil(max_sequence_length / 128) * 128`` entries."""
        b = ip.max_batch_size
        s_alloc = -(-ip.max_sequence_length // 128) * 128
        shape = (b, s_alloc, num_kv_heads, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=ip.kv_cache_dtype, device=device),
            v=torch.zeros(shape, dtype=ip.kv_cache_dtype, device=device),
            length=torch.zeros(b, dtype=torch.int32, device=device),
            kv_scale=torch.ones(b, dtype=torch.float32, device=device),
            fixed_kv_scale=ip.fixed_kv_scale)

    @property
    def is_fp8(self) -> bool:
        return is_fp8_dtype(self.k.dtype)


@dataclasses.dataclass
class PagedKVCache:
    """One attention layer's paged cache (the reference's
    ``PagedKVState`` and its "cache" collection entries): ``pages_k`` and
    ``pages_v`` (num_pages, page_size, Hkv, D) payloads, ``page_table``
    (B, max_pages_per_seq) int32 physical pages (-1 unallocated),
    ``length`` (B,) int32, ``free_head`` (1,) int32 next free physical
    page, ``kv_scale`` (B,) f32 per-slot FP8 scales, and ``out_of_pages``
    (1,) bool, set where an append on the card found no room."""

    pages_k: torch.Tensor
    pages_v: torch.Tensor
    page_table: torch.Tensor
    length: torch.Tensor
    free_head: torch.Tensor
    kv_scale: torch.Tensor
    out_of_pages: torch.Tensor
    fixed_kv_scale: Optional[float] = None

    @classmethod
    def allocate(cls, ip: InferenceParams, num_kv_heads: int, head_dim: int,
                 device) -> "PagedKVCache":
        """An empty cache whose pool holds ``max_pages_per_seq`` pages for
        every sequence, ``ceil(max_sequence_length / page_size)`` each,
        as the reference sizes it."""
        b, page = ip.max_batch_size, ip.page_size
        mpps = -(-ip.max_sequence_length // page)
        cache = paged_init(b * mpps, page, b, mpps, num_kv_heads, head_dim,
                           ip.kv_cache_dtype, device)
        cache.fixed_kv_scale = ip.fixed_kv_scale
        return cache

    @property
    def is_fp8(self) -> bool:
        return is_fp8_dtype(self.pages_k.dtype)

    @property
    def num_pages(self) -> int:
        return self.pages_k.shape[0]

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[1]


def quantize_for_cache(x: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Scale-and-saturate cast into the cache payload dtype; ``scale`` is
    (1,) or (B,) against (B, ...)."""
    if not is_fp8_dtype(dtype):
        return x.to(dtype)
    m = dtype_max(dtype)
    s = scale.float().reshape((-1,) + (1,) * (x.dim() - 1))
    return (x.float() * s).clamp(-m, m).to(dtype)


def calibrate_kv_scale(k: torch.Tensor, v: torch.Tensor,
                       margin: float = 2.0,
                       per_slot: bool = False) -> torch.Tensor:
    """FP8 cache scale from the prompt's amax with ``margin`` headroom:
    (1,), or (B,) with ``per_slot``. The amax covers the whole (padded)
    prompt, pad positions included."""
    kf, vf = k.float().abs(), v.float().abs()
    if per_slot:
        amax = torch.maximum(kf.amax(dim=(1, 2, 3)), vf.amax(dim=(1, 2, 3)))
    else:
        amax = torch.maximum(kf.amax(), vf.amax()).reshape(1)
    q_max = torch.full_like(amax, dtype_max(float8_e4m3))
    return torch.where(amax > 0, q_max / (amax * margin),
                       torch.ones_like(amax))


def _unit_scale(x: torch.Tensor, kv_scale: Optional[torch.Tensor]):
    if kv_scale is not None:
        return kv_scale
    return torch.ones(1, dtype=torch.float32, device=x.device)


def cache_append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 kv_scale: Optional[torch.Tensor] = None) -> None:
    """Writes (B, S_new, Hkv, D) new entries at each sequence's length and
    advances the lengths, in place. A single token past ``S_alloc`` is
    dropped; a prompt starts at ``min(length, S_alloc - S_new)``."""
    b, s = k_new.shape[:2]
    s_alloc = cache.k.shape[1]
    if s > s_alloc:
        raise ValueError(f"{s} new entries exceed the cache's {s_alloc}")
    scale = _unit_scale(k_new, kv_scale)
    kq = quantize_for_cache(k_new, scale, cache.k.dtype)
    vq = quantize_for_cache(v_new, scale, cache.v.dtype)
    start = cache.length.long()
    if s == 1:
        rows = torch.arange(b, device=k_new.device)
        inside = (start < s_alloc)[:, None, None]
        col = start.clamp(max=s_alloc - 1)
        cache.k[rows, col] = torch.where(inside, kq[:, 0], cache.k[rows, col])
        cache.v[rows, col] = torch.where(inside, vq[:, 0], cache.v[rows, col])
    else:
        rows = torch.arange(b, device=k_new.device)[:, None]
        cols = start.clamp(max=s_alloc - s)[:, None] + torch.arange(
            s, device=k_new.device)[None, :]
        cache.k[rows, cols] = kq
        cache.v[rows, cols] = vq
    cache.length += s


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def paged_init(num_pages: int, page_size: int, batch: int,
               max_pages_per_seq: int, hkv: int, d: int,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> PagedKVCache:
    """An empty paged cache: zero pages, an unallocated table, on the card
    unless ``device`` asks for the CPU (without a card it raises)."""
    device = resolve_device(device)
    shape = (num_pages, page_size, hkv, d)
    return PagedKVCache(
        pages_k=torch.zeros(shape, dtype=dtype, device=device),
        pages_v=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.full((batch, max_pages_per_seq), -1,
                              dtype=torch.int32, device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device),
        free_head=torch.zeros(1, dtype=torch.int32, device=device),
        kv_scale=torch.ones(batch, dtype=torch.float32, device=device),
        out_of_pages=torch.zeros(1, dtype=torch.bool, device=device))


def _check_room(cache: PagedKVCache, ok: torch.Tensor, what: str) -> None:
    """Raises on the CPU where ``ok`` is not all true; on the card records
    it in ``out_of_pages`` for :func:`check_pages`."""
    if ok.is_cuda:
        cache.out_of_pages |= ~ok.all()
    elif not bool(ok.all()):
        raise RuntimeError(
            f"paged KV cache out of room: {what} (pool of {cache.num_pages} "
            f"pages, {cache.page_table.shape[1]} a sequence)")


def check_pages(caches: Sequence) -> None:
    """Raises if an append into any of the paged ``caches`` found no room
    (one host sync for them all)."""
    flags = [c.out_of_pages for c in caches if isinstance(c, PagedKVCache)]
    if flags and bool(torch.cat(flags).any()):
        raise RuntimeError("paged KV cache out of room: a sequence outgrew "
                           "its page table or the pool ran out of pages")


def paged_append_token(cache: PagedKVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor,
                       kv_scale: Optional[torch.Tensor] = None) -> None:
    """Appends one token per sequence ((B, 1, Hkv, D)) in place. A page is
    allocated where the token starts a page (``offset == 0``) and the
    table holds none for it yet; the reference allocates at every
    ``offset == 0``, which leaks the page a prompt already filled when
    the prefill's rewind leaves a length on a page boundary. Pages come
    from ``free_head`` in batch order."""
    b = k_new.shape[0]
    page, n_pages = cache.page_size, cache.num_pages
    mpps = cache.page_table.shape[1]
    scale = _unit_scale(k_new, kv_scale)
    kq = quantize_for_cache(k_new[:, 0], scale, cache.pages_k.dtype)
    vq = quantize_for_cache(v_new[:, 0], scale, cache.pages_v.dtype)
    rows = torch.arange(b, device=k_new.device)
    length = cache.length.long()
    logical = length // page
    offset = length % page
    in_table = logical < mpps
    logical = logical.clamp(max=mpps - 1)
    held = cache.page_table[rows, logical].long()
    needs = (offset == 0) & (held < 0) & in_table
    new_phys = cache.free_head.long() + torch.cumsum(needs.long(), 0) - 1
    phys = torch.where(needs, new_phys, held)
    ok = in_table & (phys >= 0) & (phys < n_pages)
    _check_room(cache, ok, "a decode token")
    cache.page_table[rows, logical] = torch.where(
        needs & ok, phys, held).to(torch.int32)
    slot = phys.clamp(0, n_pages - 1)
    keep = ok[:, None, None]
    cache.pages_k[slot, offset] = torch.where(keep, kq,
                                              cache.pages_k[slot, offset])
    cache.pages_v[slot, offset] = torch.where(keep, vq,
                                              cache.pages_v[slot, offset])
    cache.length += 1
    cache.free_head += needs.sum().to(torch.int32)


def paged_append_prompt(cache: PagedKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        kv_scale: Optional[torch.Tensor] = None) -> None:
    """Appends a full prompt (B, S, Hkv, D) into an EMPTY paged cache, in
    place: sequence b takes the physical pages ``free_head + b * npp``
    onward, ``npp = ceil(S / page_size)``, as the reference allocates."""
    b, s, hkv, d = k_new.shape
    page, n_pages = cache.page_size, cache.num_pages
    npp = -(-s // page)
    if npp > cache.page_table.shape[1]:
        raise ValueError(f"a prompt of {s} entries needs {npp} pages, more "
                         f"than the table's {cache.page_table.shape[1]}")
    scale = _unit_scale(k_new, kv_scale)
    pad = npp * page - s

    def chunks(x, dtype):
        xq = quantize_for_cache(x, scale, dtype)
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 0, 0, pad))
        return xq.reshape(b * npp, page, hkv, d)

    phys = cache.free_head.long() + torch.arange(b * npp,
                                                 device=k_new.device)
    ok = phys < n_pages
    _check_room(cache, ok, "a prompt")
    slot = phys.clamp(max=n_pages - 1)
    keep = ok[:, None, None, None]
    cache.pages_k[slot] = torch.where(keep, chunks(k_new, cache.pages_k.dtype),
                                      cache.pages_k[slot])
    cache.pages_v[slot] = torch.where(keep, chunks(v_new, cache.pages_v.dtype),
                                      cache.pages_v[slot])
    cache.page_table[:, :npp] = torch.where(
        ok, phys, -1).reshape(b, npp).to(torch.int32)
    cache.length += s
    cache.free_head += b * npp


def paged_gather_kv(cache: PagedKVCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, max_pages * page_size, Hkv, D) contiguous views of the pages
    (unallocated table entries read page 0, as the reference clamps)."""
    b, mpps = cache.page_table.shape
    idx = cache.page_table.long().clamp(0, cache.num_pages - 1)
    k, v = cache.pages_k[idx], cache.pages_v[idx]
    return (k.reshape(b, -1, *k.shape[3:]), v.reshape(b, -1, *v.shape[3:]))
