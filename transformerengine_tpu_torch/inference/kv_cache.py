"""KV cache (counterpart of the contiguous half of transformerengine_tpu/
inference/kv_cache.py): quantized cache payloads, FP8 scale calibration
and the BSHD append. The paged cache is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quantize.dtypes import dtype_max, float8_e4m3, is_fp8_dtype


@dataclasses.dataclass(frozen=True)
class InferenceParams:
    """Static generation-session parameters. An FP8 cache calibrates its
    scales from each prompt's K/V."""

    max_batch_size: int
    max_sequence_length: int
    kv_cache_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class KVCache:
    """One attention layer's cache, updated in place by every forward
    that is given it (the reference keeps the same four arrays in Flax's
    functional "cache" collection): ``k`` and ``v`` (B, S_alloc, Hkv, D)
    payloads, ``length`` (B,) int32 filled entries per sequence, and
    ``kv_scale`` (B,) f32 quantization scales of an FP8 cache (one per
    slot; the dequant scale is its inverse)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    kv_scale: torch.Tensor

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
            kv_scale=torch.ones(b, dtype=torch.float32, device=device))

    @property
    def is_fp8(self) -> bool:
        return is_fp8_dtype(self.k.dtype)


def quantize_for_cache(x: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Scale-and-saturate cast into the cache payload dtype; ``scale`` is
    (1,) or (B,) against (B, S, H, D)."""
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


def cache_append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 kv_scale: Optional[torch.Tensor] = None) -> None:
    """Writes (B, S_new, Hkv, D) new entries at each sequence's length and
    advances the lengths, in place."""
    b, s = k_new.shape[:2]
    scale = kv_scale if kv_scale is not None else torch.ones(
        1, dtype=torch.float32, device=k_new.device)
    rows = torch.arange(b, device=k_new.device)[:, None]
    cols = cache.length.long()[:, None] + torch.arange(
        s, device=k_new.device)[None, :]
    cache.k[rows, cols] = quantize_for_cache(k_new, scale, cache.k.dtype)
    cache.v[rows, cols] = quantize_for_cache(v_new, scale, cache.v.dtype)
    cache.length += s
