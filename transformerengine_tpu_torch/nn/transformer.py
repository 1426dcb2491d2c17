"""Transformer blocks (counterpart of transformerengine_tpu/flax/
transformer.py): causal self-attention with RMSNorm, RoPE, GQA and the
contiguous or paged KV cache, and a decoder-only TransformerLayer.
Without a cache the forward is the training forward, differentiable end
to end. Not ported yet: other masks and norms, MoE, cross-attention,
relative position bias, dropout, sliding windows and softmax sinks."""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..attention import AttnMaskType, SequenceDescriptor, fused_attn
from ..inference.kv_cache import (KVCache, PagedKVCache, cache_append,
                                  calibrate_kv_scale, paged_append_prompt,
                                  paged_append_token)
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.rope import apply_rope, rope_frequencies
from .module import DenseGeneral, LayerNormDenseGeneral, LayerNormMLP


class MultiHeadAttention(nn.Module):
    """norm -> fused QKV projection -> RoPE -> attention -> output
    projection. Submodules ``qkv`` and ``out`` carry the reference's
    parameter names."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6,
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.head_dim = head_dim or hidden_size // num_attention_heads
        self.num_heads = num_attention_heads
        self.num_kv_heads = num_gqa_groups or num_attention_heads
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        self.qkv = LayerNormDenseGeneral(
            hidden_size, (hq + 2 * hkv) * d, epsilon=layernorm_epsilon,
            dtype=dtype, device=device, generator=generator)
        self.out = DenseGeneral(hq * d, hidden_size, dtype=dtype,
                                device=device, generator=generator)
        self.register_buffer(
            "freqs", rope_frequencies(d, max_seq_len,
                                      base=rotary_pos_emb_base,
                                      device=device),
            persistent=False)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None, *,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None
                ) -> torch.Tensor:
        """Causal attention, padding-causal where ``sequence_descriptor``
        gives the lengths; differentiable without a cache. ``kv_cache``:
        the layer's cache. A call with
        S > 1 tokens is a prefill into an empty cache; S == 1 is a decode
        step. Positions continue from the cache's lengths."""
        b, s = x.shape[:2]
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        qkv = self.qkv(x)
        q = qkv[..., :hq * d].reshape(b, s, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d)
        positions = None
        if kv_cache is not None:
            # Clamped into the table, as the reference's gather clamps: an
            # idle continuous-batching slot's length keeps growing.
            positions = (kv_cache.length[:, None] + torch.arange(
                s, device=x.device)[None, :]).clamp(
                    max=self.freqs.shape[0] - 1)
        q = apply_rope(q, self.freqs, positions=positions)
        k = apply_rope(k, self.freqs, positions=positions)
        if kv_cache is not None:
            ctx = self._cached_attention(q, k, v, kv_cache,
                                         sequence_descriptor)
        else:
            # Training and cache-free forward: the reference's
            # DotProductAttention through fused_attn (flash backend).
            ctx = fused_attn(
                (q, k, v), sequence_descriptor,
                attn_mask_type=(AttnMaskType.PADDING_CAUSAL
                                if sequence_descriptor is not None
                                else AttnMaskType.CAUSAL))
        return self.out(ctx.reshape(b, s, hq * d))

    def _cached_attention(self, q, k, v, cache, sequence_descriptor
                          ) -> torch.Tensor:
        """Prefill: set an FP8 cache's per-slot scales (the cache's
        ``fixed_kv_scale``, else calibrated from the whole padded prompt),
        append, and attend causally within the prompt (the cache was
        empty). Decode: append the token and attend over the cache, a
        :class:`KVCache` through the decode kernel, a
        :class:`PagedKVCache` through the paged one."""
        b = k.shape[0]
        if b != cache.length.shape[0]:
            raise ValueError(f"batch {b} != the cache's batch "
                             f"{cache.length.shape[0]}")
        is_prefill = k.shape[1] > 1
        if is_prefill and cache.is_fp8:
            if cache.fixed_kv_scale is not None:
                cache.kv_scale.fill_(cache.fixed_kv_scale)
            else:
                cache.kv_scale.copy_(calibrate_kv_scale(k, v, per_slot=True))
        qscale = cache.kv_scale if cache.is_fp8 else None
        paged = isinstance(cache, PagedKVCache)
        if not paged:
            cache_append(cache, k, v, qscale)
        elif is_prefill:
            paged_append_prompt(cache, k, v, qscale)
        else:
            paged_append_token(cache, k, v, qscale)
        if is_prefill:
            seqlens = (sequence_descriptor.q_seqlens
                       if sequence_descriptor is not None else None)
            desc = (SequenceDescriptor.from_seqlens(seqlens)
                    if seqlens is not None else None)
            return flash_attention(
                q, k, v, desc,
                attn_mask_type=(AttnMaskType.PADDING_CAUSAL if desc is not None
                                else AttnMaskType.CAUSAL))
        dq_scale = (1.0 / cache.kv_scale) if cache.is_fp8 else None
        if paged:
            return paged_decode_attention(
                q, cache.pages_k, cache.pages_v, cache.page_table,
                cache.length, kv_scale=dq_scale)
        return decode_attention(q, cache.k, cache.v, cache.length,
                                kv_scale=dq_scale)


class TransformerLayer(nn.Module):
    """Decoder-only pre-norm layer: ``x + attn(x)``, then ``x + mlp(x)``,
    with submodules ``self_attention`` and ``mlp``."""

    def __init__(self, hidden_size: int, mlp_hidden_size: int,
                 num_attention_heads: int, *, head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6, mlp_activations="swiglu",
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            hidden_size, num_attention_heads, head_dim=head_dim,
            num_gqa_groups=num_gqa_groups,
            layernorm_epsilon=layernorm_epsilon,
            rotary_pos_emb_base=rotary_pos_emb_base,
            max_seq_len=max_seq_len, dtype=dtype, device=device,
            generator=generator)
        self.mlp = LayerNormMLP(
            hidden_size, mlp_hidden_size, epsilon=layernorm_epsilon,
            activations=mlp_activations, dtype=dtype, device=device,
            generator=generator)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None, *,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None
                ) -> torch.Tensor:
        x = x + self.self_attention(x, sequence_descriptor,
                                    kv_cache=kv_cache)
        return x + self.mlp(x)
