"""Transformer blocks (counterpart of transformerengine_tpu/flax/
transformer.py): causal self-attention with RMSNorm, RoPE, GQA and the
contiguous or paged KV cache, and a decoder-only TransformerLayer whose
MLP is dense or, with ``num_moe_experts`` > 0, a top-k routed mixture of
experts (single device). Without a cache the forward is the training
forward, differentiable end to end. Attention takes biased projections,
a static sliding window and the softmax sink types; a learnable sink is
the attention's f32 ``softmax_offset``, which training and the caches
share. Under a recipe with ``fp8_dpa`` the cache-free attention runs on
FP8 Q/K/V, and with ``fp8_mha`` too (per-tensor recipes, no biases) the
attention and the output projection run as one FP8 function. A packed
batch (a descriptor with segment ids) and its per-document ``positions``
run through the same cache-free path. Not ported yet: other masks and
norms, expert parallelism, cross-attention, relative position bias and
dropout."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..attention import (AttnMaskType, SequenceDescriptor, SoftmaxType,
                         fused_attn)
from ..common.recipe import DelayedScaling, Float8CurrentScaling
from ..inference.kv_cache import (KVCache, PagedKVCache, cache_append,
                                  calibrate_kv_scale, paged_append_prompt,
                                  paged_append_token)
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.rope import apply_rope, rope_frequencies
from ..quantize.helper import get_quantize_config
from ..quantize.quantizer import CurrentScaleQuantizer, QuantizeLayout
from .module import DenseGeneral, LayerNormDenseGeneral, LayerNormMLP
from .moe import MoELayerNormMLP


def _fp8_qkv_quantizers():
    """The three current-scaling e4m3 quantizers of FP8 Q/K/V (the
    reference's fp8_dpa gate makes them afresh at every call)."""
    return tuple(CurrentScaleQuantizer(torch.float8_e4m3fn,
                                       QuantizeLayout.ROWWISE)
                 for _ in range(3))


def _fp8_dpa_active(recipe) -> bool:
    """The reference's fp8_dpa gate: any active recipe with the flag (the
    port's attention has no bias, dropout or context parallelism, which
    close it there)."""
    return recipe is not None and getattr(recipe, "fp8_dpa", False)


def _fp8_mha_active(recipe, use_bias: bool) -> bool:
    """The reference's fp8_mha gate (``_fp8_mha_active``): a per-tensor
    recipe with both flags and no biased projections."""
    return (isinstance(recipe, (DelayedScaling, Float8CurrentScaling))
            and recipe.fp8_mha and recipe.fp8_dpa and not use_bias)


class MultiHeadAttention(nn.Module):
    """norm -> fused QKV projection -> RoPE -> attention -> output
    projection. Submodules ``qkv`` and ``out`` carry the reference's
    parameter names (each with a ``bias`` under ``use_bias``).
    ``window_size`` (left, right) bands the attention; ``softmax_type``
    LEARNABLE owns an f32 ``softmax_offset`` (Hq,), zeros at init."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6,
                 use_bias: bool = False,
                 window_size: Optional[Tuple[int, int]] = None,
                 softmax_type: Optional[SoftmaxType] = None,
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.head_dim = head_dim or hidden_size // num_attention_heads
        self.num_heads = num_attention_heads
        self.num_kv_heads = num_gqa_groups or num_attention_heads
        self.window_size = (tuple(window_size) if window_size is not None
                            else None)
        self.softmax_type = softmax_type or SoftmaxType.VANILLA
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        self.softmax_offset = (
            nn.Parameter(torch.zeros(hq, dtype=torch.float32, device=device))
            if self.softmax_type is SoftmaxType.LEARNABLE else None)
        self.qkv = LayerNormDenseGeneral(
            hidden_size, (hq + 2 * hkv) * d, epsilon=layernorm_epsilon,
            use_bias=use_bias, dtype=dtype, device=device,
            generator=generator)
        self.out = DenseGeneral(hq * d, hidden_size, use_bias=use_bias,
                                dtype=dtype, device=device,
                                generator=generator)
        self.register_buffer(
            "freqs", rope_frequencies(d, max_seq_len,
                                      base=rotary_pos_emb_base,
                                      device=device),
            persistent=False)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None
                ) -> torch.Tensor:
        """Causal attention, padding-causal where ``sequence_descriptor``
        gives the lengths or the segment ids of a packed batch;
        differentiable without a cache. ``positions`` (B, S): each
        token's RoPE position (a packed batch's positions within its
        document); by default 0..S-1, or with a cache continuing from its
        lengths. ``kv_cache``: the layer's cache. A call with S > 1
        tokens is a prefill into an empty cache; S == 1 is a decode step;
        the cached path reads only the descriptor's lengths, as the
        reference's does."""
        b, s = x.shape[:2]
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        qkv = self.qkv(x)
        q = qkv[..., :hq * d].reshape(b, s, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d)
        if positions is None and kv_cache is not None:
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
            cfg = get_quantize_config()
            recipe = cfg.recipe if cfg.enabled else None
            mask = (AttnMaskType.PADDING_CAUSAL
                    if sequence_descriptor is not None
                    else AttnMaskType.CAUSAL)
            if _fp8_mha_active(recipe, self.out.bias is not None):
                return self._fp8_mha(q, k, v, sequence_descriptor, mask)
            # Training and cache-free forward: the reference's
            # DotProductAttention through fused_attn (flash backend).
            ctx = fused_attn(
                (q, k, v), sequence_descriptor, attn_mask_type=mask,
                window_size=self.window_size, softmax_type=self.softmax_type,
                softmax_offset=self.softmax_offset,
                qkv_quantizers=(_fp8_qkv_quantizers()
                                if _fp8_dpa_active(recipe) else None))
        return self.out(ctx.reshape(b, s, hq * d))

    def _fp8_mha(self, q, k, v, sequence_descriptor, mask) -> torch.Tensor:
        """The reference's ``_FP8MHAOutProj``: flash attention and the
        output projection in one FP8 function, on ``out``'s own kernel,
        its "dense" quantizer set (the kernel and the gradient; its x
        quantizer is made and stays unused, as in the reference) and the
        set "fp8_mha_o" (O and dO), whose delayed state lives in ``out``'s
        ``fp8_mha_o_*`` buffers."""
        pset = self.out.quantizer_set("dense")
        oset = self.out.quantizer_set("fp8_mha_o")
        quantizers = (*_fp8_qkv_quantizers(), oset.x, pset.kernel,
                      pset.dgrad, oset.dgrad)
        return flash_attention(
            q, k, v, sequence_descriptor, attn_mask_type=mask,
            window_size=self.window_size,
            softmax_type=(None if self.softmax_type is SoftmaxType.VANILLA
                          else self.softmax_type),
            softmax_offset=self.softmax_offset,
            mha_proj=(self.out.kernel, quantizers))

    def _sink(self, device) -> Optional[torch.Tensor]:
        """The (Hq,) f32 sink logits the caches' kernels take, or None."""
        if self.softmax_type is SoftmaxType.OFF_BY_ONE:
            return torch.zeros(self.num_heads, dtype=torch.float32,
                               device=device)
        return self.softmax_offset

    def _cached_attention(self, q, k, v, cache, sequence_descriptor
                          ) -> torch.Tensor:
        """Prefill: set an FP8 cache's per-slot scales (the cache's
        ``fixed_kv_scale``, else calibrated from the whole padded prompt),
        append, and attend causally within the prompt (the cache was
        empty). Decode: append the token and attend over the cache, a
        :class:`KVCache` through the decode kernel, a
        :class:`PagedKVCache` through the paged one. A windowed layer
        refuses the paged cache: the reference's paged path drops the
        window (ROADMAP.md, Queue 3), and the port does not copy that."""
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
        window = self.window_size
        if paged and window is not None and tuple(window) != (-1, -1):
            raise NotImplementedError(
                "a sliding-window layer on the paged cache is not ported")
        sink = self._sink(q.device)
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
                                else AttnMaskType.CAUSAL),
                window_size=window,
                softmax_type=(None if self.softmax_type is SoftmaxType.VANILLA
                              else self.softmax_type),
                softmax_offset=self.softmax_offset)
        dq_scale = (1.0 / cache.kv_scale) if cache.is_fp8 else None
        if paged:
            return paged_decode_attention(
                q, cache.pages_k, cache.pages_v, cache.page_table,
                cache.length, kv_scale=dq_scale, softmax_sink=sink)
        return decode_attention(
            q, cache.k, cache.v, cache.length, kv_scale=dq_scale,
            window_left=window[0] if window is not None else -1,
            softmax_sink=sink)


class TransformerLayer(nn.Module):
    """Decoder-only pre-norm layer: ``x + attn(x)``, then ``x + mlp(x)``,
    with submodules ``self_attention`` and ``mlp``. With
    ``num_moe_experts`` > 0 the MLP is a :class:`MoELayerNormMLP` and the
    forward returns (x, the router's aux loss). ``use_bias``,
    ``window_size`` and ``softmax_type`` go to the attention, as the
    reference routes them (the MoE's experts take no bias)."""

    def __init__(self, hidden_size: int, mlp_hidden_size: int,
                 num_attention_heads: int, *, head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6, mlp_activations="swiglu",
                 use_bias: bool = False,
                 window_size: Optional[Tuple[int, int]] = None,
                 softmax_type: Optional[SoftmaxType] = None,
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192, num_moe_experts: int = 0,
                 moe_topk: int = 2, moe_score_function: str = "softmax",
                 moe_aux_loss_coeff: float = 1e-2,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            hidden_size, num_attention_heads, head_dim=head_dim,
            num_gqa_groups=num_gqa_groups,
            layernorm_epsilon=layernorm_epsilon, use_bias=use_bias,
            window_size=window_size, softmax_type=softmax_type,
            rotary_pos_emb_base=rotary_pos_emb_base,
            max_seq_len=max_seq_len, dtype=dtype, device=device,
            generator=generator)
        self.is_moe = num_moe_experts > 0
        if self.is_moe:
            self.mlp = MoELayerNormMLP(
                hidden_size, mlp_hidden_size, num_experts=num_moe_experts,
                topk=moe_topk, epsilon=layernorm_epsilon,
                activations=mlp_activations,
                score_function=moe_score_function,
                aux_loss_coeff=moe_aux_loss_coeff, dtype=dtype,
                device=device, generator=generator)
        else:
            if use_bias:
                raise NotImplementedError(
                    "the dense MLP's biases are not ported yet")
            self.mlp = LayerNormMLP(
                hidden_size, mlp_hidden_size, epsilon=layernorm_epsilon,
                activations=mlp_activations, dtype=dtype, device=device,
                generator=generator)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None):
        """``positions`` (B, S): the tokens' RoPE positions, as the
        attention takes them."""
        x = x + self.self_attention(x, sequence_descriptor, positions,
                                    kv_cache=kv_cache)
        if self.is_moe:
            out, aux_loss = self.mlp(x)
            return x + out, aux_loss
        return x + self.mlp(x)
