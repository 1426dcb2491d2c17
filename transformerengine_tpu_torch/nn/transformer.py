"""Transformer blocks (counterpart of transformerengine_tpu/flax/
transformer.py): self-attention with LayerNorm or RMSNorm, optional RoPE,
GQA, a post-scale bias or ALiBi and the contiguous or paged KV cache; the
T5-style trained relative-position bias (:class:`RelativePositionBiases`);
the attention core alone (:class:`DotProductAttention`); and a pre-norm
TransformerLayer (by the reference's defaults: RMSNorm,
GELU, a causal mask and no RoPE; the port's models pass their own, and
an encoder takes LayerNorm, a padding mask and the relative bias), whose
MLP is dense or, with
``num_moe_experts`` > 0, a top-k routed mixture of experts (single
device). Without a cache the forward is the training forward,
differentiable end to end. Attention takes biased projections, a static
sliding window and the softmax sink types; a learnable sink is the
attention's f32 ``softmax_offset``, which training and the caches share.
Under a recipe with ``fp8_dpa`` the cache-free attention runs on FP8
Q/K/V, and with ``fp8_mha`` too (per-tensor recipes, no biases) the
attention and the output projection run as one FP8 function; a bias or
ALiBi keeps the attention in the inputs' precision, as the reference's
gates do, and so does attention dropout in training. A packed batch (a
descriptor with segment ids) and its per-document ``positions`` run
through the same cache-free path, and so does context parallelism: a
``context_parallel_group`` (a ``torch.distributed`` process group) runs
the cache-free attention as a ring over it, each rank on its shard of
the sequence.

Dropout, as the reference's modules take it: ``attention_dropout`` (in
the flash kernels, from two seed words drawn once per call),
``hidden_dropout`` on each branch's output and ``drop_path`` (stochastic
depth, whole samples of a branch) in :class:`TransformerLayer`. They act
in a training call (``deterministic=False``; the default True is the
reference's), which then needs an explicit ``torch.Generator`` on the
activations' device: the reference draws from flax's ``dropout`` PRNG
stream, whose bits the port does not copy. Not ported yet: expert
parallelism, cross-attention, and a relative bias or ALiBi on a KV cache
(the reference computes another function there: ROADMAP.md, Queue 3)."""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..attention import (AttnBiasType, AttnMaskType, CPStrategy,
                         SequenceDescriptor, SoftmaxType, fused_attn)
from ..common.recipe import DelayedScaling, Float8CurrentScaling
from ..device import resolve_device
from ..inference.kv_cache import (KVCache, PagedKVCache, cache_append,
                                  calibrate_kv_scale, paged_append_prompt,
                                  paged_append_token)
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.rope import apply_rope, rope_frequencies
from ..quantize.helper import get_quantize_config
from ..quantize.quantizer import CurrentScaleQuantizer, QuantizeLayout
from .module import (DenseGeneral, LayerNormDenseGeneral, LayerNormMLP,
                     check_generator, dropout)
from .moe import MoELayerNormMLP


def _fp8_qkv_quantizers():
    """The three current-scaling e4m3 quantizers of FP8 Q/K/V (the
    reference's fp8_dpa gate makes them afresh at every call)."""
    return tuple(CurrentScaleQuantizer(torch.float8_e4m3fn,
                                       QuantizeLayout.ROWWISE)
                 for _ in range(3))


def _fp8_dpa_active(recipe, bias, dropout: float, cp_group=None) -> bool:
    """The reference's fp8_dpa gate: any active recipe with the flag, no
    bias, no dropout in this call and no context parallelism (whose
    ``fused_attn`` branch reads the recipe itself and runs the FP8 ring).
    ALiBi passes it, and ``fused_attn`` then drops the quantizers, as the
    reference's does."""
    return (recipe is not None and getattr(recipe, "fp8_dpa", False)
            and bias is None and dropout == 0.0 and cp_group is None)


def _fp8_mha_active(recipe, use_bias: bool, bias, score_mod_like: bool,
                    dropout: float, cp_group=None) -> bool:
    """The reference's fp8_mha gate (``_fp8_mha_active``): a per-tensor
    recipe with both flags, no biased projections, no attention bias, no
    ALiBi, no dropout in this call and no context parallelism."""
    return (isinstance(recipe, (DelayedScaling, Float8CurrentScaling))
            and recipe.fp8_mha and recipe.fp8_dpa and not use_bias
            and bias is None and not score_mod_like and dropout == 0.0
            and cp_group is None)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """Two 32-bit seed words, (2,) int32 on the generator's device, drawn
    from it (on the card for a card generator: no host read)."""
    w = torch.randint(0, 2 ** 32, (2,), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _core_attention(q, k, v, sequence_descriptor, bias, *, mask_type,
                    bias_type, rate: float, window, scale, softmax_type,
                    softmax_offset, generator, cp_group=None) -> torch.Tensor:
    """The reference's DotProductAttention body: the seed words drawn
    from ``generator`` when ``rate`` (this call's attention dropout) is
    above 0, FP8 Q/K/V under its gate, and ``fused_attn``, through the
    ring over ``cp_group`` where one is set; (B, Sq, Hq, D)."""
    cfg = get_quantize_config()
    recipe = cfg.recipe if cfg.enabled else None
    seed = draw_seed(generator).to(q.device) if rate > 0.0 else None
    return fused_attn(
        (q, k, v), sequence_descriptor, seed, bias=bias,
        attn_bias_type=bias_type, attn_mask_type=mask_type,
        scaling_factor=scale, window_size=window, softmax_type=softmax_type,
        softmax_offset=softmax_offset, dropout_probability=rate,
        is_training=rate > 0.0,
        qkv_quantizers=(_fp8_qkv_quantizers()
                        if _fp8_dpa_active(recipe, bias, rate, cp_group)
                        else None),
        context_parallel_strategy=(CPStrategy.RING if cp_group is not None
                                   else CPStrategy.DEFAULT),
        context_parallel_group=cp_group)


def _drop_path(branch: torch.Tensor, rate: float,
               generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth (the reference's ``_drop_path``): the whole
    branch of each sample kept with probability 1 - ``rate`` and divided
    by it, in the branch's dtype."""
    keep = 1.0 - rate
    shape = (branch.shape[0],) + (1,) * (branch.dim() - 1)
    u = torch.rand(shape, generator=generator, device=branch.device)
    return torch.where(u < keep, branch / keep,
                       torch.zeros((), dtype=branch.dtype,
                                   device=branch.device))


class DotProductAttention(nn.Module):
    """The attention core (the reference's ``DotProductAttention``): BSHD
    query, key and value to (B, Sq, Hq * D) through ``fused_attn``, under
    ``attn_mask_type`` as given (a padding type without a descriptor
    drops its padding, as ``fused_attn`` does), ``attn_bias_type``,
    ``window_size``, ``scale_factor`` (1 / sqrt(D) by default) and
    ``softmax_type``; LEARNABLE owns an f32 ``softmax_offset`` (Hq,),
    zeros at init, unless the call passes one. ``attention_dropout``
    acts in a training call, from two seed words drawn from the call's
    ``generator``; the ``fp8_dpa`` gate closes under a bias, under
    dropout and under context parallelism. ``context_parallel_group``, a
    ``torch.distributed`` process group (the reference's
    ``context_parallel_axis``), runs the ring over it: the inputs are
    this rank's shard of the sequence."""

    def __init__(self, head_dim: int, num_attention_heads: int, *,
                 num_gqa_groups: Optional[int] = None,
                 attn_mask_type: AttnMaskType = AttnMaskType.CAUSAL,
                 attn_bias_type: AttnBiasType = AttnBiasType.NO_BIAS,
                 attention_dropout: float = 0.0,
                 window_size: Optional[Tuple[int, int]] = None,
                 scale_factor: Optional[float] = None,
                 softmax_type: Optional[SoftmaxType] = None, device=None,
                 context_parallel_group=None):
        super().__init__()
        self.context_parallel_group = context_parallel_group
        self.head_dim = head_dim
        self.num_heads = num_attention_heads
        self.num_kv_heads = num_gqa_groups or num_attention_heads
        self.attn_mask_type = attn_mask_type
        self.attn_bias_type = attn_bias_type
        self.attention_dropout = attention_dropout
        self.window_size = (tuple(window_size) if window_size is not None
                            else None)
        self.scale_factor = scale_factor
        self.softmax_type = softmax_type or SoftmaxType.VANILLA
        self.softmax_offset = (
            nn.Parameter(torch.zeros(num_attention_heads, dtype=torch.float32,
                                     device=device))
            if self.softmax_type is SoftmaxType.LEARNABLE else None)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                bias: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                softmax_offset: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        rate = 0.0 if deterministic else self.attention_dropout
        check_generator((rate,), generator)
        out = _core_attention(
            query, key, value, sequence_descriptor, bias,
            mask_type=self.attn_mask_type, bias_type=self.attn_bias_type,
            rate=rate, window=self.window_size, scale=self.scale_factor,
            softmax_type=self.softmax_type,
            softmax_offset=(softmax_offset if softmax_offset is not None
                            else self.softmax_offset),
            generator=generator, cp_group=self.context_parallel_group)
        b, s, h, d = out.shape
        return out.reshape(b, s, h * d)


def _mask_type(mask: AttnMaskType, sequence_descriptor) -> AttnMaskType:
    """The mask type a call runs: with a descriptor its padding variant
    (the reference's models pick PADDING_CAUSAL then), without one the
    type without its padding component (nothing marks a token invalid)."""
    causal, br = mask.is_causal, mask.is_bottom_right
    if sequence_descriptor is None:
        return (AttnMaskType.CAUSAL_BOTTOM_RIGHT if br else
                AttnMaskType.CAUSAL if causal else AttnMaskType.NO_MASK)
    return (AttnMaskType.PADDING_CAUSAL_BOTTOM_RIGHT if br else
            AttnMaskType.PADDING_CAUSAL if causal else AttnMaskType.PADDING)


class _RelativeBias(torch.autograd.Function):
    """``bias[h, q, k] = embedding[bucket(k - q), h]`` (H, Sq, Sk): a
    gather. The backward first sums the gradient along each diagonal
    ``k - q`` (the gradient copied into rows of length Sq + Sk - 1, each
    shifted by its q, then summed over q), then adds the Sq + Sk - 1
    diagonal sums into their buckets: the gather's own backward (one
    atomic add per element onto 32 x H places) took 0.82 s a step at
    S 2048 on an H100 80GB HBM3 at 700 W."""

    @staticmethod
    def forward(ctx, embedding, diag_buckets, sq: int, sk: int):
        ctx.save_for_backward(diag_buckets)
        ctx.shape = (embedding.shape, sq, sk)
        q = torch.arange(sq, device=embedding.device)[:, None]
        k = torch.arange(sk, device=embedding.device)[None, :]
        return embedding.t()[:, diag_buckets[k - q + (sq - 1)]]

    @staticmethod
    def backward(ctx, g):
        (diag_buckets,) = ctx.saved_tensors
        emb_shape, sq, sk = ctx.shape
        h, width = g.shape[0], sq + sk - 1
        rows = torch.zeros((h, sq * width), dtype=torch.float32,
                           device=g.device)
        # Element (q, k) lands in row q at column k - q + Sq - 1.
        rows.as_strided((h, sq, sk), (sq * width, width - 1, 1),
                        sq - 1).copy_(g)
        diag = rows.view(h, sq, width).sum(dim=1)           # (H, width)
        demb = torch.zeros(emb_shape, dtype=torch.float32, device=g.device)
        demb.index_add_(0, diag_buckets, diag.t())
        return demb, None, None, None


class RelativePositionBiases(nn.Module):
    """T5-style trained relative-position bias (the reference's
    ``RelativePositionBiases``): each query-key distance falls into one of
    ``num_buckets`` buckets (exact for near pairs, log-spaced out to
    ``max_distance``), each with a learned value per head in the f32
    ``rel_embedding`` (num_buckets, H). ``forward`` returns the (1, H,
    q_len, k_len) bias in ``dtype``, an exact gather ``embedding[bucket]``
    where the reference sums a one-hot product (equal values: one nonzero
    term a sum; its gradient sums in another order)."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 128,
                 num_attention_heads: int = 8, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.dtype = dtype
        # The reference's variance_scaling(1.0, "fan_avg", "uniform").
        limit = math.sqrt(3.0 / ((num_buckets + num_attention_heads) / 2))
        w = torch.rand((num_buckets, num_attention_heads), generator=generator,
                       device=device, dtype=torch.float32)
        self.rel_embedding = nn.Parameter((w * 2.0 - 1.0) * limit)

    @staticmethod
    def bucket(relative_position: torch.Tensor, bidirectional: bool,
               num_buckets: int, max_distance: int) -> torch.Tensor:
        """Distance (key position - query position, int) -> bucket index,
        in the reference's f32 operations."""
        rp = relative_position
        bucket = torch.zeros_like(rp)
        if bidirectional:
            num_buckets //= 2
            bucket = bucket + torch.where(rp > 0, num_buckets, 0).to(rp.dtype)
            rp = rp.abs()
        else:
            rp = -torch.clamp_max(rp, 0)       # only attend to the past
        max_exact = num_buckets // 2
        is_small = rp < max_exact
        log_ratio = torch.log(rp.to(torch.float32) / max_exact
                              + torch.tensor(1e-6, dtype=torch.float32))
        log_denom = torch.log(torch.tensor(max_distance / max_exact,
                                           dtype=torch.float32))
        large = max_exact + (log_ratio / log_denom.to(rp.device)
                             * (num_buckets - max_exact)).to(rp.dtype)
        large = torch.clamp_max(large, num_buckets - 1)
        return bucket + torch.where(is_small, rp, large)

    def forward(self, q_seqlen: int, k_seqlen: int,
                bidirectional: bool = True) -> torch.Tensor:
        dev = self.rel_embedding.device
        # The bucket of each relative position k - q, -(Sq - 1)..Sk - 1.
        rel = torch.arange(-(q_seqlen - 1), k_seqlen, dtype=torch.int32,
                           device=dev)
        buckets = self.bucket(rel, bidirectional, self.num_buckets,
                              self.max_distance).long()
        bias = _RelativeBias.apply(self.rel_embedding, buckets, q_seqlen,
                                   k_seqlen)                    # (H, q, k)
        return bias[None].to(self.dtype)


class MultiHeadAttention(nn.Module):
    """norm -> fused QKV projection -> RoPE (with
    ``enable_rotary_pos_emb``) -> attention -> output projection.
    Submodules ``qkv`` and ``out`` carry the reference's parameter names
    (each with a ``bias`` under ``use_bias``; ``qkv`` an ``ln_bias`` under
    ``norm_type="layernorm"``). ``attn_mask_type`` is the mask without a
    descriptor; a descriptor adds its padding (as the reference's models
    choose PADDING_CAUSAL then). ``attn_bias_type`` POST_SCALE_BIAS takes
    the ``bias`` of ``forward``, ALIBI runs ALiBi. ``window_size`` (left,
    right) bands the attention; ``softmax_type`` LEARNABLE owns an f32
    ``softmax_offset`` (Hq,), zeros at init. ``attention_dropout`` acts
    in a training call (``deterministic=False``), with the call's
    ``generator``; it closes the ``fp8_dpa`` and ``fp8_mha`` gates there.
    ``context_parallel_group`` (a process group) runs the cache-free
    attention as a ring over it, on this rank's shard of the sequence
    (its RoPE positions, the shard's global ones, come through
    ``positions``); it closes both FP8 gates. Defaults are the
    reference's."""

    def __init__(self, hidden_size: int, num_attention_heads: int, *,
                 head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6,
                 norm_type: str = "layernorm",
                 zero_centered_gamma: bool = False,
                 use_bias: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.CAUSAL,
                 attn_bias_type: AttnBiasType = AttnBiasType.NO_BIAS,
                 attention_dropout: float = 0.0,
                 window_size: Optional[Tuple[int, int]] = None,
                 softmax_type: Optional[SoftmaxType] = None,
                 enable_rotary_pos_emb: bool = False,
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None,
                 context_parallel_group=None):
        super().__init__()
        self.context_parallel_group = context_parallel_group
        if attn_bias_type is AttnBiasType.PRE_SCALE_BIAS:
            raise NotImplementedError(
                "a pre-scale bias in MultiHeadAttention is not ported; "
                "fused_attn takes one")
        self.head_dim = head_dim or hidden_size // num_attention_heads
        self.num_heads = num_attention_heads
        self.num_kv_heads = num_gqa_groups or num_attention_heads
        self.attn_mask_type = attn_mask_type
        self.attn_bias_type = attn_bias_type
        self.attention_dropout = attention_dropout
        self.window_size = (tuple(window_size) if window_size is not None
                            else None)
        self.softmax_type = softmax_type or SoftmaxType.VANILLA
        self.enable_rotary_pos_emb = enable_rotary_pos_emb
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        self.softmax_offset = (
            nn.Parameter(torch.zeros(hq, dtype=torch.float32, device=device))
            if self.softmax_type is SoftmaxType.LEARNABLE else None)
        self.qkv = LayerNormDenseGeneral(
            hidden_size, (hq + 2 * hkv) * d, epsilon=layernorm_epsilon,
            norm_type=norm_type, zero_centered_gamma=zero_centered_gamma,
            use_bias=use_bias, dtype=dtype, device=device,
            generator=generator)
        self.out = DenseGeneral(hq * d, hidden_size, use_bias=use_bias,
                                dtype=dtype, device=device,
                                generator=generator)
        if enable_rotary_pos_emb:
            self.register_buffer(
                "freqs", rope_frequencies(d, max_seq_len,
                                          base=rotary_pos_emb_base,
                                          device=device),
                persistent=False)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                bias: Optional[torch.Tensor] = None,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Attention under ``attn_mask_type``, with the padding of
        ``sequence_descriptor``'s lengths or the segment ids of a packed
        batch; differentiable without a cache. ``bias`` (B or 1, Hq, S,
        S): the post-scale bias of POST_SCALE_BIAS. ``positions`` (B, S):
        each token's RoPE position (a packed batch's positions within its
        document); by default 0..S-1, or with a cache continuing from its
        lengths. ``kv_cache``: the layer's cache. A call with S > 1
        tokens is a prefill into an empty cache; S == 1 is a decode step;
        the cached path reads only the descriptor's lengths, as the
        reference's does, and takes no bias, ALiBi or dropout.
        ``deterministic=False`` makes a training call: attention dropout
        then draws its seed words from ``generator``."""
        b, s = x.shape[:2]
        d, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        alibi = self.attn_bias_type is AttnBiasType.ALIBI
        rate = 0.0 if deterministic or kv_cache is not None \
            else self.attention_dropout
        check_generator((rate,), generator)
        if bias is not None and \
                self.attn_bias_type is not AttnBiasType.POST_SCALE_BIAS:
            raise ValueError(f"a bias needs attn_bias_type POST_SCALE_BIAS, "
                             f"got {self.attn_bias_type}")
        if kv_cache is not None and (bias is not None or alibi):
            raise NotImplementedError(
                "a bias or ALiBi on a KV cache is not ported: the "
                "reference's cached path drops it (ROADMAP.md, Queue 3)")
        qkv = self.qkv(x)
        q = qkv[..., :hq * d].reshape(b, s, hq, d)
        k = qkv[..., hq * d:(hq + hkv) * d].reshape(b, s, hkv, d)
        v = qkv[..., (hq + hkv) * d:].reshape(b, s, hkv, d)
        if self.enable_rotary_pos_emb:
            if positions is None and kv_cache is not None:
                # Clamped into the table, as the reference's gather
                # clamps: an idle continuous-batching slot's length keeps
                # growing.
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
            mask = _mask_type(self.attn_mask_type, sequence_descriptor)
            cp_group = self.context_parallel_group
            if _fp8_mha_active(recipe, self.out.bias is not None, bias,
                               alibi, rate, cp_group):
                return self._fp8_mha(q, k, v, sequence_descriptor, mask)
            # Training and cache-free forward: the reference's
            # DotProductAttention through fused_attn (flash backend).
            ctx = _core_attention(
                q, k, v, sequence_descriptor, bias, mask_type=mask,
                bias_type=self.attn_bias_type, rate=rate,
                window=self.window_size, scale=None,
                softmax_type=self.softmax_type,
                softmax_offset=self.softmax_offset, generator=generator,
                cp_group=cp_group)
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
    """Pre-norm layer: ``x + attn(x)``, then ``x + mlp(x)``, with
    submodules ``self_attention``, ``mlp`` and, with
    ``enable_relative_embedding``, ``relpos_bias`` (a
    :class:`RelativePositionBiases` whose bias enters the attention as a
    post-scale bias; bidirectional unless ``self_attn_mask_type`` is
    causal). With ``num_moe_experts`` > 0 the MLP is a
    :class:`MoELayerNormMLP` (RMSNorm only) and the forward returns (x,
    the router's aux loss). ``use_bias``, ``window_size`` and
    ``softmax_type`` go to the attention, as the reference routes them
    (the MoE's experts take no bias). ``attention_dropout``,
    ``hidden_dropout`` (on each branch's output) and ``drop_path`` (each
    branch dropped per sample) act in a training call
    (``deterministic=False``) and draw from its ``generator``, in the
    reference's order: the attention's seed words, the attention branch's
    hidden dropout and drop path, then the MLP branch's.
    ``context_parallel_group`` goes to the attention (the ring over it).
    Defaults are the reference's: RMSNorm, ``("gelu",)``, a causal mask,
    no RoPE, no dropout."""

    def __init__(self, hidden_size: int, mlp_hidden_size: int,
                 num_attention_heads: int, *, head_dim: Optional[int] = None,
                 num_gqa_groups: Optional[int] = None,
                 layernorm_epsilon: float = 1e-6, norm_type: str = "rmsnorm",
                 zero_centered_gamma: bool = False,
                 hidden_dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 drop_path: float = 0.0,
                 mlp_activations: Union[str, Sequence[str]] = ("gelu",),
                 use_bias: bool = False,
                 self_attn_mask_type: AttnMaskType = AttnMaskType.CAUSAL,
                 window_size: Optional[Tuple[int, int]] = None,
                 softmax_type: Optional[SoftmaxType] = None,
                 enable_rotary_pos_emb: bool = False,
                 rotary_pos_emb_base: float = 10000.0,
                 max_seq_len: int = 8192, num_moe_experts: int = 0,
                 moe_topk: int = 2, moe_score_function: str = "softmax",
                 moe_aux_loss_coeff: float = 1e-2,
                 enable_relative_embedding: bool = False,
                 relative_embedding_buckets: int = 32,
                 relative_embedding_max_distance: int = 128,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None,
                 context_parallel_group=None):
        super().__init__()
        self.self_attn_mask_type = self_attn_mask_type
        self.hidden_dropout = hidden_dropout
        self.drop_path = drop_path
        self.relpos_bias = (
            RelativePositionBiases(relative_embedding_buckets,
                                   relative_embedding_max_distance,
                                   num_attention_heads, device=device,
                                   generator=generator)
            if enable_relative_embedding else None)
        self.self_attention = MultiHeadAttention(
            hidden_size, num_attention_heads, head_dim=head_dim,
            num_gqa_groups=num_gqa_groups,
            layernorm_epsilon=layernorm_epsilon, norm_type=norm_type,
            zero_centered_gamma=zero_centered_gamma, use_bias=use_bias,
            attn_mask_type=self_attn_mask_type,
            attn_bias_type=(AttnBiasType.POST_SCALE_BIAS
                            if enable_relative_embedding
                            else AttnBiasType.NO_BIAS),
            attention_dropout=attention_dropout, window_size=window_size,
            softmax_type=softmax_type,
            enable_rotary_pos_emb=enable_rotary_pos_emb,
            rotary_pos_emb_base=rotary_pos_emb_base,
            max_seq_len=max_seq_len, dtype=dtype, device=device,
            generator=generator, context_parallel_group=context_parallel_group)
        self.is_moe = num_moe_experts > 0
        if self.is_moe:
            if norm_type != "rmsnorm" or zero_centered_gamma:
                raise NotImplementedError(
                    "the MoE MLP's norm is RMSNorm without a zero-centred "
                    "gamma in this port")
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
                norm_type=norm_type, zero_centered_gamma=zero_centered_gamma,
                activations=mlp_activations, dtype=dtype, device=device,
                generator=generator)

    def forward(self, x: torch.Tensor,
                sequence_descriptor: Optional[SequenceDescriptor] = None,
                positions: Optional[torch.Tensor] = None, *,
                kv_cache: Optional[Union[KVCache, PagedKVCache]] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``positions`` (B, S): the tokens' RoPE positions, as the
        attention takes them. A relative-bias layer refuses a cache: the
        reference builds no bias there, so its cached layer computes
        another function than the one it trained (ROADMAP.md, Queue
        3). ``deterministic=False`` makes a training call, whose dropout
        draws from ``generator`` (needed when any rate is above 0)."""
        train = not deterministic
        hidden = self.hidden_dropout if train else 0.0
        path = self.drop_path if train else 0.0
        check_generator((hidden, path, self.self_attention.attention_dropout
                         if train else 0.0), generator)
        bias = None
        if self.relpos_bias is not None:
            if kv_cache is not None:
                raise NotImplementedError(
                    "a relative-position bias on a KV cache is not ported: "
                    "the reference's cached path drops it (ROADMAP.md, "
                    "Queue 3)")
            s = x.shape[1]
            bias = self.relpos_bias(
                s, s, bidirectional=not self.self_attn_mask_type.is_causal)
        attn = self.self_attention(x, sequence_descriptor, positions,
                                   bias=bias, kv_cache=kv_cache,
                                   deterministic=deterministic,
                                   generator=generator)
        x = x + self._branch(attn, hidden, path, generator)
        if self.is_moe:
            out, aux_loss = self.mlp(x)
            return x + self._branch(out, hidden, path, generator), aux_loss
        return x + self._branch(self.mlp(x), hidden, path, generator)

    @staticmethod
    def _branch(out, hidden: float, path: float, generator):
        """A branch's output after hidden dropout and drop path."""
        if hidden > 0.0:
            out = dropout(out, hidden, generator)
        if path > 0.0:
            out = _drop_path(out, path, generator)
        return out


# Parameters kept in f32 whatever the model's dtype: norm scales and
# LayerNorm biases, a MoE layer's router kernel, an attention's learnable
# sink and a relative-position bias's embedding.
F32_PARAMS = ("scale", "ln_bias", "router_kernel", "softmax_offset",
              "rel_embedding")


def flax_state(tree: Mapping, dtype: Optional[torch.dtype], device,
               leaf=None) -> dict:
    """A reference params tree (nested dicts of numpy arrays, boxes
    removed) as ``state_dict`` entries on ``device``: ``layer_{i}``
    becomes ``layers.{i}`` and nested names join with dots. Each array
    becomes a tensor of ``dtype`` (f32 for ``F32_PARAMS``; ``dtype`` None
    keeps every leaf f32), or what ``leaf(name, array)`` makes of it."""
    state = {}

    def walk(sub_tree, prefix):
        for name, sub in sub_tree.items():
            key = f"layers.{name[len('layer_'):]}" if name.startswith(
                "layer_") else name
            key = f"{prefix}{key}"
            if isinstance(sub, Mapping):
                walk(sub, key + ".")
            elif leaf is not None:
                state[key] = leaf(name, sub)
            else:
                t = torch.float32 if dtype is None or name in F32_PARAMS \
                    else dtype
                arr = np.array(sub, dtype=np.float32)
                state[key] = torch.from_numpy(arr).to(device=device, dtype=t)

    walk(tree, "")
    return state


def load_flax_params(params_np, device="cuda",
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Maps the reference ``TransformerLayer``'s ``variables["params"]``
    (nested dicts of numpy arrays) to the port's :class:`TransformerLayer`
    ``state_dict``: kernels in ``dtype``; norm scales, LayerNorm biases
    (``ln_bias``), ``relpos_bias.rel_embedding``, a sink and a router
    kernel in f32. A list of such trees (a stack of layers) maps to the
    keys of an ``nn.ModuleList`` of layers, ``{i}.``-prefixed."""
    dev = resolve_device(device)
    if isinstance(params_np, (list, tuple)):
        return {f"{i}.{k}": v for i, tree in enumerate(params_np)
                for k, v in flax_state(tree, dtype, dev).items()}
    return flax_state(params_np, dtype, dev)
