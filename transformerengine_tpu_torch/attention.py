"""Attention (counterpart of transformerengine_tpu/attention.py): the mask
taxonomy, per-sequence lengths, backend selection and ``fused_attn`` over
two backends:

* ``FLASH``: ``ops/flash_attention.py`` (the flash kernels on the card);
* ``UNFUSED``: plain PyTorch with materialized scores, differentiated by
  autograd; the yardstick of the tests.

Both backends take a static sliding window, the softmax sink types,
segment ids (packed documents: a :class:`SequenceDescriptor` from
:meth:`SequenceDescriptor.from_segment_ids_and_pos`), a post-scale bias
and ALiBi (:class:`AttnBiasType`); the unfused backend also takes a
pre-scale bias, and materializes ALiBi as a post-scale bias. The flash
backend also takes FP8 Q/K/V quantizers (``fp8_dpa``), which it drops
under a bias or ALiBi, as the reference's ``fused_attn`` does. The QKV
layouts of the reference (packed QKV, packed KV, THD) are unpacked to
BSHD by :func:`canonicalize_qkv`; a THD batch is a BSHD one whose segment
ids describe the packing (:func:`fused_attn_thd`). Attention dropout takes
the reference's ``seed`` (its two 32-bit words): the flash kernels drop
by the reference's own hash of them, the unfused backend by a
``torch.Generator`` seeded from them (the reference's ``bernoulli`` bits
are JAX's and not copied). Context parallelism (:class:`CPStrategy`,
``context_parallel_group``, the load-balancing reorders) runs the
flash kernels on each rank's shard of a sequence split over a
``torch.distributed`` process group (``parallel/``).
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence, Tuple

import torch


class AttnBiasType(enum.Enum):
    """No bias, a bias added before or after the softmax scale, or ALiBi
    (slopes from the head index; the flash kernels run it in-kernel, the
    unfused backend materializes it)."""
    NO_BIAS = "no_bias"
    PRE_SCALE_BIAS = "pre_scale_bias"
    POST_SCALE_BIAS = "post_scale_bias"
    ALIBI = "alibi"


class AttnMaskType(enum.Enum):
    NO_MASK = "no_mask"
    PADDING = "padding"
    CAUSAL = "causal"
    PADDING_CAUSAL = "padding_causal"
    CAUSAL_BOTTOM_RIGHT = "causal_bottom_right"
    PADDING_CAUSAL_BOTTOM_RIGHT = "padding_causal_bottom_right"

    @property
    def is_causal(self) -> bool:
        return "causal" in self.value

    @property
    def is_padding(self) -> bool:
        return self.value.startswith("padding")

    @property
    def is_bottom_right(self) -> bool:
        return self.value.endswith("bottom_right")


class QKVLayout(enum.Enum):
    """How q, k and v arrive: one packed (B, S, 3, H, D) tensor, q with a
    packed (B, S, 2, H, D) kv, or three tensors; the THD names are the
    same packings of a packed batch (its ragged documents described by
    segment ids in the :class:`SequenceDescriptor`)."""
    BS3HD = "bs3hd"
    BSHD_BS2HD = "bshd_bs2hd"
    BSHD_BSHD_BSHD = "bshd_bshd_bshd"
    T3HD = "t3hd"
    THD_T2HD = "thd_t2hd"
    THD_THD_THD = "thd_thd_thd"

    @property
    def is_qkvpacked(self) -> bool:
        return self in (QKVLayout.BS3HD, QKVLayout.T3HD)

    @property
    def is_kvpacked(self) -> bool:
        return self in (QKVLayout.BSHD_BS2HD, QKVLayout.THD_T2HD)

    @property
    def is_thd(self) -> bool:
        return self in (QKVLayout.T3HD, QKVLayout.THD_T2HD,
                        QKVLayout.THD_THD_THD)

    def get_qkv_format(self) -> "QKVFormat":
        return QKVFormat.THD if self.is_thd else QKVFormat.BSHD


class QKVFormat(enum.Enum):
    """The memory format of a QKV layout. SBHD is named, as in the
    reference, and no layout has it: transpose to BSHD first."""
    SBHD = "sbhd"
    BSHD = "bshd"
    THD = "thd"


class SoftmaxType(enum.Enum):
    """Softmax variants: vanilla, off-by-one (a sink of logit 0) and
    learnable (a per-head sink logit)."""
    VANILLA = "vanilla"
    OFF_BY_ONE = "off_by_one"
    LEARNABLE = "learnable"


# The reference's other name for it.
AttnSoftmaxType = SoftmaxType


@dataclasses.dataclass(frozen=True)
class SequenceDescriptor:
    """Valid lengths of a right-padded BSHD batch, or the segments of a
    packed one.

    ``q_seqlens`` / ``kv_seqlens``: (B,) int lengths. ``q_segment_ids`` /
    ``kv_segment_ids``: (B, S) int ids of packed documents; 0 marks
    padding, and a query sees the keys of its own nonzero id.
    ``q_segment_pos`` / ``kv_segment_pos``: (B, S) positions within each
    document (the unfused mask's causal and window rule read them). Ids
    take precedence over lengths where both are given."""

    q_seqlens: Optional[torch.Tensor] = None
    kv_seqlens: Optional[torch.Tensor] = None
    q_segment_ids: Optional[torch.Tensor] = None
    kv_segment_ids: Optional[torch.Tensor] = None
    q_segment_pos: Optional[torch.Tensor] = None
    kv_segment_pos: Optional[torch.Tensor] = None

    @classmethod
    def from_seqlens(cls, q_seqlens, kv_seqlens=None) -> "SequenceDescriptor":
        return cls(q_seqlens=q_seqlens,
                   kv_seqlens=kv_seqlens if kv_seqlens is not None
                   else q_seqlens)

    @classmethod
    def from_segment_ids_and_pos(cls, q_segment_ids, kv_segment_ids=None,
                                 q_segment_pos=None, kv_segment_pos=None
                                 ) -> "SequenceDescriptor":
        """A packed batch's descriptor; the kv ids default to the q ids
        (self-attention). The positions stay as given."""
        return cls(q_segment_ids=q_segment_ids,
                   kv_segment_ids=(kv_segment_ids
                                   if kv_segment_ids is not None
                                   else q_segment_ids),
                   q_segment_pos=q_segment_pos, kv_segment_pos=kv_segment_pos)


class AttnBackend(enum.Enum):
    AUTO = "auto"
    FLASH = "flash"
    UNFUSED = "unfused"


class CPStrategy(enum.Enum):
    """Context-parallel strategy of :func:`fused_attn` over a process
    group: K/V gathered (ALL_GATHER), rotated around a ring (RING, or
    RING_STRIPED on the striped layout), or heads and sequence swapped by
    all-to-alls (ULYSSES_A2A)."""
    DEFAULT = 0
    ALL_GATHER = 1
    RING = 2
    ULYSSES_A2A = 3
    RING_STRIPED = 4


class ReorderStrategy(enum.Enum):
    """Load-balancing reorder of causal context parallelism: chunk i with
    chunk 2 * cp - 1 - i on each rank (DUAL_CHUNK_SWAP), or tokens (or
    stripes of them) dealt round-robin (STRIPED)."""
    DUAL_CHUNK_SWAP = 0
    STRIPED = 1


def reorder_causal_load_balancing(tensor: torch.Tensor,
                                  strategy: ReorderStrategy, cp_size: int,
                                  seq_dim: int = 1,
                                  stripe_size: Optional[int] = None
                                  ) -> torch.Tensor:
    """The global sequence reordered for balanced causal work, before it
    is split over the ranks; the inverse restores the output's order."""
    from .parallel import cp_utils
    if strategy is ReorderStrategy.DUAL_CHUNK_SWAP:
        if stripe_size is not None:
            raise ValueError("stripe_size applies to STRIPED only")
        return cp_utils.reorder_causal_dual_chunk_swap(tensor, cp_size,
                                                       seq_dim)
    return cp_utils.reorder_causal_striped(tensor, cp_size, seq_dim,
                                           stripe_size or 1)


def inverse_reorder_causal_load_balancing(tensor: torch.Tensor,
                                          strategy: ReorderStrategy,
                                          cp_size: int, seq_dim: int = 1,
                                          stripe_size: Optional[int] = None
                                          ) -> torch.Tensor:
    """Inverse of :func:`reorder_causal_load_balancing`."""
    from .parallel import cp_utils
    if strategy is ReorderStrategy.DUAL_CHUNK_SWAP:
        if stripe_size is not None:
            raise ValueError("stripe_size applies to STRIPED only")
        return cp_utils.inverse_reorder_causal_dual_chunk_swap(
            tensor, cp_size, seq_dim)
    return cp_utils.inverse_reorder_causal_striped(tensor, cp_size, seq_dim,
                                                   stripe_size or 1)


def get_attention_backend(*, attn_bias_type: AttnBiasType =
                          AttnBiasType.NO_BIAS,
                          attn_mask_type: AttnMaskType =
                          AttnMaskType.NO_MASK, head_dim: int = 128,
                          has_explicit_mask: bool = False) -> AttnBackend:
    """FLASH for what the flash kernels take, else UNFUSED: a pre-scale
    bias, an explicit mask, or a head dim that is not a multiple of 16 up
    to 256 (the reference's Pallas kernel takes multiples of 8; the
    port's CUDA kernels multiples of 16). A post-scale bias and ALiBi
    stay on the flash kernels. ``TE_TPU_ATTN_BACKEND={flash,unfused}`` in
    the environment overrides the choice, as in the reference."""
    del attn_mask_type      # every ported mask type runs in the kernels
    env = os.environ.get("TE_TPU_ATTN_BACKEND", "").lower()
    if env == "unfused":
        return AttnBackend.UNFUSED
    if env == "flash":
        return AttnBackend.FLASH
    if attn_bias_type is AttnBiasType.PRE_SCALE_BIAS:
        return AttnBackend.UNFUSED
    if has_explicit_mask or head_dim % 16 or head_dim > 256:
        return AttnBackend.UNFUSED
    return AttnBackend.FLASH


def canonicalize_qkv(qkv: Sequence[torch.Tensor], qkv_layout: QKVLayout):
    """(q, k, v), each (B, S, H, D), from any :class:`QKVLayout`."""
    if qkv_layout.is_qkvpacked:
        (packed,) = qkv
        return packed[..., 0, :, :], packed[..., 1, :, :], \
            packed[..., 2, :, :]
    if qkv_layout.is_kvpacked:
        q, kv = qkv
        return q, kv[..., 0, :, :], kv[..., 1, :, :]
    q, k, v = qkv
    return q, k, v


def make_attention_mask(seq_desc: Optional[SequenceDescriptor],
                        attn_mask_type: AttnMaskType, q_len: int, kv_len: int,
                        batch: int,
                        window_size: Optional[Tuple[int, int]] = None,
                        device=None) -> torch.Tensor:
    """Boolean mask (B, 1, Sq, Skv), True where a query may attend.

    Segment ids keep the pairs of one nonzero id; else lengths keep the
    valid rows and keys. The causal rule and ``window_size`` (left,
    right: keys j with ``i - left <= j <= i + right``, each side where it
    is >= 0) compare the descriptor's segment positions where it gives
    them, else the indices, and the bottom-right offset applies only
    without positions; as in the reference, the window takes no offset
    here (the flash kernels shift it with the causal diagonal, and
    compare indices)."""
    rows = torch.arange(q_len, device=device)
    cols = torch.arange(kv_len, device=device)
    mask = torch.ones((batch, 1, q_len, kv_len), dtype=torch.bool,
                      device=device)
    q_pos = kv_pos = None
    if seq_desc is not None and seq_desc.q_segment_ids is not None:
        qs = seq_desc.q_segment_ids.to(device)[:, :, None]
        ks = seq_desc.kv_segment_ids.to(device)[:, None, :]
        mask = mask & ((qs == ks) & (qs != 0))[:, None]
        q_pos, kv_pos = seq_desc.q_segment_pos, seq_desc.kv_segment_pos
    elif seq_desc is not None and seq_desc.q_seqlens is not None:
        qlens = seq_desc.q_seqlens.to(device).reshape(-1, 1, 1)
        klens = (seq_desc.kv_seqlens if seq_desc.kv_seqlens is not None
                 else seq_desc.q_seqlens).to(device).reshape(-1, 1, 1)
        mask = mask & ((rows[None, :, None] < qlens)
                       & (cols[None, None, :] < klens))[:, None]
    qp = (q_pos.to(device) if q_pos is not None
          else rows.expand(batch, q_len))[:, :, None]
    kp = (kv_pos.to(device) if kv_pos is not None
          else cols.expand(batch, kv_len))[:, None, :]
    if attn_mask_type.is_causal:
        offset = kv_len - q_len if (attn_mask_type.is_bottom_right
                                    and q_pos is None) else 0
        mask = mask & (qp + offset >= kp)[:, None]
    if window_size is not None and tuple(window_size) != (-1, -1):
        left, right = window_size
        diff = qp - kp
        if left >= 0:
            mask = mask & (diff <= left)[:, None]
        if right >= 0:
            mask = mask & (diff >= -right)[:, None]
    return mask


def make_swa_mask(segment_pos_q: torch.Tensor, segment_pos_kv: torch.Tensor,
                  window_size: Optional[Tuple[int, int]] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """Sliding-window mask (1 = attend, 0 = masked), (..., 1, Sq, Skv),
    from the positions of the queries (..., Sq) and keys (..., Skv): a
    query at position i sees the keys at ``[i - left, i + right]``, a
    negative side unbounded."""
    pos_q = segment_pos_q[..., :, None].to(torch.int32)
    pos_kv = segment_pos_kv[..., None, :].to(torch.int32)
    keep = torch.ones(torch.broadcast_shapes(pos_q.shape, pos_kv.shape),
                      dtype=torch.bool, device=pos_q.device)
    if window_size is not None:
        left, right = window_size
        if left >= 0:
            keep = keep & (pos_kv >= pos_q - left)
        if right >= 0:
            keep = keep & (pos_kv <= pos_q + right)
    return keep[..., None, :, :].to(dtype)


def seed_generator(seed, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the two seed words
    (a (2,) integer tensor or sequence): word 0 in the high 32 bits, word
    1 in the low ones, each modulo 2^32. It reads the words on the host."""
    from .ops.flash_attention import dropout_seed
    hi, lo = (int(w) & 0xFFFFFFFF for w in dropout_seed(seed, "cpu").tolist())
    return torch.Generator(device=device).manual_seed((hi << 32) | lo)


def _unfused_attn(q, k, v, mask, *, scaling_factor: float,
                  softmax_type: SoftmaxType = SoftmaxType.VANILLA,
                  softmax_offset: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  attn_bias_type: AttnBiasType = AttnBiasType.NO_BIAS,
                  dropout_probability: float = 0.0, seed=None
                  ) -> torch.Tensor:
    """Softmax attention with the scores in f32: a pre-scale bias added
    before the scale and a post-scale one after it, masked logits at
    -1e30, and rows with no visible key set to 0. A sink type appends one
    logit column (0, or the per-head ``softmax_offset``) that takes its
    share of the softmax and is dropped after it. With
    ``dropout_probability`` > 0 the probabilities are then kept with
    probability 1 - rate and divided by it, as the reference's
    ``bernoulli`` mask does, the mask drawn from :func:`seed_generator` of
    ``seed``."""
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    if attn_bias_type is AttnBiasType.PRE_SCALE_BIAS and bias is not None:
        logits = logits + bias.float()
    logits = logits * scaling_factor
    if attn_bias_type is AttnBiasType.POST_SCALE_BIAS and bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -1e30,
                                                      device=q.device))
    if softmax_type is not SoftmaxType.VANILLA:
        col = torch.zeros((*logits.shape[:3], 1), dtype=torch.float32,
                          device=q.device)
        if softmax_type is SoftmaxType.LEARNABLE:
            col = col + softmax_offset.float().reshape(1, -1, 1, 1)
        probs = torch.softmax(torch.cat([logits, col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.where(mask.any(dim=-1, keepdim=True), probs,
                            torch.zeros((), device=q.device))
    if dropout_probability > 0.0:
        keep_prob = 1.0 - dropout_probability
        u = torch.rand(probs.shape, generator=seed_generator(seed, q.device),
                       device=q.device)
        probs = torch.where(u < keep_prob, probs / keep_prob,
                            torch.zeros((), device=q.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def alibi_bias(num_heads: int, q_len: int, kv_len: int,
               device=None) -> torch.Tensor:
    """The unfused backend's materialized ALiBi bias (1, H, Sq, Skv) f32:
    ``-slope_h * |i - j|`` with the reference's slopes, the distance on
    the indices (no bottom-right offset, as in the reference)."""
    from .flex_attention import alibi_slopes
    slopes = alibi_slopes(num_heads, device=device)
    dist = (torch.arange(q_len, dtype=torch.float32, device=device)[:, None]
            - torch.arange(kv_len, dtype=torch.float32,
                           device=device)[None, :]).abs()
    return (-slopes[:, None, None] * dist)[None]


def fused_attn(qkv: Sequence[torch.Tensor],
               sequence_descriptor: Optional[SequenceDescriptor] = None,
               seed=None, *,
               bias: Optional[torch.Tensor] = None,
               attn_bias_type: AttnBiasType = AttnBiasType.NO_BIAS,
               attn_mask_type: AttnMaskType = AttnMaskType.NO_MASK,
               scaling_factor: Optional[float] = None,
               window_size: Optional[Tuple[int, int]] = None,
               mask: Optional[torch.Tensor] = None,
               softmax_type: SoftmaxType = SoftmaxType.VANILLA,
               softmax_offset: Optional[torch.Tensor] = None,
               qkv_quantizers=None,
               qkv_layout: QKVLayout = QKVLayout.BSHD_BSHD_BSHD,
               backend: AttnBackend = AttnBackend.AUTO,
               dropout_probability: float = 0.0,
               is_training: bool = True,
               context_parallel_strategy: CPStrategy = CPStrategy.DEFAULT,
               context_parallel_group=None) -> torch.Tensor:
    """Scaled dot-product attention over ``qkv`` in ``qkv_layout`` (three
    BSHD tensors by default); returns (B, Sq, Hq, D). A descriptor with
    segment ids masks a packed batch in either backend. ``mask`` (bool,
    broadcastable to (B, H, Sq, Skv), True = attend) is an explicit mask,
    which only the unfused backend takes.
    ``window_size`` (left, right) is a static sliding window;
    ``softmax_type`` a sink type, LEARNABLE with the (Hq,) logits
    ``softmax_offset``. ``bias`` (B or 1, Hq, Sq, Skv) is added as
    ``attn_bias_type`` says (PRE_SCALE_BIAS takes the unfused backend);
    ALIBI takes no bias. ``qkv_quantizers`` (per-tensor quantizers of q, k
    and v) run the flash backend's FP8 branch, without a bias or ALiBi;
    the unfused backend ignores them, as the reference's does.
    ``dropout_probability`` applies when ``is_training``, and then (above
    0) needs ``seed``, the reference's two seed words ((2,) int32, or a
    sequence); the backend choice does not depend on it.

    Context parallelism: with ``context_parallel_group`` (a
    ``torch.distributed`` process group, the counterpart of the
    reference's ``context_parallel_axis``) and a strategy other than
    DEFAULT, q, k and v are this rank's shard of a sequence split over
    the group, and :func:`_cp_attention` runs the strategy."""
    q, k, v = canonicalize_qkv(qkv, qkv_layout)
    rate = float(dropout_probability) if is_training else 0.0
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout requires an explicit `seed`; a "
                         "silent default would reuse the same mask every "
                         "step")
    if scaling_factor is None:
        scaling_factor = 1.0 / (q.shape[-1] ** 0.5)
    if attn_bias_type is AttnBiasType.ALIBI and bias is not None:
        raise ValueError("ALIBI computes its own bias; bias must be None")
    if attn_mask_type.is_padding and sequence_descriptor is None and \
            mask is None:
        # Nothing marks any token invalid: drop the padding component.
        attn_mask_type = (AttnMaskType.CAUSAL if attn_mask_type.is_causal
                          else AttnMaskType.NO_MASK)
    if context_parallel_group is not None and \
            context_parallel_strategy is not CPStrategy.DEFAULT:
        if rate > 0.0 or mask is not None:
            # The reference's CP branch returns before it reads them, so
            # its layers train without attention dropout under CP.
            raise NotImplementedError(
                "attention dropout and an explicit mask under context "
                "parallelism are not ported (the reference drops them "
                "silently: ROADMAP.md, Queue 3)")
        return _cp_attention(
            q, k, v, sequence_descriptor, bias, attn_bias_type,
            attn_mask_type, scaling_factor, window_size, softmax_type,
            softmax_offset, context_parallel_strategy,
            context_parallel_group)
    chosen = backend
    if chosen is AttnBackend.AUTO:
        chosen = get_attention_backend(attn_bias_type=attn_bias_type,
                                       attn_mask_type=attn_mask_type,
                                       head_dim=q.shape[-1],
                                       has_explicit_mask=mask is not None)
    if chosen is AttnBackend.FLASH:
        if mask is not None:
            raise ValueError("the flash backend takes no explicit mask")
        if attn_bias_type is AttnBiasType.PRE_SCALE_BIAS:
            raise ValueError("the flash backend takes no pre-scale bias")
        from .flex_attention import alibi_arith_mod
        from .ops.flash_attention import flash_attention
        score_mod = (alibi_arith_mod(q.shape[2])
                     if attn_bias_type is AttnBiasType.ALIBI else None)
        # As the reference: FP8 Q/K/V only without a bias or a score mod.
        fp8_ok = qkv_quantizers is not None and bias is None and \
            score_mod is None
        return flash_attention(
            q, k, v, sequence_descriptor, attn_mask_type=attn_mask_type,
            scaling_factor=scaling_factor, window_size=window_size,
            softmax_type=(softmax_type
                          if softmax_type is not SoftmaxType.VANILLA
                          else None),
            softmax_offset=softmax_offset,
            bias=(bias if attn_bias_type is AttnBiasType.POST_SCALE_BIAS
                  else None),
            score_mod=score_mod,
            qkv_quantizers=tuple(qkv_quantizers) if fp8_ok else None,
            dropout_probability=rate,
            dropout_seed=seed if rate > 0.0 else None)
    if attn_bias_type is AttnBiasType.ALIBI:
        bias = alibi_bias(q.shape[2], q.shape[1], k.shape[1], q.device)
        attn_bias_type = AttnBiasType.POST_SCALE_BIAS
    full_mask = mask
    if full_mask is None and (attn_mask_type is not AttnMaskType.NO_MASK
                              or sequence_descriptor is not None
                              or window_size is not None):
        full_mask = make_attention_mask(
            sequence_descriptor, attn_mask_type, q.shape[1], k.shape[1],
            q.shape[0], window_size, device=q.device)
    return _unfused_attn(q, k, v, full_mask, scaling_factor=scaling_factor,
                         softmax_type=softmax_type,
                         softmax_offset=softmax_offset, bias=bias,
                         attn_bias_type=attn_bias_type,
                         dropout_probability=rate, seed=seed)


def _cp_attention(q, k, v, sequence_descriptor, bias, attn_bias_type,
                  attn_mask_type, scaling_factor, window_size, softmax_type,
                  softmax_offset, strategy: CPStrategy, group):
    """The reference's ``fused_attn`` CP branch. A sink type becomes (Hq,)
    logits (zeros for OFF_BY_ONE), which the ring merges once after its
    rotation and the others pass into their flash call. ALiBi (the
    step's or rank's offset reaches its positions) and a post-scale bias
    (this rank's rows over the whole key length, (B or 1, Hq, L,
    S_total)) take RING or ALL_GATHER only. Under an active recipe with
    ``fp8_dpa`` the ring rotates e4m3 K/V and runs the FP8 kernels, and
    ALL_GATHER and ULYSSES_A2A send e4m3 payloads."""
    from .flex_attention import alibi_arith_mod
    from .parallel.ring_attention import (all_gather_attn,
                                          ring_attn_in_group, ulysses_attn)
    from .quantize.helper import get_quantize_config
    hq = q.shape[2]
    sink = None
    if softmax_type is SoftmaxType.OFF_BY_ONE:
        sink = torch.zeros((hq,), dtype=torch.float32, device=q.device)
    elif softmax_type is SoftmaxType.LEARNABLE:
        if softmax_offset is None:
            raise ValueError("LEARNABLE softmax requires softmax_offset (Hq,)")
        sink = softmax_offset.float().reshape(hq)
    contiguous = (CPStrategy.RING, CPStrategy.ALL_GATHER)
    score_mod = None
    if attn_bias_type is AttnBiasType.ALIBI:
        if strategy not in contiguous:
            raise NotImplementedError(
                "ALiBi under CP: RING (contiguous) or ALL_GATHER only")
        score_mod = alibi_arith_mod(hq)
    if attn_bias_type is AttnBiasType.PRE_SCALE_BIAS:
        raise NotImplementedError("a pre-scale bias under CP is not ported")
    cp_bias = None
    if attn_bias_type is AttnBiasType.POST_SCALE_BIAS and bias is not None:
        if strategy not in contiguous:
            raise NotImplementedError(
                "a bias under CP: RING (contiguous) or ALL_GATHER only (the "
                "striped layout breaks the column chunks; Ulysses would need "
                "a head-sliced bias)")
        cp_bias = bias
    cfg = get_quantize_config()
    fp8 = bool(cfg.enabled and getattr(cfg.recipe, "fp8_dpa", False))
    if strategy in (CPStrategy.RING, CPStrategy.RING_STRIPED):
        return ring_attn_in_group(
            q, k, v, sequence_descriptor, group=group,
            attn_mask_type=attn_mask_type, scaling_factor=scaling_factor,
            window_size=window_size,
            striped=strategy is CPStrategy.RING_STRIPED, fp8_kv=fp8,
            softmax_sink=sink, bias=cp_bias, score_mod=score_mod)
    if strategy is CPStrategy.ALL_GATHER:
        return all_gather_attn(
            q, k, v, group, causal=attn_mask_type.is_causal,
            scaling_factor=scaling_factor, window_size=window_size,
            sequence_descriptor=sequence_descriptor, softmax_sink=sink,
            bias=cp_bias, score_mod=score_mod, fp8_dpa=fp8)
    return ulysses_attn(
        q, k, v, group, causal=attn_mask_type.is_causal,
        scaling_factor=scaling_factor, window_size=window_size,
        sequence_descriptor=sequence_descriptor, softmax_sink=sink,
        fp8_dpa=fp8)


def fused_attn_thd(qkv: Sequence[torch.Tensor],
                   sequence_descriptor: Optional[SequenceDescriptor] = None,
                   seed=None, *, qkv_layout: QKVLayout = QKVLayout.THD_THD_THD,
                   **kwargs) -> torch.Tensor:
    """:func:`fused_attn` with a THD layout: a packed batch, (B, S, ...)
    rows of documents that the descriptor's segment ids (and positions)
    describe."""
    if not qkv_layout.is_thd:
        raise ValueError(f"fused_attn_thd needs a THD layout, got "
                         f"{qkv_layout}")
    return fused_attn(qkv, sequence_descriptor, seed, qkv_layout=qkv_layout,
                      **kwargs)
