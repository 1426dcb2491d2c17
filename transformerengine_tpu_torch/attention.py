"""Attention (counterpart of transformerengine_tpu/attention.py): the mask
taxonomy, per-sequence lengths, backend selection and ``fused_attn`` over
two backends:

* ``FLASH``: ``ops/flash_attention.py`` (the flash kernels on the card);
* ``UNFUSED``: plain PyTorch with materialized scores, differentiated by
  autograd; the yardstick of the tests.

Both backends take a static sliding window and the softmax sink types;
the flash backend also takes FP8 Q/K/V quantizers (``fp8_dpa``).
Segment ids (packed batches), biases and dropout are not ported yet and
raise.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence, Tuple

import torch


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
    """Valid lengths of a right-padded BSHD batch: ``q_seqlens`` and
    ``kv_seqlens``, each (B,) int."""

    q_seqlens: Optional[torch.Tensor] = None
    kv_seqlens: Optional[torch.Tensor] = None

    @classmethod
    def from_seqlens(cls, q_seqlens, kv_seqlens=None) -> "SequenceDescriptor":
        return cls(q_seqlens=q_seqlens,
                   kv_seqlens=kv_seqlens if kv_seqlens is not None
                   else q_seqlens)


class AttnBackend(enum.Enum):
    AUTO = "auto"
    FLASH = "flash"
    UNFUSED = "unfused"


def get_attention_backend(*, attn_mask_type: AttnMaskType =
                          AttnMaskType.NO_MASK, head_dim: int = 128,
                          has_explicit_mask: bool = False) -> AttnBackend:
    """FLASH for what the flash kernels take, else UNFUSED: an explicit
    mask, or a head dim that is not a multiple of 16 up to 256 (the
    reference's Pallas kernel takes multiples of 8; the port's CUDA
    kernels multiples of 16). ``TE_TPU_ATTN_BACKEND={flash,unfused}`` in
    the environment overrides the choice, as in the reference."""
    del attn_mask_type      # every ported mask type runs in the kernels
    env = os.environ.get("TE_TPU_ATTN_BACKEND", "").lower()
    if env == "unfused":
        return AttnBackend.UNFUSED
    if env == "flash":
        return AttnBackend.FLASH
    if has_explicit_mask or head_dim % 16 or head_dim > 256:
        return AttnBackend.UNFUSED
    return AttnBackend.FLASH


def make_attention_mask(seq_desc: Optional[SequenceDescriptor],
                        attn_mask_type: AttnMaskType, q_len: int, kv_len: int,
                        batch: int,
                        window_size: Optional[Tuple[int, int]] = None,
                        device=None) -> torch.Tensor:
    """Boolean mask (B, 1, Sq, Skv), True where a query may attend.
    ``window_size`` (left, right) keeps the keys j with ``i - left <= j <=
    i + right`` for query i, each side where it is >= 0; as in the
    reference, the window takes no bottom-right offset here (the flash
    kernels shift it with the causal diagonal)."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((batch, 1, q_len, kv_len), dtype=torch.bool,
                      device=device)
    if seq_desc is not None and seq_desc.q_seqlens is not None:
        qlens = seq_desc.q_seqlens.to(device).reshape(-1, 1, 1)
        klens = (seq_desc.kv_seqlens if seq_desc.kv_seqlens is not None
                 else seq_desc.q_seqlens).to(device).reshape(-1, 1, 1)
        mask = mask & ((rows[None] < qlens) & (cols[None] < klens))[:, None]
    if attn_mask_type.is_causal:
        offset = kv_len - q_len if attn_mask_type.is_bottom_right else 0
        mask = mask & (rows + offset >= cols)
    if window_size is not None and tuple(window_size) != (-1, -1):
        left, right = window_size
        diff = rows - cols
        if left >= 0:
            mask = mask & (diff <= left)
        if right >= 0:
            mask = mask & (diff >= -right)
    return mask


def _unfused_attn(q, k, v, mask, *, scaling_factor: float,
                  softmax_type: SoftmaxType = SoftmaxType.VANILLA,
                  softmax_offset: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Softmax attention with the scores in f32: masked logits at -1e30,
    and rows with no visible key set to 0. A sink type appends one logit
    column (0, or the per-head ``softmax_offset``) that takes its share of
    the softmax and is dropped after it."""
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scaling_factor
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
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def fused_attn(qkv: Sequence[torch.Tensor],
               sequence_descriptor: Optional[SequenceDescriptor] = None, *,
               attn_mask_type: AttnMaskType = AttnMaskType.NO_MASK,
               scaling_factor: Optional[float] = None,
               window_size: Optional[Tuple[int, int]] = None,
               mask: Optional[torch.Tensor] = None,
               softmax_type: SoftmaxType = SoftmaxType.VANILLA,
               softmax_offset: Optional[torch.Tensor] = None,
               qkv_quantizers=None,
               backend: AttnBackend = AttnBackend.AUTO) -> torch.Tensor:
    """Scaled dot-product attention over BSHD (q, k, v); returns (B, Sq,
    Hq, D). ``mask`` (bool, broadcastable to (B, H, Sq, Skv), True =
    attend) is an explicit mask, which only the unfused backend takes.
    ``window_size`` (left, right) is a static sliding window;
    ``softmax_type`` a sink type, LEARNABLE with the (Hq,) logits
    ``softmax_offset``. ``qkv_quantizers`` (per-tensor quantizers of q, k
    and v) run the flash backend's FP8 branch; the unfused backend
    ignores them, as the reference's does."""
    q, k, v = qkv
    if scaling_factor is None:
        scaling_factor = 1.0 / (q.shape[-1] ** 0.5)
    if attn_mask_type.is_padding and sequence_descriptor is None and \
            mask is None:
        # Nothing marks any token invalid: drop the padding component.
        attn_mask_type = (AttnMaskType.CAUSAL if attn_mask_type.is_causal
                          else AttnMaskType.NO_MASK)
    chosen = backend
    if chosen is AttnBackend.AUTO:
        chosen = get_attention_backend(attn_mask_type=attn_mask_type,
                                       head_dim=q.shape[-1],
                                       has_explicit_mask=mask is not None)
    if chosen is AttnBackend.FLASH:
        if mask is not None:
            raise ValueError("the flash backend takes no explicit mask")
        from .ops.flash_attention import flash_attention
        return flash_attention(
            q, k, v, sequence_descriptor, attn_mask_type=attn_mask_type,
            scaling_factor=scaling_factor, window_size=window_size,
            softmax_type=(softmax_type
                          if softmax_type is not SoftmaxType.VANILLA
                          else None),
            softmax_offset=softmax_offset,
            qkv_quantizers=(tuple(qkv_quantizers)
                            if qkv_quantizers is not None else None))
    full_mask = mask
    if full_mask is None and (attn_mask_type is not AttnMaskType.NO_MASK
                              or sequence_descriptor is not None
                              or window_size is not None):
        full_mask = make_attention_mask(
            sequence_descriptor, attn_mask_type, q.shape[1], k.shape[1],
            q.shape[0], window_size, device=q.device)
    return _unfused_attn(q, k, v, full_mask, scaling_factor=scaling_factor,
                         softmax_type=softmax_type,
                         softmax_offset=softmax_offset)
