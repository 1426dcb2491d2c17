"""Attention descriptors (counterpart of the parts of transformerengine_tpu/
attention.py that the serving path uses): the mask taxonomy and
per-sequence lengths. Segment ids (packed batches) are not ported yet."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

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
