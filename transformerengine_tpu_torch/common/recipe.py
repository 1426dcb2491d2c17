"""Quantization recipes (counterpart of transformerengine_tpu/common/
recipe.py). Only per-tensor current scaling is ported so far; the
backward-pass formats arrive with the training slice."""
from __future__ import annotations

import dataclasses

import torch


class Recipe:
    """Base class of the quantization recipes."""


@dataclasses.dataclass(frozen=True)
class Float8CurrentScaling(Recipe):
    """Per-tensor scaling from the current amax; forward tensors (weights
    and activations) are stored in ``fp8_dtype``."""

    fp8_dtype: torch.dtype = torch.float8_e4m3fn
