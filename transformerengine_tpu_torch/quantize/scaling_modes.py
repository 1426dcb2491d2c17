"""Scaling modes of quantized tensors (counterpart of
transformerengine_tpu/quantize/scaling_modes.py), for the ported recipes:
the two per-tensor modes and MXFP8. Each mode knows its block shape and
the shape of its scale grid, and decodes its stored scales to f32
dequantization multipliers."""
from __future__ import annotations

import enum
from typing import Tuple

import torch

from .dtypes import decode_e8m0


class ScalingMode(enum.Enum):
    """How the scales of a quantized tensor relate to its payload."""

    # High precision (a NoopQuantizer's role).
    NO_SCALING = 0
    # One f32 scale for the whole tensor, from an amax history carried
    # across steps.
    DELAYED_TENSOR_SCALING = 1
    # One f32 scale from the tensor's current amax.
    CURRENT_TENSOR_SCALING = 2
    # One E8M0 (power-of-two) scale per 32 contiguous elements along the
    # quantized (stored last) axis, stored as its biased exponent in a
    # uint8 grid.
    MXFP8_1D_SCALING = 3

    @property
    def is_tensor_scaling(self) -> bool:
        return self is not ScalingMode.MXFP8_1D_SCALING

    @property
    def block_shape(self) -> Tuple[int, int]:
        """(rows, cols) covered by one scale of a tensor quantized along
        its last axis."""
        return (1, 32) if self is ScalingMode.MXFP8_1D_SCALING else (1, 1)

    def scale_shape(self, data_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Shape of the scale grid of a payload of ``data_shape`` (its
        leading dims folded into rows); (1,) under tensor scaling."""
        if self.is_tensor_scaling or len(data_shape) == 0:
            return (1,)
        br, bc = self.block_shape
        rows = 1
        for d in data_shape[:-1]:
            rows *= d
        return (-(-rows // br), -(-data_shape[-1] // bc))

    def decode_scale_inv(self, scale_inv: torch.Tensor) -> torch.Tensor:
        """Stored scales -> f32 dequantization multipliers."""
        if self is ScalingMode.MXFP8_1D_SCALING:
            return decode_e8m0(scale_inv)
        return scale_inv.float()
