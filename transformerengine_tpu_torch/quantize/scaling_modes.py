"""Scaling modes of quantized tensors (counterpart of
transformerengine_tpu/quantize/scaling_modes.py), for the ported recipes:
the two per-tensor modes, MXFP8, FP8 block scaling (1D and 2D blocks)
and NVFP4 (1D and 2D blocks). Each mode
knows its block shape and the shape of its scale grid, and decodes its
stored scales to f32 dequantization multipliers."""
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
    # One f32 scale per 128 contiguous elements along the quantized axis.
    BLOCK_SCALING_1D = 4
    # One f32 scale per 128 x 128 tile of the 2D view.
    BLOCK_SCALING_2D = 5
    # Two levels: one E4M3 scale per 16 contiguous elements along the
    # quantized axis, and one f32 scale for the tensor.
    NVFP4_1D_SCALING = 6
    # The same with (16, 16) blocks (the reference's fp4_2d_quantization
    # weight mode).
    NVFP4_2D_SCALING = 7

    @property
    def is_tensor_scaling(self) -> bool:
        return self in _TENSOR_SCALING

    @property
    def is_block_scaling(self) -> bool:
        return not self.is_tensor_scaling

    @property
    def is_fp8_block(self) -> bool:
        """FP8 block scaling (f32 scales per 1 x 128 or 128 x 128)."""
        return self in (ScalingMode.BLOCK_SCALING_1D,
                        ScalingMode.BLOCK_SCALING_2D)

    @property
    def is_nvfp4(self) -> bool:
        return self in (ScalingMode.NVFP4_1D_SCALING,
                        ScalingMode.NVFP4_2D_SCALING)

    @property
    def block_shape(self) -> Tuple[int, int]:
        """(rows, cols) covered by one scale of a tensor quantized along
        its last axis."""
        return _BLOCK_SHAPES.get(self, (1, 1))

    def scale_shape(self, data_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Shape of the scale grid of a payload of ``data_shape`` (its
        leading dims folded into rows, so a 128-row tile of a stack may
        span two of its matrices); (1,) under tensor scaling."""
        if self.is_tensor_scaling or len(data_shape) == 0:
            return (1,)
        br, bc = self.block_shape
        rows = 1
        for d in data_shape[:-1]:
            rows *= d
        return (-(-rows // br), -(-data_shape[-1] // bc))

    def decode_scale_inv(self, scale_inv: torch.Tensor) -> torch.Tensor:
        """Stored scales -> f32 dequantization multipliers (E8M0 bytes for
        MXFP8, e4m3 values for NVFP4; f32 scales, FP8 block scaling's,
        as themselves)."""
        if self is ScalingMode.MXFP8_1D_SCALING:
            return decode_e8m0(scale_inv)
        return scale_inv.float()


_TENSOR_SCALING = frozenset((ScalingMode.NO_SCALING,
                             ScalingMode.DELAYED_TENSOR_SCALING,
                             ScalingMode.CURRENT_TENSOR_SCALING))
_BLOCK_SHAPES = {ScalingMode.MXFP8_1D_SCALING: (1, 32),
                 ScalingMode.BLOCK_SCALING_1D: (1, 128),
                 ScalingMode.BLOCK_SCALING_2D: (128, 128),
                 ScalingMode.NVFP4_1D_SCALING: (1, 16),
                 ScalingMode.NVFP4_2D_SCALING: (16, 16)}
