"""Quantizers (counterpart of transformerengine_tpu/quantize/quantizer.py),
ported for per-tensor current scaling in one orientation."""
from __future__ import annotations

import dataclasses
import enum

import torch

from . import qmath
from .tensor import ScaledTensor1x


class QuantizeLayout(enum.Enum):
    ROWWISE = enum.auto()
    COLWISE = enum.auto()


@dataclasses.dataclass(frozen=True)
class CurrentScaleQuantizer:
    """Per-tensor scaling from the current amax. ROWWISE keeps the
    logical layout; COLWISE stores the 2D view transposed, so the
    quantized axis is again the last one (the (N, K) layout a TN GEMM
    reads)."""

    q_dtype: torch.dtype
    q_layout: QuantizeLayout = QuantizeLayout.ROWWISE

    def quantize(self, x: torch.Tensor, *, dq_dtype=None) -> ScaledTensor1x:
        """Quantizes ``x`` (any rank; its 2D view folds the leading
        dims)."""
        dq_dtype = dq_dtype or x.dtype
        x2d = x.reshape(-1, x.shape[-1])
        if self.q_layout is QuantizeLayout.ROWWISE:
            data, s_inv, amax = qmath.current_scale_quantize(x2d, self.q_dtype)
            return ScaledTensor1x(data.reshape(x.shape), s_inv, amax,
                                  dq_dtype, layout="N")
        data, s_inv, amax = qmath.current_scale_quantize(x2d.t(), self.q_dtype)
        t_shape = (x.shape[-1],) + tuple(x.shape[:-1])
        return ScaledTensor1x(data.contiguous().reshape(t_shape), s_inv, amax,
                              dq_dtype, layout="T")
