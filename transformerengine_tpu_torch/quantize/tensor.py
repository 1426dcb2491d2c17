"""Quantized tensors (counterpart of transformerengine_tpu/quantize/
tensor.py), per-tensor scaling only: one usage (``ScaledTensor1x``) or
both (``ScaledTensor2x``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ScaledTensor1x:
    """One usage of a per-tensor-scaled tensor.

    ``data`` is stored as its consumer reads it: the logical shape for
    ``layout == "N"`` (rowwise), transposed for ``layout == "T"``
    (colwise). ``scale_inv`` is the (1,) f32 dequantization multiplier.
    ``resident`` marks tensors that live in device memory across steps
    (prequantized weights): GEMMs read their payload directly."""

    data: torch.Tensor
    scale_inv: torch.Tensor
    amax: Optional[torch.Tensor]
    dq_dtype: torch.dtype
    layout: str = "N"
    resident: bool = False

    def __post_init__(self):
        if self.layout not in ("N", "T"):
            raise ValueError(f"layout must be 'N' or 'T', got {self.layout}")

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self) -> torch.Tensor:
        """The high-precision tensor, in stored orientation."""
        return (self.data.float() * self.scale_inv.float().reshape(())
                ).to(self.dq_dtype)


@dataclasses.dataclass(frozen=True)
class ScaledTensor2x:
    """Rowwise (layout "N") and colwise (layout "T") usages of one tensor.
    Under per-tensor scaling both share one scale, so the colwise payload
    is the exact transpose of the rowwise one."""

    rowwise: ScaledTensor1x
    colwise: ScaledTensor1x

    def dequantize(self) -> torch.Tensor:
        return self.rowwise.dequantize()


def get_rowwise(x):
    """The rowwise usage of a ScaledTensor2x; anything else as it is."""
    return x.rowwise if isinstance(x, ScaledTensor2x) else x


def get_colwise(x):
    """The colwise usage of a ScaledTensor2x; anything else as it is."""
    return x.colwise if isinstance(x, ScaledTensor2x) else x
