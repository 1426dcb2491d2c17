"""Quantized tensors (counterpart of transformerengine_tpu/quantize/
tensor.py): one usage (``ScaledTensor1x``) or both (``ScaledTensor2x``),
per-tensor scaled, MXFP8, FP8 block scaled or NVFP4; and
:class:`QDQKernel`, a kernel's two dequantized orientations, which the
GEMMs take in place of its quantized usages."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .scaling_modes import ScalingMode


@dataclasses.dataclass(frozen=True)
class ScaledTensor1x:
    """One usage of a quantized tensor.

    ``data`` is stored as its consumer reads it: the logical shape for
    ``layout == "N"`` (rowwise), transposed for ``layout == "T"``
    (colwise). ``scale_inv`` holds the dequantization multipliers: a (1,)
    f32 tensor under tensor scaling; under MXFP8 a uint8 grid (rows,
    ceil(cols / 32)) of E8M0 biased exponents along the stored last axis
    of the 2D view: (leading dims, last dim) for "N", (first dim, the
    others) for "T", the transpose of the input's 2D view that the
    quantizer folds its leading dims into. Under FP8 block scaling
    ``scale_inv`` is an f32 grid (rows / br, cols / bc) of the 2D view.
    Under NVFP4 ``data`` holds e2m1
    values in e4m3 bytes, ``scale_inv`` the e4m3 block scales (rows / br,
    cols / 16) and ``tensor_scale_inv`` the (1,) f32 second-level scale.
    ``resident`` marks tensors that live in device memory across steps
    (prequantized weights): GEMMs read their payload directly."""

    data: torch.Tensor
    scale_inv: torch.Tensor
    amax: Optional[torch.Tensor]
    dq_dtype: torch.dtype
    layout: str = "N"
    resident: bool = False
    scaling_mode: ScalingMode = ScalingMode.CURRENT_TENSOR_SCALING
    tensor_scale_inv: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.layout not in ("N", "T"):
            raise ValueError(f"layout must be 'N' or 'T', got {self.layout}")

    @property
    def shape(self):
        return self.data.shape

    def view_2d(self) -> torch.Tensor:
        """The payload as the 2D matrix its scales run along."""
        if self.layout == "T":
            return self.data.reshape(self.data.shape[0], -1)
        return self.data.reshape(-1, self.data.shape[-1])

    def dequantize(self) -> torch.Tensor:
        """The high-precision tensor, in stored orientation. An MXFP8 or
        NVFP4 payload times its block scale is exact in bf16, so without a
        second-level scale a bf16 result is multiplied in bf16 (as the
        reference does), anything else in f32 (FP8 block scaling's f32
        scales always: such a product need not be a bf16 value); the
        tensor scale then multiplies in f32."""
        if self.scaling_mode.is_tensor_scaling:
            return (self.data.float() * self.scale_inv.float().reshape(())
                    ).to(self.dq_dtype)
        exact_bf16 = (self.dq_dtype == torch.bfloat16
                      and self.tensor_scale_inv is None
                      and not self.scaling_mode.is_fp8_block)
        out = dequantize_blocks(
            self, torch.bfloat16 if exact_bf16 else torch.float32)
        if self.tensor_scale_inv is not None:
            out = out.float() * self.tensor_scale_inv.float().reshape(())
        return out.to(self.dq_dtype)


def dequantize_blocks(t: ScaledTensor1x, mul_t: torch.dtype) -> torch.Tensor:
    """A block-scaled tensor's values, the payload times its block scales
    in ``mul_t`` (the tensor scale left out), in stored shape."""
    x = t.view_2d()
    rows, cols = x.shape
    s = t.scaling_mode.decode_scale_inv(t.scale_inv)
    br, bc = t.scaling_mode.block_shape
    if br > 1:
        s = s.repeat_interleave(br, dim=0)[:rows]
    gc = s.shape[1]
    if gc * bc == cols:
        out = x.to(mul_t).reshape(rows, gc, bc) * s.to(mul_t)[:, :, None]
    else:
        # Ragged last block: the scales are expanded to the full width.
        sf = s.repeat_interleave(bc, dim=1)[:, :cols]
        out = (x.float() * sf).to(mul_t)
    return out.reshape(t.data.shape)


def dequantize_to_bf16(t: ScaledTensor1x) -> torch.Tensor:
    """A block-scaled GEMM operand's bf16 values, the tensor scale left
    out: MXFP8 and NVFP4 multiply in bf16 (exact), FP8 block scaling in
    f32, rounded once, as the reference's ``_dq_block_to_bf16``."""
    mul_t = torch.float32 if t.scaling_mode.is_fp8_block else torch.bfloat16
    return dequantize_blocks(t, mul_t).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class QDQKernel:
    """A block-scaled kernel as both dequantized bf16 orientations, the
    once-per-step workspace of ``quantize/microbatch.py``: ``row`` (K, N),
    the dgrad's operand, and ``col`` (N, K), the forward GEMM's. Their
    values equal the quantized usages dequantized inside the GEMMs."""

    row: torch.Tensor
    col: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScaledTensor2x:
    """Rowwise (layout "N") and colwise (layout "T") usages of one tensor.
    Under per-tensor scaling both share one scale, so the colwise payload
    is the exact transpose of the rowwise one; under block scaling the
    colwise usage is the transposed tensor quantized along its own last
    axis, a different quantization with its own scale grid (under NVFP4
    its own tensor scale and amax, and optionally the RHT)."""

    rowwise: ScaledTensor1x
    colwise: ScaledTensor1x

    @property
    def scaling_mode(self) -> ScalingMode:
        return self.rowwise.scaling_mode

    def dequantize(self) -> torch.Tensor:
        return self.rowwise.dequantize()


def get_rowwise(x):
    """The rowwise usage of a ScaledTensor2x (a QDQKernel's ``row``);
    anything else as it is."""
    if isinstance(x, QDQKernel):
        return x.row
    return x.rowwise if isinstance(x, ScaledTensor2x) else x


def get_colwise(x):
    """The colwise usage of a ScaledTensor2x (a QDQKernel's ``col``);
    anything else as it is."""
    if isinstance(x, QDQKernel):
        return x.col
    return x.colwise if isinstance(x, ScaledTensor2x) else x
