"""Quantized weight workspaces (counterpart of transformerengine_tpu/
quantize/microbatch.py). Only :class:`GroupedQDQKernel` is ported; the
once-per-step ``KernelCache`` and ``quantize_grouped_kernel`` are not
ported yet."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GroupedQDQKernel:
    """Block-scaled expert weights as both dequantized bf16 orientations:
    ``nn`` (E, K, M), the forward GEMM's form, and ``tn`` (E, M, K), the
    dgrad's (contracting M). The values equal the quantized kernel
    dequantized inside the GEMM (a power-of-two scale times an fp8 value
    is exact in bf16)."""

    nn: torch.Tensor
    tn: torch.Tensor
