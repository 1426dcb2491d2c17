"""Per-expert (grouped) quantization for MoE (counterpart of
transformerengine_tpu/quantize/grouped.py): expert-contiguous rows and
stacked expert kernels quantized with one current-scaling scale per
expert, and the grouped GEMM that applies the per-expert scale products
to its f32 output rows.

As in the reference, rows past the groups (when the group sizes sum to
fewer than the rows) count as the last expert's."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.grouped_gemm import GroupSizes, grouped_gemm, host_sizes
from . import qmath


def expert_of_row(group_sizes: GroupSizes, n: int, device) -> torch.Tensor:
    """(n,) the expert of each row; rows past the groups take the last
    expert (``jnp.repeat``'s ``total_repeat_length`` padding)."""
    sizes = torch.as_tensor(host_sizes(group_sizes), device=device)
    idx = torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                  sizes)[:n]
    pad = n - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx.new_full((pad,), len(sizes) - 1)])
    return idx


@dataclasses.dataclass(frozen=True)
class GroupedScaledTensor:
    """Expert-grouped quantized rows: ``data`` (N, K), ``scale_inv`` (E,)
    f32 dequantization multipliers, ``group_sizes`` (E,) and the (E,)
    per-group ``amax``."""

    data: torch.Tensor
    scale_inv: torch.Tensor
    group_sizes: GroupSizes
    amax: Optional[torch.Tensor]
    dq_dtype: torch.dtype

    @property
    def num_groups(self) -> int:
        return self.scale_inv.shape[0]

    def row_scale_inv(self) -> torch.Tensor:
        """(N,) each row's dequantization multiplier."""
        return self.scale_inv[expert_of_row(
            self.group_sizes, self.data.shape[0], self.data.device)]

    def dequantize(self) -> torch.Tensor:
        return (self.data.float() * self.row_scale_inv()[:, None]).to(
            self.dq_dtype)


@dataclasses.dataclass(frozen=True)
class GroupedKernelTensor:
    """Stacked expert kernels (E, K, M) with one scale per expert."""

    data: torch.Tensor
    scale_inv: torch.Tensor
    amax: Optional[torch.Tensor]
    dq_dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class GroupedQuantizer:
    """Current scaling with one scale per expert group: each group's
    scale is q_max / its amax (1 for an empty or all-zero group)."""

    q_dtype: torch.dtype
    num_groups: int = 1

    def quantize_rows(self, x: torch.Tensor, group_sizes: GroupSizes
                      ) -> GroupedScaledTensor:
        """Expert-contiguous rows (N, K), one scale per group."""
        expert = expert_of_row(group_sizes, x.shape[0], x.device)
        row_amax = x.float().abs().amax(dim=1)
        amax = torch.zeros(self.num_groups, dtype=torch.float32,
                           device=x.device).scatter_reduce(
            0, expert, row_amax, "amax")
        scale = qmath.compute_scale_from_amax(amax, self.q_dtype)
        data = qmath.saturate_cast(x.float() * scale[expert][:, None],
                                   self.q_dtype)
        return GroupedScaledTensor(data, 1.0 / scale, group_sizes, amax,
                                   x.dtype)

    def quantize_kernels(self, kernels: torch.Tensor) -> GroupedKernelTensor:
        """Stacked kernels (E, K, M), one scale per expert."""
        amax = kernels.float().abs().amax(dim=(1, 2))
        scale = qmath.compute_scale_from_amax(amax, self.q_dtype)
        data = qmath.saturate_cast(kernels.float() * scale[:, None, None],
                                   self.q_dtype)
        return GroupedKernelTensor(data, 1.0 / scale, amax, kernels.dtype)


def grouped_gemm_scaled(x: GroupedScaledTensor, w: GroupedKernelTensor,
                        group_sizes: GroupSizes) -> torch.Tensor:
    """(N, M) f32: the grouped GEMM of the bf16-widened payloads (exact
    products, f32 sums), each row times its expert's scale product."""
    out = grouped_gemm(x.data.to(torch.bfloat16), w.data.to(torch.bfloat16),
                       group_sizes)
    expert = expert_of_row(group_sizes, x.data.shape[0], x.data.device)
    return out * (x.scale_inv[expert] * w.scale_inv[expert])[:, None]
