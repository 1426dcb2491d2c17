"""Fused cross entropy (counterpart of transformerengine_tpu/ops/
cross_entropy.py): the loss of f32-widened logits against integer
targets, with label smoothing, ``ignore_index`` and a mean, sum or no
reduction, from the log-sum-exp; autograd gives the standard (softmax -
onehot) backward. The max shift is detached, as the reference stops its
gradient: its contribution cancels.

The vocab-parallel form (logits sharded over a tensor-parallel group,
the reference's ``tp_axis``) comes with the port's tensor parallelism;
``tp_group`` raises until then.
"""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  tp_group: Optional[object] = None,
                  label_smoothing: float = 0.0, reduction: str = "mean",
                  ignore_index: int = -100) -> torch.Tensor:
    """(..., V) logits, (...) integer targets -> the loss: per token with
    ``reduction="none"`` (0 at ignored targets), their sum, or their mean
    over the targets that are not ``ignore_index``."""
    if tp_group is not None:
        raise NotImplementedError(
            "the vocab-parallel cross entropy (tp_group) comes with the "
            "port's tensor parallelism")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    x = logits.float()
    v = x.shape[-1]
    m = x.max(dim=-1).values.detach()
    se = torch.exp(x - m[..., None]).sum(dim=-1)
    lse = m + torch.log(se)
    t = targets.long()
    in_range = (t >= 0) & (t < v)
    tgt = x.gather(-1, t.clamp(0, v - 1)[..., None])[..., 0]
    tgt = torch.where(in_range, tgt, torch.zeros_like(tgt))
    nll = lse - tgt
    if label_smoothing > 0.0:
        smooth = lse - x.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    valid = t != ignore_index
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / valid.sum().clamp_min(1)


# The reference's name for the same function.
parallel_cross_entropy = cross_entropy
