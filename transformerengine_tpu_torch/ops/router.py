"""MoE router: top-k selection with a score function, and the
load-balancing aux loss (counterpart of transformerengine_tpu/ops/
router.py). Everything is f32; the probabilities are differentiable in
the logits through autograd, as the reference's are through XLA's."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _mask(shape, idx: torch.Tensor) -> torch.Tensor:
    """A bool (T, n) mask, True at the columns ``idx`` (T, k) of each row."""
    return torch.zeros(shape, dtype=torch.bool, device=idx.device).scatter_(
        1, idx, True)


def fused_topk_with_score_function(
        logits: torch.Tensor, topk: int, *, score_function: str = "softmax",
        use_pre_softmax: bool = False, num_groups: int = 0,
        group_topk: int = 0, scaling_factor: float = 1.0,
        expert_bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs (T, E) f32, zero at the unselected experts; routing_map (T,
    E) bool) of ``logits`` (T, E). ``score_function`` "softmax" (over the
    selected logits, or over all of them before the selection with
    ``use_pre_softmax``) or "sigmoid" (normalized over the selection when
    ``topk`` > 1); ``expert_bias`` moves the selection only;
    ``num_groups``/``group_topk`` keep the best groups of experts, each
    ranked by the sum of its two best selection scores."""
    if score_function not in ("softmax", "sigmoid"):
        raise ValueError(f"score_function must be softmax or sigmoid, got "
                         f"{score_function!r}")
    t, e = logits.shape
    x = logits.float()
    if score_function == "sigmoid":
        scores = torch.sigmoid(x)
    elif use_pre_softmax:
        scores = torch.softmax(x, dim=-1)
    else:
        scores = x
    select = scores if expert_bias is None else scores + expert_bias.float()
    if num_groups > 0 and group_topk > 0:
        gsize = e // num_groups
        grouped = select.reshape(t, num_groups, gsize)
        gscore = grouped.topk(min(2, gsize), dim=-1).values.sum(-1)
        gmask = _mask((t, num_groups), gscore.topk(group_topk, dim=-1).indices)
        select = torch.where(gmask.repeat_interleave(gsize, dim=1), select,
                             float("-inf"))
    routing_map = _mask((t, e), select.topk(topk, dim=-1).indices)
    if score_function == "softmax" and not use_pre_softmax:
        probs = torch.softmax(torch.where(routing_map, x, float("-inf")),
                              dim=-1)
        probs = torch.where(routing_map, probs, 0.0)
    else:
        probs = torch.where(routing_map, scores, 0.0)
        if score_function == "sigmoid" and topk > 1:
            probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-20)
    return probs * scaling_factor, routing_map


def fused_moe_aux_loss(probs: torch.Tensor, routing_map: torch.Tensor,
                       total_num_tokens: Optional[int] = None, *,
                       topk: int = 1, coeff: float = 1e-2) -> torch.Tensor:
    """Switch-style load-balancing loss: ``E / (topk * T^2) * sum_e
    tokens_e * sum_t probs[t, e]``, times ``coeff``; a 0-d f32 tensor."""
    t, e = probs.shape
    total = total_num_tokens or t
    tokens_per_expert = routing_map.sum(0).float()
    prob_sum = probs.float().sum(0)
    loss = (tokens_per_expert * prob_sum).sum() * (
        e / (topk * float(total) ** 2))
    return loss * coeff


def compute_routing(logits: torch.Tensor, topk: int, **kwargs
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs, routing_map, aux_loss) in one call; the aux loss takes the
    full softmax of the logits. ``aux_loss_coeff`` (default 1e-2) is its
    coefficient; the other keywords go to
    :func:`fused_topk_with_score_function`."""
    coeff = kwargs.pop("aux_loss_coeff", 1e-2)
    probs, routing_map = fused_topk_with_score_function(logits, topk,
                                                        **kwargs)
    full = torch.softmax(logits.float(), dim=-1)
    aux = fused_moe_aux_loss(full, routing_map, topk=topk, coeff=coeff)
    return probs, routing_map, aux
