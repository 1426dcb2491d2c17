"""MoE token permutation (counterpart of transformerengine_tpu/
permutation.py): dispatch sorts the tokens' copies by expert, combine
sums each token's weighted expert outputs back in token order."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def make_dispatch_indices(routing_map: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm (T*E,), group_sizes (E,) int32, inv_perm (T*E,)) of a (T, E)
    bool routing map: ``perm`` orders the flattened (token, expert) grid
    by expert id, stably, with the unselected entries last."""
    t, e = routing_map.shape
    expert_id = torch.arange(e, device=routing_map.device).expand(t, e)
    key = torch.where(routing_map, expert_id, e).reshape(-1)
    perm = torch.argsort(key, stable=True)
    group_sizes = routing_map.sum(0).to(torch.int32)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, group_sizes, inv_perm


def token_dispatch(x: torch.Tensor, routing_map: torch.Tensor,
                   num_out_tokens: Optional[int] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """Each token of ``x`` (T, H) copied to each expert it selects,
    expert-contiguous: (dispatched (N, H), aux), N = ``num_out_tokens``
    (default T*E; T*topk is the tight bound), rows past the selections
    zero. ``aux`` carries what :func:`token_combine` needs."""
    t, e = routing_map.shape
    n = num_out_tokens if num_out_tokens is not None else t * e
    perm, group_sizes, inv_perm = make_dispatch_indices(routing_map)
    token_of_slot = perm[:n] // e
    valid = torch.arange(n, device=x.device) < routing_map.sum()
    out = torch.where(valid[:, None], x[token_of_slot], 0)
    aux = dict(perm=perm, inv_perm=inv_perm, group_sizes=group_sizes,
               token_of_slot=token_of_slot, valid=valid,
               routing_map=routing_map, num_tokens=t)
    return out, aux


def token_combine(expert_out: torch.Tensor, probs: torch.Tensor,
                  aux: dict, topk: Optional[int] = None) -> torch.Tensor:
    """The expert outputs (N, H), each weighted by its token's
    probability for that expert (in the outputs' dtype), summed per token
    (f32 sums, one rounding to the outputs' dtype): (T, H). ``topk``
    says that every token selects exactly that many experts and N is
    T * ``topk`` (top-k routing, as :func:`~.moe.moe` dispatches)."""
    t, e = probs.shape
    n = expert_out.shape[0]
    if topk is not None and n != t * topk:
        raise ValueError(f"{n} slots for {t} tokens at top-{topk}")
    token_of_slot = aux["token_of_slot"]
    expert_of_slot = aux["perm"][:n] % e
    w = probs[token_of_slot, expert_of_slot].to(expert_out.dtype)
    w = torch.where(aux["valid"], w, 0)
    contrib = expert_out * w[:, None]
    # The reference's segment_sum, in a fixed order: the same result on
    # every run, where index_add's atomics on the card would sum three or
    # more terms of a token in any order (GPT-OSS's top-4). Each token's
    # terms are summed in expert order over a (T, K) grid: with top-k
    # routing its slots, sorted by (token, expert), fill a (T, topk)
    # grid; otherwise each slot goes to its own row of a (T, E) grid.
    if topk is not None:
        order = torch.argsort(aux["perm"][:n])
        return contrib[order].view(t, topk, -1).sum(dim=1)
    grid = contrib.new_zeros((t * e, contrib.shape[1]))
    grid = grid.index_copy(0, aux["perm"][:n], contrib)
    return grid.view(t, e, -1).sum(dim=1)


def moe_permute(x, routing_map, num_out_tokens=None):
    """The reference's alias of :func:`token_dispatch`."""
    return token_dispatch(x, routing_map, num_out_tokens)


def moe_unpermute(expert_out, probs, aux):
    """The reference's alias of :func:`token_combine`."""
    return token_combine(expert_out, probs, aux)
