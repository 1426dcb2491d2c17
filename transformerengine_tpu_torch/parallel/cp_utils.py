"""Causal load-balancing reorders of context parallelism (counterpart of
transformerengine_tpu/parallel/cp_utils.py). With causal masking and the
sequence split contiguously over ``cp`` ranks, later ranks do more work;
these reorders rebalance it:

* dual-chunk swap: the sequence cut into 2 * cp chunks, rank i taking
  chunks i and 2 * cp - 1 - i;
* striped: token t to rank t % cp (stripes of ``stripe_size`` tokens).

Apply a reorder to the global sequence before splitting it over the ranks
and its inverse to the gathered output.
"""
from __future__ import annotations

import torch


def _take(x: torch.Tensor, idx, seq_dim: int) -> torch.Tensor:
    return torch.index_select(x, seq_dim, torch.as_tensor(
        idx, dtype=torch.long, device=x.device))


def _dual_chunk_order(cp_size: int) -> list:
    order = []
    for i in range(cp_size):
        order += [i, 2 * cp_size - 1 - i]
    return order


def reorder_causal_dual_chunk_swap(x: torch.Tensor, cp_size: int,
                                   seq_dim: int = 1) -> torch.Tensor:
    """The global sequence in load-balanced order: rank i's shard holds
    chunks i and 2 * cp - 1 - i of 2 * cp."""
    s = x.shape[seq_dim]
    if s % (2 * cp_size):
        raise ValueError(f"sequence {s} not a multiple of 2 * cp = "
                         f"{2 * cp_size}")
    chunk = s // (2 * cp_size)
    idx = [c * chunk + t for c in _dual_chunk_order(cp_size)
           for t in range(chunk)]
    return _take(x, idx, seq_dim)


def inverse_reorder_causal_dual_chunk_swap(x: torch.Tensor, cp_size: int,
                                           seq_dim: int = 1) -> torch.Tensor:
    s = x.shape[seq_dim]
    chunk = s // (2 * cp_size)
    inv = [0] * (2 * cp_size)
    for pos, c in enumerate(_dual_chunk_order(cp_size)):
        inv[c] = pos
    idx = [p * chunk + t for p in inv for t in range(chunk)]
    return _take(x, idx, seq_dim)


def reorder_causal_striped(x: torch.Tensor, cp_size: int, seq_dim: int = 1,
                           stripe_size: int = 1) -> torch.Tensor:
    """Tokens dealt round-robin over the ranks, ``stripe_size`` at a time:
    [t0, t_cp, t_2cp, ... | t1, ...] for stripes of 1."""
    s = x.shape[seq_dim]
    if s % (cp_size * stripe_size):
        raise ValueError(f"sequence {s} not a multiple of cp * stripe = "
                         f"{cp_size * stripe_size}")
    idx = torch.arange(s).reshape(s // (cp_size * stripe_size), cp_size,
                                  stripe_size).transpose(0, 1).reshape(-1)
    return _take(x, idx, seq_dim)


def inverse_reorder_causal_striped(x: torch.Tensor, cp_size: int,
                                   seq_dim: int = 1,
                                   stripe_size: int = 1) -> torch.Tensor:
    s = x.shape[seq_dim]
    idx = torch.arange(s).reshape(cp_size, s // (cp_size * stripe_size),
                                  stripe_size).transpose(0, 1).reshape(-1)
    return _take(x, idx, seq_dim)


def dual_chunk_positions(cp_size: int, local_len: int, rank: int,
                         device=None) -> torch.Tensor:
    """The global positions (local_len,) of rank ``rank``'s shard under the
    dual-chunk swap (its RoPE positions after the reorder)."""
    chunk = local_len // 2
    ar = torch.arange(chunk, device=device)
    return torch.cat([rank * chunk + ar,
                      (2 * cp_size - 1 - rank) * chunk + ar])
