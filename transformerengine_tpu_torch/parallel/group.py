"""The collectives of context parallelism over a ``torch.distributed``
process group (the counterparts of the reference's ``lax`` collectives
over a mesh axis inside ``shard_map``):

* :func:`axis_index` and :func:`axis_size`: the group rank and size
  (``lax.axis_index``, ``lax.axis_size``);
* :func:`ring_shift`: each rank sends its tensors to the next rank of the
  group and receives the previous rank's (``lax.ppermute`` on the ring),
  one ``batch_isend_irecv``;
* :func:`all_gather` and :func:`all_to_all`: the tiled ``lax.all_gather``
  and ``lax.all_to_all`` along a dimension (the list form of
  ``all_gather``, and the all-to-all as point-to-point pairs, which every
  backend takes); :func:`reduce_scatter`, the gather's transpose;
  :class:`AllGather` and :class:`AllToAll` differentiate the gather and
  the all-to-all (a gather's gradient is the reduce-scatter of the
  ranks' gradients, an all-to-all's the reverse all-to-all);
* :func:`pmax`: ``all_reduce(MAX)`` (``lax.pmax``).

Data moves as bytes (each tensor viewed as uint8), so any dtype crosses,
fp8 payloads included. The gloo backend takes host tensors only: under a
gloo group a CUDA tensor crosses through the host, in :func:`_to_wire`
and :func:`_from_wire` alone, which add the bytes they copy to
``STAGED``. That is the backend's rule, not a fallback: the kernels and
the merges stay on the card. Under NCCL the tensors move on the card.
"""
from __future__ import annotations

import collections
from typing import List, Sequence

import torch
import torch.distributed as dist

# Bytes copied between the card and the host for a gloo group
# ("to_host", "to_card").
STAGED: collections.Counter = collections.Counter()


def axis_index(group) -> int:
    """This rank's index in ``group``."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a contiguous uint8 tensor the backend takes (on
    the host for a CUDA tensor under gloo)."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    if _staged(group, t):
        STAGED["to_host"] += raw.numel()
        return raw.cpu()
    return raw


def _from_wire(group, raw: torch.Tensor, like: torch.Tensor,
               shape=None) -> torch.Tensor:
    """Bytes received for a tensor of ``like``'s dtype and device, of
    ``shape`` (``like``'s by default)."""
    if raw.device != like.device:
        STAGED["to_card"] += raw.numel()
        raw = raw.to(like.device)
    return raw.view(like.dtype).reshape(like.shape if shape is None
                                        else shape)


def _peer(group, r: int) -> int:
    """The global rank of group rank ``r`` (point-to-point ops name
    global ranks)."""
    return dist.get_global_rank(group, r) if group is not None else r


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor sent to the next rank of ``group`` and the previous
    rank's received in its place (the reference's ``ppermute`` with
    ``perm = [(d, (d + 1) % cp)]``)."""
    n, r = axis_size(group), axis_index(group)
    if n == 1:
        return list(tensors)
    nxt, prv = _peer(group, (r + 1) % n), _peer(group, (r - 1) % n)
    sends = [_to_wire(group, t) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for s, v in zip(sends, recvs):
        ops += [dist.P2POp(dist.isend, s, nxt, group),
                dist.P2POp(dist.irecv, v, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_from_wire(group, v, t) for v, t in zip(recvs, tensors)]


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (tiled)."""
    n = axis_size(group)
    if n == 1:
        return t
    wire = _to_wire(group, t)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([_from_wire(group, p, t) for p in parts], dim=dim)


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all: ``t`` split into ``n`` chunks along
    ``split_dim``, chunk ``i`` sent to rank ``i``, and the chunks received
    concatenated along ``concat_dim`` in rank order."""
    n, r = axis_size(group), axis_index(group)
    if n == 1:
        return t
    chunks = list(t.chunk(n, dim=split_dim))
    peers = [i for i in range(n) if i != r]
    sends = {i: _to_wire(group, chunks[i]) for i in peers}
    recvs = {i: torch.empty_like(sends[i]) for i in peers}
    ops = []
    for i in peers:
        ops += [dist.P2POp(dist.isend, sends[i], _peer(group, i), group),
                dist.P2POp(dist.irecv, recvs[i], _peer(group, i), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([chunks[r] if i == r else
                      _from_wire(group, recvs[i], chunks[i])
                      for i in range(n)], dim=concat_dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` (``t``'s size there over the
    group's size) of the sum of the ranks' ``t``: the transpose of the
    tiled :func:`all_gather`. Each slice goes to its rank in an
    all-to-all, and the rank sums what it receives in f32, in rank
    order."""
    if axis_size(group) == 1:
        return t
    parts = all_to_all(t.unsqueeze(0), group, dim + 1, 0)
    return parts.float().sum(dim=0).to(t.dtype)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """``op`` over the group of an f32 copy of ``t`` (``t`` itself is left
    as it is), in ``t``'s dtype and device."""
    if axis_size(group) == 1:
        return t
    if _staged(group, t):
        wire = t.float().contiguous().cpu()
        STAGED["to_host"] += wire.numel() * 4
    else:
        wire = t.to(torch.float32, memory_format=torch.contiguous_format,
                    copy=True)
    dist.all_reduce(wire, op=op, group=group)
    if wire.device != t.device:
        STAGED["to_card"] += wire.numel() * 4
    return wire.to(device=t.device, dtype=t.dtype)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the group (f32 on the wire)."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group, in f32 on the wire, in ``t``'s
    dtype (a training step's gradient sum)."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


class AllGather(torch.autograd.Function):
    """:func:`all_gather` along ``dim``; the gradient of this rank's slice
    is the sum over the ranks of their gradients of it (the transpose of
    the reference's tiled gather, :func:`reduce_scatter`)."""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its gradient is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, t, group, split_dim: int, concat_dim: int):
        ctx.args = (group, concat_dim, split_dim)
        return all_to_all(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), *ctx.args), None, None, None
