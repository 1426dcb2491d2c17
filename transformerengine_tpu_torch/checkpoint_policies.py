"""Rematerialization (activation checkpointing) policies (counterpart of
transformerengine_tpu/checkpoint_policies.py), and :func:`checkpoint`,
which runs a function under one.

A checkpointed call is ``torch.utils.checkpoint.checkpoint`` in its
non-reentrant form: the forward runs under autograd as usual (a layer
takes the same branches as without remat), its saved tensors are
dropped, and the backward runs the forward again to make them. A policy
says which forward values the call keeps for that second run, which then
takes them in place of computing them again:

* ``nothing_saveable``: none; everything is computed again.
* ``dots_saveable`` / ``dots_with_no_batch_dims_saveable``: the GEMM
  outputs of ``ops.gemm.matmul_f32`` inside the layers' autograd
  functions (the dense layers' and the experts'; every one 2-D, so the
  two coincide here). A value computed while autograd records (the MoE
  router's f32 GEMM) is never kept: the second forward must make its
  graph again. The attention's products are inside the flash kernels,
  which run again.
* ``offload_dot_with_no_batch_dims()``: the same outputs kept in pinned
  host memory (copied out and back on the current stream).
* ``save_only_these_names(*names)``: values tagged with
  :func:`checkpoint_name` (or made by :func:`keep` under ``"name:<n>"``)
  inside an autograd function's forward. The reference's layers tag
  none. A value tagged after it was computed has had its producer run
  again; :func:`keep` skips the producer.
* ``everything_saveable``: no recompute (the function is called as is).

What the second forward must see as the first did, :func:`checkpoint`
restores around it: the quantization configuration of ``autocast`` (the
backward, where the second forward runs, is usually outside it; the
delayed-scaling scales come from the modules' buffers, which each GEMM's
backward writes only after the layer's second forward), and the state of
every ``torch.Generator`` passed to the function (a layer's dropout draws
from an explicit generator, which ``torch.utils.checkpoint`` does not
restore; PyTorch's default generators it restores itself). After the
second forward each generator is put back where the backward found it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, FrozenSet, Iterable

import torch
import torch.utils.checkpoint

__all__ = ["RematPolicy", "nothing_saveable", "everything_saveable",
           "dots_saveable", "dots_with_no_batch_dims_saveable",
           "checkpoint_dots", "save_only_these_names",
           "offload_dot_with_no_batch_dims",
           "save_and_offload_only_these_names", "checkpoint_name",
           "checkpoint", "keep", "remat_policy"]

DOT = "dot"


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Which tagged forward values a checkpointed call keeps on the device
    (``saved``) and in pinned host memory (``offloaded``): ``"dot"`` for
    the dense GEMMs' outputs, ``"name:<n>"`` for :func:`checkpoint_name`
    tags. ``remat`` False keeps everything (no recompute)."""
    name: str
    saved: FrozenSet[str] = frozenset()
    offloaded: FrozenSet[str] = frozenset()
    remat: bool = True


nothing_saveable = RematPolicy("nothing_saveable")
everything_saveable = RematPolicy("everything_saveable", remat=False)
dots_saveable = RematPolicy("dots_saveable", saved=frozenset({DOT}))
dots_with_no_batch_dims_saveable = RematPolicy(
    "dots_with_no_batch_dims_saveable", saved=frozenset({DOT}))
checkpoint_dots = dots_saveable


def _tags(names: Iterable[str]) -> FrozenSet[str]:
    return frozenset(f"name:{n}" for n in names)


def save_only_these_names(*names: str) -> RematPolicy:
    """Keep only the values tagged with these names."""
    return RematPolicy("save_only_these_names", saved=_tags(names))


def _check_offload(offload_src: str, offload_dst: str) -> None:
    if (offload_src, offload_dst) != ("device", "pinned_host"):
        raise ValueError(f"offload from the device to pinned_host only, got "
                         f"{offload_src!r} to {offload_dst!r}")


def offload_dot_with_no_batch_dims(offload_src: str = "device",
                                   offload_dst: str = "pinned_host"
                                   ) -> RematPolicy:
    """Keep the dense GEMMs' outputs in pinned host memory."""
    _check_offload(offload_src, offload_dst)
    return RematPolicy("offload_dot_with_no_batch_dims",
                       offloaded=frozenset({DOT}))


def save_and_offload_only_these_names(
        *, names_which_can_be_saved=(), names_which_can_be_offloaded=(),
        offload_src: str = "device",
        offload_dst: str = "pinned_host") -> RematPolicy:
    """Keep the first names' values on the device, the second's in pinned
    host memory."""
    _check_offload(offload_src, offload_dst)
    return RematPolicy("save_and_offload_only_these_names",
                       saved=_tags(names_which_can_be_saved),
                       offloaded=_tags(names_which_can_be_offloaded))


def remat_policy(name: str) -> RematPolicy:
    """The policy of a model config's ``remat_policy`` name:
    ``"nothing_saveable"``, ``"dots"`` or ``"offload_dots"``."""
    if name == "nothing_saveable":
        return nothing_saveable
    if name == "dots":
        return dots_with_no_batch_dims_saveable
    if name == "offload_dots":
        return offload_dot_with_no_batch_dims()
    raise ValueError(f"unknown remat_policy {name!r}")


class _Frame:
    """One checkpointed call's kept values: recorded in the first forward,
    handed out in order in the second."""

    def __init__(self, policy: RematPolicy):
        self.policy = policy
        self.values = []
        self.replay_at = None     # None: the first forward records

    def keep(self, kind: str, compute: Callable[[], torch.Tensor]):
        offload = kind in self.policy.offloaded
        if (not offload and kind not in self.policy.saved) \
                or torch.is_grad_enabled():
            return compute()
        if self.replay_at is not None:
            value, device = self.values[self.replay_at]
            self.replay_at += 1
            return value.to(device, non_blocking=True) if offload else value
        out = compute()
        if offload and out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, device="cpu",
                               pin_memory=True)
            self.values.append((host.copy_(out, non_blocking=True),
                                out.device))
        else:
            self.values.append((out.detach(), out.device))
        return out


class _Frames(threading.local):
    # Per thread: the backward (and so the second forward) of CUDA
    # tensors runs on autograd's device thread.
    def __init__(self):
        self.stack = []


_frames = _Frames()


def keep(kind: str, compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``compute()``, or, inside a checkpointed call whose policy keeps
    ``kind`` and where autograd does not record (an autograd function's
    forward), the value the first forward kept (recorded there)."""
    if not _frames.stack:
        return compute()
    return _frames.stack[-1].keep(kind, compute)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tags ``x`` for ``save_only_these_names``; ``x`` itself elsewhere."""
    return keep(f"name:{name}", lambda: x)


@contextlib.contextmanager
def _pushed(frame: _Frame):
    _frames.stack.append(frame)
    try:
        yield
    finally:
        _frames.stack.pop()


def _contexts(policy: RematPolicy, generators):
    # Imported here: the GEMMs import this module, and the quantizers
    # import the GEMMs.
    from .quantize.helper import autocast, get_quantize_config
    frame = _Frame(policy)
    first = {}

    @contextlib.contextmanager
    def forward():
        first["config"] = get_quantize_config()
        first["rng"] = [g.get_state() for g in generators]
        with _pushed(frame):
            yield

    @contextlib.contextmanager
    def recompute():
        found = [g.get_state() for g in generators]
        for g, state in zip(generators, first["rng"]):
            g.set_state(state)
        frame.replay_at = 0
        cfg = first["config"]
        try:
            with autocast(cfg.enabled, cfg.recipe), _pushed(frame):
                yield
        finally:
            for g, state in zip(generators, found):
                g.set_state(state)

    return forward(), recompute()


def checkpoint(fn: Callable, *args, policy: RematPolicy = nothing_saveable,
               **kwargs):
    """``fn(*args, **kwargs)`` as one checkpointed call under ``policy``
    (the module docstring). Without autograd, or under
    ``everything_saveable``, it is the plain call."""
    if not policy.remat or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    generators = [a for a in (*args, *kwargs.values())
                  if isinstance(a, torch.Generator)]
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: _contexts(policy, generators), **kwargs)
