"""CUDA graphs: capture a step once, replay it (counterpart of
transformerengine_tpu/graph.py, which stands in for the upstream
``make_graphed_callables`` with ``jax.jit``).

:class:`CapturedStep` is the shared piece: it captures a callable that
reads and writes tensors allocated before the capture, and replays it
(on CPU tensors it calls the callable at each replay instead).
The kernel wrappers count their launches in Python (``_build.LAUNCHES``),
which a replay does not run, so the capture takes the counter's
difference over its own run, puts the counter back (a capture launches
nothing) and adds that difference at every replay.

:func:`make_graphed_callables` keeps the reference's signature. On the
card a callable is captured with static input buffers, at construction
when ``sample_args`` are given and otherwise at its first call (as
``jax.jit`` compiles at its first call), once for each signature of its
arguments (shapes, dtypes, the values of non-tensor arguments); its
outputs are cloned out of the graph, so a returned tensor never aliases
a buffer that the next replay overwrites. Inputs that need a gradient
take ``torch.cuda.make_graphed_callables`` (forward and backward graphs).
On CPU tensors the callable runs eagerly.

Capture hazards: a captured step must read nothing back to the host and
must stay one serial chain on the capture stream (the decode kernels
share device-side ticket arrays between launches); a weight tensor that
is replaced after the capture (an assignment, not an in-place
``copy_``) leaves the graph reading the old one.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Sequence, Tuple, Union

import torch
from torch.utils._pytree import tree_flatten, tree_map

from . import _build

# Captures made, by name (the engine's decode step, make_graphed_callables);
# an eager CapturedStep (CPU tensors) counts as one too.
CAPTURES: collections.Counter = collections.Counter()


def _cause(exc: BaseException) -> str:
    """The first error of a failed capture: a capture that a host read
    invalidates raises again when it ends, and that second error is the
    one that reaches the caller, with the first as its context."""
    while exc.__context__ is not None and exc.__cause__ is None:
        exc = exc.__context__
    return f"{type(exc).__name__}: {exc}"


class CapturedStep:
    """``fn()`` captured as one CUDA graph on its own memory pool.
    ``fn`` reads and writes tensors that exist before the capture; what
    it allocates lives in the graph's pool for as long as this object.
    ``generators`` are the card generators it draws from, registered
    with the graph so that each replay advances them as an eager call
    would. Raises, naming the cause, where ``fn`` cannot be captured.
    With ``eager`` (CPU tensors, which have no graphs) nothing is
    captured and each replay calls ``fn``; ``output`` is then the last
    call's."""

    def __init__(self, fn: Callable, name: str,
                 generators: Iterable[torch.Generator] = (),
                 eager: bool = False):
        self.fn = fn if eager else None
        self.output = None
        if not eager:
            self._capture(fn, name, generators)
        CAPTURES[name] += 1

    def _capture(self, fn, name, generators) -> None:
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = collections.Counter(_build.LAUNCHES)
        try:
            with torch.cuda.graph(self.graph):
                self.output = fn()
        except RuntimeError as exc:
            raise RuntimeError(f"{name} cannot be captured as a CUDA graph: "
                               f"{_cause(exc)}") from exc
        finally:
            self.launches = _build.LAUNCHES - before
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)

    def replay(self) -> None:
        if self.fn is not None:
            self.output = self.fn()
            return
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _signature(args) -> tuple:
    leaves, spec = tree_flatten(args)
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, t.device, t.requires_grad)
        if isinstance(t, torch.Tensor) else t for t in leaves)


class _Graphed:
    """One callable: eager on CPU tensors, else one capture a signature."""

    def __init__(self, fn: Callable, num_warmup_iters: int):
        self.fn = fn
        self.warmup = max(1, num_warmup_iters)
        self.graphs = {}

    def prepare(self, args):
        """The graph of ``args``' signature, captured if there is none."""
        key = _signature(args)
        graphed = self.graphs.get(key)
        if graphed is None:
            params = self.fn.parameters() if isinstance(
                self.fn, torch.nn.Module) else ()
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (*_tensors(args), *params)):
                graphed = _AutogradGraph(self.fn, args, self.warmup)
            else:
                graphed = _ForwardGraph(self.fn, args, self.warmup)
            self.graphs[key] = graphed
        return graphed

    def __call__(self, *args):
        if all(t.device.type == "cpu" for t in _tensors(args)):
            return self.fn(*args)
        return self.prepare(args)(*args)


class _ForwardGraph:
    """A capture, without autograd, over static copies of the call's
    tensors. Warm-up runs eagerly on the arguments it was prepared on;
    every call, the first included, copies its own arguments in and
    replays."""

    def __init__(self, fn, args, warmup: int):
        with torch.no_grad():
            for _ in range(warmup):
                fn(*args)
            self.static = tree_map(lambda t: t.clone() if isinstance(
                t, torch.Tensor) else t, args)
            self.step = CapturedStep(lambda: fn(*self.static),
                                     "make_graphed_callables")

    def __call__(self, *args):
        for dst, src in zip(_tensors(self.static), _tensors(args)):
            dst.copy_(src)
        self.step.replay()
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, self.step.output)


class _CountBackward(torch.autograd.Function):
    """Identity on the graphed forward's outputs whose backward adds the
    backward graph's launches to the counter."""

    @staticmethod
    def forward(ctx, launches, *outs):
        ctx.launches = launches
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        _build.LAUNCHES.update(ctx.launches)
        return (None, *grads)


class _Counted(torch.nn.Module):
    """``fn`` (a module's parameters included) with the launches of its
    last call kept in ``launches``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.launches = collections.Counter()
        self.calls = 0

    def forward(self, *args):
        before = collections.Counter(_build.LAUNCHES)
        out = self.fn(*args)
        self.launches = _build.LAUNCHES - before
        self.calls += 1
        return out


class _AutogradGraph:
    """``torch.cuda.make_graphed_callables`` (forward and backward graphs)
    on one signature; every argument must be a tensor. Its eager warm-ups
    and its captures count no launches: each forward replay adds the
    forward's share of one warm-up iteration, and each backward the
    rest."""

    def __init__(self, fn, args, warmup: int):
        counted = _Counted(fn)
        before = collections.Counter(_build.LAUNCHES)
        try:
            self.graphed = torch.cuda.make_graphed_callables(
                counted, args, num_warmup_iters=warmup)
        except RuntimeError as exc:
            raise RuntimeError(f"make_graphed_callables cannot capture "
                               f"{fn!r}: {_cause(exc)}") from exc
        finally:
            total = _build.LAUNCHES - before
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)
        self.fwd = counted.launches
        self.bwd = +collections.Counter(
            {k: n // counted.calls - self.fwd[k] for k, n in total.items()})
        CAPTURES["make_graphed_callables"] += 1

    def __call__(self, *args):
        out = self.graphed(*args)
        _build.LAUNCHES.update(self.fwd)
        if not self.bwd:
            return out
        single = isinstance(out, torch.Tensor)
        outs = _CountBackward.apply(self.bwd, *((out,) if single else out))
        return outs[0] if single else type(out)(outs)


def make_graphed_callables(
    callables: Union[Callable, Sequence[Callable]],
    sample_args: Union[Tuple, Sequence[Tuple]] = (),
    num_warmup_iters: int = 0,
    **_ignored,
):
    """Graphed forms of ``callables`` (a callable, or a sequence of them
    given back as a tuple), the reference's signature. ``sample_args``
    (a tuple, or one tuple per callable) captures at once; otherwise each
    callable captures at its first call on card tensors.
    ``num_warmup_iters`` eager runs (at least one) precede a capture;
    other keywords of the upstream API are accepted and ignored."""
    single = callable(callables)
    fns = [callables] if single else list(callables)
    args_list = [sample_args] if single else list(sample_args)
    out = []
    for fn, args in zip(fns, args_list or [()] * len(fns)):
        graphed = _Graphed(fn, num_warmup_iters)
        if args and not all(t.device.type == "cpu" for t in _tensors(args)):
            graphed.prepare(args)
        out.append(graphed)
    return out[0] if single else tuple(out)
