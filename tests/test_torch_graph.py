"""The port's ``make_graphed_callables`` (graph.py) against the JAX
package's on the reference's own cases, the launch accounting of a
captured step, and decode's returned tokens.

CUDA graphs exist only on the card. Here the callables run eagerly on
CPU tensors, as they must; the accounting is driven through a stand-in
for ``torch.cuda.CUDAGraph`` whose capture runs the step once in Python
(as a real capture does: the kernels are recorded, not run) and whose
replay runs nothing."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.graph import (
    make_graphed_callables as j_make_graphed_callables)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import _build, graph
from transformerengine_tpu_torch.inference import decode_steps, engine, prefill
from transformerengine_tpu_torch.inference import InferenceParams
from transformerengine_tpu_torch.models.llama import LLAMA_TINY, LlamaModel

torch.set_num_threads(2)


def test_single_callable_with_sample_args():
    """The reference's ``test_precompiles_and_runs``; keywords of the
    upstream API that neither side uses are accepted."""
    def f(x):
        return x * 2 + 1
    x = np.arange(4, dtype=np.float32)
    g = tt.make_graphed_callables(f, (torch.from_numpy(x),),
                                  num_warmup_iters=3, allow_unused_input=True)
    ref = j_make_graphed_callables(f, (jnp.asarray(x),), fp8_enabled=False)
    got = g(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(x)))
    np.testing.assert_array_equal(got.numpy(), x * 2 + 1)


def test_two_callables_in_a_list():
    """The reference's ``test_multiple``: a sequence in gives a tuple
    out, each callable with its own sample arguments."""
    fns = [lambda x: x + 1, lambda x: x * 3]
    x = np.full(2, 1.5, np.float32)
    got = tt.make_graphed_callables(fns, [(torch.from_numpy(x),)] * 2)
    ref = j_make_graphed_callables(fns, [(jnp.asarray(x),)] * 2)
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g(torch.from_numpy(x)).numpy(),
                                      np.asarray(r(jnp.asarray(x))))


def test_without_sample_args_and_gradients_on_the_cpu():
    """No sample arguments: the first call decides (CPU tensors run
    eagerly). An input that needs a gradient keeps its graph."""
    g = tt.make_graphed_callables(lambda a, b: (a * b, a + b))
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    prod, total = g(a, torch.tensor([3.0, 4.0]))
    (prod.sum() + total.sum()).backward()
    np.testing.assert_array_equal(a.grad.numpy(), [4.0, 5.0])


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` as far as the launch accounting sees it."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(_build, "LAUNCHES", _build.LAUNCHES.__class__(
        {"earlier": 2}))


def test_captured_step_adds_its_launches_at_each_replay(fake_graphs):
    """A capture counts nothing and leaves the earlier counts; each replay
    adds the capture's launches."""
    def step():
        _build.LAUNCHES["decode_attention"] += 1
        _build.LAUNCHES["decode_tn_matvec"] += 4
        return "out"
    captures = graph.CAPTURES["test"]
    gen = torch.Generator()
    s = graph.CapturedStep(step, "test", (gen,))
    assert s.output == "out" and s.graph.generators == [gen]
    assert graph.CAPTURES["test"] == captures + 1
    assert dict(_build.LAUNCHES) == {"earlier": 2}
    for _ in range(3):
        s.replay()
    assert s.graph.replays == 3
    assert dict(_build.LAUNCHES) == {"earlier": 2, "decode_attention": 3,
                                     "decode_tn_matvec": 12}


def test_a_failed_capture_names_its_cause(fake_graphs):
    def step():
        _build.LAUNCHES["decode_attention"] += 1
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    with pytest.raises(RuntimeError, match="decode_step cannot be captured.*"
                                           "not permitted"):
        graph.CapturedStep(step, "decode_step")
    assert dict(_build.LAUNCHES) == {"earlier": 2}


def test_decode_tokens_do_not_alias():
    """Each ``decode_steps`` call returns a tensor of its own: a later
    call on the same caches leaves the earlier tokens as they were."""
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=3)
    model.embedding.data.mul_(0.02)
    tokens = torch.randint(1, 256, (2, 12),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    ip = InferenceParams(2, 24)
    first, caches = prefill(model, tokens, ip, lengths, device="cpu")
    one = decode_steps(model, caches, first, 3, device="cpu")
    kept = one.clone()
    two = decode_steps(model, caches, one[:, -1], 3, device="cpu")
    assert one.shape == two.shape == (2, 3) and one.dtype == torch.int32
    assert one.data_ptr() != two.data_ptr()
    assert torch.equal(one, kept)
    # The same six steps in one call give the same tokens.
    first, caches = prefill(model, tokens, ip, lengths, device="cpu")
    six = decode_steps(model, caches, first, 6, device="cpu")
    assert torch.equal(six, torch.cat([one, two], dim=1))


class _Bump(torch.autograd.Function):
    """Counts one "fwd" launch forward and one "bwd" launch backward."""

    @staticmethod
    def forward(ctx, x):
        _build.LAUNCHES["fwd"] += 1
        return x * 2

    @staticmethod
    def backward(ctx, g):
        _build.LAUNCHES["bwd"] += 1
        return g * 2


def test_autograd_graph_splits_its_launches(fake_graphs, monkeypatch):
    """The autograd form counts nothing while PyTorch warms up and
    captures (a stand-in runs each warm-up's forward and backward, then
    the capture's, as ``torch.cuda.make_graphed_callables`` does); a
    forward replay adds the forward's launches and its backward the
    backward's."""
    def fake(module, args, num_warmup_iters):
        for _ in range(num_warmup_iters + 1):
            torch.autograd.grad(module(*args).sum(), args)
        return lambda *a: module.fn(*a).detach().requires_grad_()
    monkeypatch.setattr(torch.cuda, "make_graphed_callables", fake)
    x = torch.ones(3, requires_grad=True)
    g = graph._AutogradGraph(_Bump.apply, (x,), 2)
    assert dict(_build.LAUNCHES) == {"earlier": 2}
    assert dict(g.fwd) == {"fwd": 1} and dict(g.bwd) == {"bwd": 1}
    _build.LAUNCHES.clear()
    out = g(x)
    assert _build.LAUNCHES["fwd"] == 2      # the stand-in's own call too
    out.sum().backward()
    assert _build.LAUNCHES["bwd"] == 1


def test_forward_graph_answers_each_call_from_its_own_arguments(
        monkeypatch):
    """Captured on sample arguments, the forward form answers every call,
    the first included, from that call's own arguments, through the
    static copies, and returns tensors that the next call leaves as they
    were. The step runs eagerly here (CPU tensors have no graphs)."""
    real = graph.CapturedStep
    monkeypatch.setattr(graph, "CapturedStep",
                        lambda fn, name: real(fn, name, eager=True))
    rng = np.random.default_rng(5)
    sample, one, two = (torch.from_numpy(rng.standard_normal(6, np.float32))
                        for _ in range(3))
    g = graph._ForwardGraph(lambda x: (x * 2 + 1, x.sum()), (sample,), 2)
    first = g(one)
    kept = [t.clone() for t in first]
    second = g(two)
    for got, x in ((first, one), (second, two)):
        np.testing.assert_array_equal(got[0].numpy(), x.numpy() * 2 + 1)
        assert float(got[1]) == float(x.sum())
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert first[0].data_ptr() != g.step.output[0].data_ptr()


def _tiny_decode_setup():
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=3)
    model.embedding.data.mul_(0.02)
    tokens = torch.randint(1, 256, (2, 12),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    return model, tokens, lengths, InferenceParams(2, 32)


def test_decode_graph_follows_the_callers_generator():
    """A sampled decode keeps one step for its caches and structure, with
    the generator it draws from: a second call with that generator sets
    up nothing; a call with a new generator (a new seed) sets the step up
    anew in the old one's place and draws from the new generator, as the
    op-by-op loop does."""
    model, tokens, lengths, ip = _tiny_decode_setup()
    sampling = dict(temperature=0.7, top_k=40, top_p=1.0)
    mode = engine._sample_mode(**sampling)
    values = engine._sampling_tensors(*sampling.values(), "cpu")

    first, caches = prefill(model, tokens, ip, lengths, device="cpu")
    made = graph.CAPTURES["decode_step"]
    g1 = torch.Generator().manual_seed(1)
    got = [decode_steps(model, caches, first, 3, generator=g1,
                        device="cpu", **sampling)]
    got.append(decode_steps(model, caches, got[-1][:, -1], 2, generator=g1,
                            device="cpu", **sampling))
    assert graph.CAPTURES["decode_step"] == made + 1
    for seed in (2, 3):
        got.append(decode_steps(
            model, caches, got[-1][:, -1], 3, device="cpu",
            generator=torch.Generator().manual_seed(seed), **sampling))
    assert graph.CAPTURES["decode_step"] == made + 3
    assert len(caches.graphs) == 1
    got = torch.cat(got, dim=1)

    tok, caches = prefill(model, tokens, ip, lengths, device="cpu")
    want = []
    for seed, steps in ((1, 5), (2, 3), (3, 3)):
        gen = torch.Generator().manual_seed(seed)
        for _ in range(steps):
            tok = engine._decode_one(model, caches, tok, gen, values, mode)
            want.append(tok)
    assert torch.equal(got, torch.stack(want, dim=1))


def test_decode_refuses_a_plain_list():
    model, tokens, lengths, ip = _tiny_decode_setup()
    first, caches = prefill(model, tokens, ip, lengths, device="cpu")
    with pytest.raises(TypeError, match="CacheList"):
        decode_steps(model, list(caches), first, 2, device="cpu")
