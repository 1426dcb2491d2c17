"""Once-per-step kernel caches for gradient accumulation
(``quantize/microbatch.py``, ``nn.module.kernel_caches``): the port's
counterparts of every single-device case of the JAX package's
``tests/test_microbatch.py``, each held against the same function of the
reference where the reference runs it, and the cached port against the
uncached port bit for bit (``layernorm_mlp``, ``grouped_dense`` and
``moe`` in ``test_torch_microbatch_experts.py``). Expert parallelism (the
reference's ``test_moe_ep_kernel_caches``) is not ported.

The port writes a delayed-scaling update into the quantizers' tensors at
every backward; with a cache the kernel's observation rides the cache and
is written once, at the cache's first backward, so the kernel's history
rolls once per step (the reference's overwrite-with-gradient keeps one
microbatch's update, which carries the same roll)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.quantize.microbatch import (
    quantize_kernel as j_qk)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import autocast
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss)
from transformerengine_tpu_torch.nn import DenseGeneral, kernel_caches
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.microbatch import (
    KernelCache, quantize_kernel)
from transformerengine_tpu_torch.quantize.tensor import QDQKernel

torch.set_num_threads(2)

RECIPES = {
    "delayed": (te.DelayedScaling(amax_history_len=4),
                tt.DelayedScaling(amax_history_len=4)),
    "current": (te.Float8CurrentScaling(), tt.Float8CurrentScaling()),
    "mxfp8": (te.MXFP8BlockScaling(), tt.MXFP8BlockScaling()),
    "fp8block": (te.Float8BlockScaling(), tt.Float8BlockScaling()),
}
# The port against the reference: the same payload bytes and scales on
# both sides; only the f32 sums' order differs, so a bf16 result may
# round one ulp apart, which a chained GEMM passes on. Two ulps of the
# largest element.
RTOL = 2 ** -7


def _sets(name, n=1):
    j, t = RECIPES[name]
    return ([te.QuantizerFactory.create_set(j) for _ in range(n)],
            [QuantizerFactory.create_set(t) for _ in range(n)])


def _pair(a: np.ndarray, dtype=jnp.bfloat16):
    j = jnp.asarray(a).astype(dtype)
    return j, torch.tensor(np.asarray(j, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _data(seed, m=64, k=128, n=256):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((m, k))),
            _pair(rng.standard_normal((k, n)) * 0.05),
            _pair(rng.standard_normal((m, n))))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def _grads(fn, *args, sets=()):
    """The gradients of ``fn(*args)``, the delayed state of ``sets`` put
    back after the backward, so that each call starts alike (as each of
    the reference's functional calls does)."""
    saved = [(t, t.clone()) for qs in sets for q in (qs.x, qs.kernel, qs.dgrad)
             for t in (getattr(q, "scale", None),
                       getattr(q, "amax_history", None)) if t is not None]
    args = [a.clone().requires_grad_() for a in args]
    fn(*args).backward()
    for t, old in saved:
        t.copy_(old)
    return [a.grad for a in args]


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_cached_matches_uncached(name, monkeypatch):
    """The same gradients whether the kernel is quantized inside the layer
    or once through the cache, and the reference's cached gradients."""
    (js,), (ts,) = _sets(name)
    (xj, xt), (wj, wt), (gj, gt) = _data(0)
    cache, back = quantize_kernel(wt, ts)
    assert back is ts and isinstance(cache, KernelCache)
    assert isinstance(cache.q, QDQKernel) == (name in ("mxfp8", "fp8block"))
    calls = []
    for fn in ("cast_transpose", "mxfp8_quantize_2x", "mxfp8_quantize_1x"):
        real = getattr(qk, fn)
        monkeypatch.setattr(qk, fn, lambda *a, real=real, fn=fn, **k: (
            calls.append(fn), real(*a, **k))[1])

    def loss(cache):
        return lambda x, w: (dense(x, w, quantizer_set=ts, kernel_cache=cache
                                   ).float() * gt.float()).sum()

    d0 = _grads(loss(None), xt, wt, sets=(ts,))
    n0, calls[:] = len(calls), []
    d1 = _grads(loss(cache), xt, wt, sets=(ts,))
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)
    if name == "mxfp8":
        assert n0 - len(calls) == 1      # the kernel's 2x quantize
    jc, _ = j_qk(wj, js)

    def jloss(x, w):
        return jnp.sum(te.dense(x, w, quantizer_set=js, kernel_cache=jc
                                ).astype(jnp.float32) * gj.astype(jnp.float32))
    for got, ref, what in zip(d1, jax.grad(jloss, (0, 1))(xj, wj),
                              ("dx", "dw")):
        _close(got, ref, what)


def test_kernel_state_updates_once_per_step():
    """Delayed scaling: the cache-time weight amax rides the cache; two
    microbatches through it roll the kernel's history once, to the
    reference's update, while x and the gradient roll at each backward."""
    (js,), (ts,) = _sets("delayed")
    (xj, xt), (wj, wt), _ = _data(1)
    (_, x2t), _, _ = _data(7)
    cache, back = quantize_kernel(wt, ts)
    assert torch.equal(back.kernel.amax_history, torch.zeros(4))
    assert cache.amax is not None and float(cache.amax) > 0
    for x in (xt, x2t):
        dense(x.clone().requires_grad_(), wt, quantizer_set=ts,
              kernel_cache=cache).sum().backward()
    hist = ts.kernel.amax_history
    assert int((hist != 0).sum()) == 1 and float(hist[-1]) == \
        float(cache.amax)
    assert int((ts.x.amax_history != 0).sum()) == 2
    jc, _ = j_qk(wj, js)

    def f(qs):
        return jnp.sum(te.dense(xj, wj, quantizer_set=qs, kernel_cache=jc))
    upd = jax.vjp(f, js)[1](jnp.bfloat16(1.0))[0]
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(upd.kernel.amax_history))
    np.testing.assert_array_equal(ts.kernel.scale.numpy(),
                                  np.asarray(upd.kernel.scale))


@pytest.mark.parametrize("name", ["delayed", "mxfp8", "fp8block"])
def test_layernorm_dense_cached(name):
    (js,), (ts,) = _sets(name)
    (xj, xt), (wj, wt), (gj, gt) = _data(4)
    gamma = torch.ones(128)

    def loss(cache):
        return lambda x, w: (layernorm_dense(
            x, w, gamma, norm_type="rmsnorm", quantizer_set=ts,
            kernel_cache=cache).float() * gt.float()).sum()

    cache, _ = quantize_kernel(wt, ts)
    d0 = _grads(loss(None), xt, wt, sets=(ts,))
    d1 = _grads(loss(cache), xt, wt, sets=(ts,))
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)
    jc, _ = j_qk(wj, js)

    def jloss(x, w):
        return jnp.sum(te.layernorm_dense(
            x, w, jnp.ones((128,), jnp.float32), norm_type="rmsnorm",
            quantizer_set=js, kernel_cache=jc).astype(jnp.float32)
            * gj.astype(jnp.float32))
    for got, ref in zip(d1, jax.grad(jloss, (0, 1))(xj, wj)):
        _close(got, ref)


def test_module_kernel_cache(monkeypatch):
    """The module form of the reference's ``kernel_cache`` collection:
    none outside ``kernel_caches``, none built at construction; the first
    call inside builds it (one kernel quantize), later calls reuse it (no
    kernel quantize) with the same output bits, gradients reach the
    kernel, and the block's end drops it. Against the reference's
    collection-backed DenseGeneral on the same weights."""
    from transformerengine_tpu.flax import DenseGeneral as JDense
    calls = []
    real = qk.mxfp8_quantize_2x
    monkeypatch.setattr(qk, "mxfp8_quantize_2x", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    model = DenseGeneral(128, 256, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    (xj, xt), _, _ = _data(2, m=32)
    recipe = tt.MXFP8BlockScaling()
    assert model._kernel_caches is None
    with autocast(recipe=recipe):
        plain = model(xt.clone().requires_grad_())
        n_plain, calls[:] = len(calls), []
        with kernel_caches(model):
            y0 = model(xt.clone().requires_grad_())
            n_build, calls[:] = len(calls), []
            y1 = model(xt.clone().requires_grad_())
            n_reuse = len(calls)
            assert set(model._kernel_caches) == {"kernel"}
            y1.float().sum().backward()
        assert model._kernel_caches is None
    assert n_plain == 2 and n_build == 2 and n_reuse == 1
    assert torch.equal(y0, y1) and torch.equal(y0, plain)
    assert model.kernel.grad.shape == (128, 256)
    jm = JDense(features=256, use_bias=False)
    with te.autocast(recipe=te.MXFP8BlockScaling()):
        v = jm.init(jax.random.PRNGKey(0), xj)
        v = {"params": {"kernel": jnp.asarray(
            model.kernel.detach().float().numpy()).astype(jnp.bfloat16)}}
        yj, mut = jm.apply(v, xj, mutable=["kernel_cache"])
        assert "kernel" in mut["kernel_cache"]
        yj1 = jm.apply({**v, **mut}, xj)
    assert jnp.array_equal(yj, yj1)
    _close(y1, yj1)
    with pytest.raises(RuntimeError, match="nest"):
        with kernel_caches(model), kernel_caches(model):
            pass


def test_cache_under_grad_accumulation():
    """Two microbatches reusing one cache: the accumulated kernel
    gradient equals the uncached accumulation bit for bit, and the
    reference's within the tolerance."""
    (js,), (ts,) = _sets("current")
    (x1j, x1t), (wj, wt), _ = _data(2)
    (x2j, x2t), _, _ = _data(3)
    cache, _ = quantize_kernel(wt, ts)

    def acc(c):
        w = wt.clone().requires_grad_()
        for x in (x1t, x2t):
            dense(x, w, quantizer_set=ts, kernel_cache=c).float().sum(
            ).backward()
        return w.grad
    got = acc(cache)
    assert torch.equal(got, acc(None))
    jc, _ = j_qk(wj, js)

    def mb(x):
        return jax.grad(lambda w: jnp.sum(te.dense(
            x, w, quantizer_set=js, kernel_cache=jc).astype(jnp.float32)))(
                wj)
    _close(got, mb(x1j).astype(jnp.float32) + mb(x2j).astype(jnp.float32))


@pytest.mark.parametrize("name", ["fp8block", "delayed"])
def test_model_accumulation_with_caches(name):
    """A 2-layer model's two microbatches inside ``kernel_caches`` against
    the same microbatches without it: every gradient bitwise equal, one
    cache per kernel; under delayed scaling (after a warm-up microbatch,
    so the kernel's scale is that of its own amax) each kernel's history
    rolls once in the block and twice without it."""
    recipe = RECIPES[name][1]
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 256, (2, 2, 64), generator=g,
                             dtype=torch.int32) for _ in range(3)]

    def step(m, toks):
        with autocast(recipe=recipe):
            cross_entropy_loss(m(toks[0]), toks[1]).backward()

    step(model, batches[0])
    other = copy.deepcopy(model)
    runs = {}
    for label, m in (("cached", model), ("plain", other)):
        m.zero_grad(set_to_none=True)
        if label == "cached":
            with kernel_caches(m):
                for toks in batches[1:]:
                    step(m, toks)
                n = sum(len(c._kernel_caches) for c in m.modules()
                        if getattr(c, "_kernel_caches", None))
                assert n == 4 * LLAMA_TINY.num_layers
        else:
            for toks in batches[1:]:
                step(m, toks)
        runs[label] = ({k: p.grad for k, p in m.named_parameters()},
                       dict(m.named_buffers()))
    for k, grad in runs["cached"][0].items():
        assert torch.equal(grad, runs["plain"][0][k]), k
    if name == "delayed":
        hists = [(k, b) for k, b in runs["cached"][1].items()
                 if k.endswith("_kernel_amax_history")]
        assert hists
        for k, b in hists:
            assert int((b != 0).sum()) == 2, k
            assert int((runs["plain"][1][k] != 0).sum()) == 3, k
