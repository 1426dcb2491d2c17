"""Kernel caches through ``layernorm_mlp``, ``grouped_dense`` and ``moe``
(the rest of the JAX package's ``tests/test_microbatch.py``): the cached
port against the uncached port bit for bit and against the reference's
cached functions. It imports ``test_torch_microbatch.py``'s helpers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.grouped_dense import grouped_dense as j_grouped
from transformerengine_tpu.moe import moe as j_moe
from transformerengine_tpu.quantize.microbatch import (
    quantize_grouped_kernel as j_qgk, quantize_kernel as j_qk)
from transformerengine_tpu_torch.grouped_dense import grouped_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.moe import moe
from transformerengine_tpu_torch.quantize.microbatch import (
    quantize_grouped_kernel, quantize_kernel)

from test_torch_microbatch import _close, _grads, _pair, _sets

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["delayed", "mxfp8", "fp8block"])
def test_layernorm_mlp_cached_matches_uncached(name):
    js, ts = _sets(name, 2)
    rng = np.random.default_rng(5)
    h, f = 128, 256
    xj, xt = _pair(rng.standard_normal((32, h)))
    w1j, w1t = _pair(rng.standard_normal((h, 2, f)) * 0.05)
    w2j, w2t = _pair(rng.standard_normal((f, h)) * 0.05)
    gamma = torch.ones(h)

    def loss(caches):
        return lambda x, w1, w2: layernorm_mlp(
            x, gamma, w1, w2, norm_type="rmsnorm",
            activation_type=("silu", "linear"), quantizer_sets=tuple(ts),
            kernel_caches=caches).float().sum()

    caches = (quantize_kernel(w1t, ts[0])[0], quantize_kernel(w2t, ts[1])[0])
    d0 = _grads(loss(None), xt, w1t, w2t, sets=ts)
    d1 = _grads(loss(caches), xt, w1t, w2t, sets=ts)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)
    jcaches = (j_qk(w1j, js[0])[0], j_qk(w2j, js[1])[0])

    def jloss(x, w1, w2):
        return jnp.sum(te.layernorm_mlp(
            x, jnp.ones((h,), jnp.float32), None, w1, w2,
            norm_type="rmsnorm", activation_type=("silu", "linear"),
            quantizer_sets=tuple(js), kernel_caches=jcaches
        ).astype(jnp.float32))
    for got, ref in zip(d1, jax.grad(jloss, (0, 1, 2))(xj, w1j, w2j)):
        _close(got, ref)


@pytest.mark.parametrize("name", ["current", "mxfp8", "fp8block"])
def test_grouped_dense_cached(name):
    (js,), (ts,) = _sets(name)
    e, k, m, n = 2, 64, 128, 96
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.standard_normal((n, k)))
    wj, wt = _pair(rng.standard_normal((e, k, m)) * 0.05)
    sizes = [32, 64]
    gs = jnp.asarray(sizes, jnp.int32)

    def loss(c):
        return lambda x, w: grouped_dense(x, w, sizes, quantizer_set=ts,
                                          kernel_cache=c).float().sum()
    cache, _ = quantize_grouped_kernel(wt, ts)
    d0 = _grads(loss(None), xt, wt)
    d1 = _grads(loss(cache), xt, wt)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)
    jc, _ = j_qgk(wj, js)

    def jloss(x, w):
        return jnp.sum(j_grouped(x, w, gs, quantizer_set=js,
                                 kernel_cache=jc).astype(jnp.float32))
    for got, ref in zip(d1, jax.grad(jloss, (0, 1))(xj, wj)):
        _close(got, ref)


def test_moe_with_kernel_caches():
    js, ts = _sets("mxfp8", 2)
    rng = np.random.default_rng(7)
    t, h, f, e = 64, 64, 96, 4
    xj, xt = _pair(rng.standard_normal((t, h)))
    router = (rng.standard_normal((h, e)) * 0.1).astype(np.float32)
    uj, ut = _pair(rng.standard_normal((e, h, 2 * f)) * 0.05)
    dj, dt = _pair(rng.standard_normal((e, f, h)) * 0.05)
    rt = torch.from_numpy(router)
    caches = (quantize_grouped_kernel(ut, ts[0])[0],
              quantize_grouped_kernel(dt, ts[1])[0])
    with torch.no_grad():
        y0, a0 = moe(xt, rt, ut, dt, quantizer_sets=tuple(ts))
        y1, a1 = moe(xt, rt, ut, dt, quantizer_sets=tuple(ts),
                     kernel_caches=caches)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    jc = (j_qgk(uj, js[0])[0], j_qgk(dj, js[1])[0])
    yj, aj = j_moe(xj, jnp.asarray(router), uj, dj, quantizer_sets=tuple(js),
                   kernel_caches=jc)
    _close(y1, yj, "out")
    np.testing.assert_allclose(float(a1), float(aj), rtol=1e-6)
