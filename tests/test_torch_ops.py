"""The port's norm, activation, RoPE, fused layers and KV-cache helpers
against the JAX package, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.inference import kv_cache as jkv
from transformerengine_tpu.layernorm_dense import layernorm_dense as j_ln_dense
from transformerengine_tpu.layernorm_mlp import layernorm_mlp as j_ln_mlp
from transformerengine_tpu.ops.activation import act_lu as j_act_lu
from transformerengine_tpu.ops.normalization import rmsnorm_fwd as j_rmsnorm
from transformerengine_tpu.ops.rope import (
    apply_rope as j_apply_rope, rope_frequencies as j_rope_freqs)
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu_torch.inference import kv_cache as tkv
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.ops.activation import act_lu, swiglu
from transformerengine_tpu_torch.ops.normalization import rmsnorm_fwd
from transformerengine_tpu_torch.ops.rope import apply_rope, rope_frequencies

torch.set_num_threads(2)

_T = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(x: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_T[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_fwd(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((3, 5, 64)) * 4, dtype)
    g = rng.standard_normal(64).astype(np.float32)
    oj, rj = j_rmsnorm(xj, jnp.asarray(g), epsilon=1e-5)
    ot, rt = rmsnorm_fwd(xt, torch.from_numpy(g), epsilon=1e-5)
    assert ot.dtype == _T[dtype]
    # f32 statistics on both sides; a bf16 output may round one ulp apart.
    tol = 1e-5 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    np.testing.assert_allclose(rt.numpy(), _np(rj), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_swiglu_gates_the_first_half(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((4, 7, 2, 48)) * 3, dtype)
    oj = j_act_lu(xj, "swiglu")
    ot = swiglu(xt)
    assert ot.shape == (4, 7, 48) and ot.dtype == _T[dtype]
    tol = 1e-6 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    # SiLU goes to x[..., 0, :]; x[..., 1, :] is the linear gate.
    x0, x1 = xt[..., 0, :].float(), xt[..., 1, :].float()
    np.testing.assert_allclose(
        _np(act_lu(xt, ("silu", "linear"))),
        _np((x0 * torch.sigmoid(x0) * x1).to(_T[dtype])), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rope_with_positions(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 6, 3, 32)), dtype)
    pos = np.array([[0, 1, 2, 3, 4, 5], [100, 101, 102, 7000, 7001, 8191]],
                   np.int32)
    fj = j_rope_freqs(32, 8192, base=500000.0)
    ft = rope_frequencies(32, 8192, base=500000.0)
    np.testing.assert_allclose(ft.numpy(), _np(fj), rtol=1e-6)
    for p_j, p_t in ((None, None), (jnp.asarray(pos), torch.from_numpy(pos))):
        oj = j_apply_rope(xj, fj, positions=p_j)
        ot = apply_rope(xt, ft, positions=p_t)
        # cos/sin of phases up to 8191 rad agree to a few f32 ulps.
        tol = 2e-5 if dtype == jnp.float32 else 1e-2
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_dense_and_mlp(dtype):
    rng = np.random.default_rng(3)
    h, ffn = 64, 96
    xj, xt = _pair(rng.standard_normal((2, 5, h)), dtype)
    g = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    kj, kt = _pair(rng.standard_normal((h, 80)) / 8, dtype)
    w1j, w1t = _pair(rng.standard_normal((h, 2, ffn)) / 8, dtype)
    w2j, w2t = _pair(rng.standard_normal((ffn, h)) / 10, dtype)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    dj = j_ln_dense(xj, kj, jnp.asarray(g), norm_type="rmsnorm")
    dt = layernorm_dense(xt, kt, torch.from_numpy(g))
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=tol, atol=tol)
    mj = j_ln_mlp(xj, jnp.asarray(g), None, w1j, w2j, norm_type="rmsnorm",
                  activation_type="swiglu")
    mt = layernorm_mlp(xt, torch.from_numpy(g), w1t, w2t,
                       activation_type="swiglu")
    assert mt.dtype == _T[dtype]
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=tol, atol=tol)


@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_scale_calibration_and_quantize(per_slot):
    rng = np.random.default_rng(4)
    k = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 16)).astype(np.float32) * 5
    k[1] = 0.0
    v[1] = 0.0                       # an all-zero slot keeps scale 1
    sj = jkv.calibrate_kv_scale(jnp.asarray(k), jnp.asarray(v),
                                per_slot=per_slot)
    st = tkv.calibrate_kv_scale(torch.from_numpy(k), torch.from_numpy(v),
                                per_slot=per_slot)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    qj = jkv.quantize_for_cache(jnp.asarray(v), sj, j_e4m3)
    qt = tkv.quantize_for_cache(torch.from_numpy(v), st, torch.float8_e4m3fn)
    np.testing.assert_array_equal(np.asarray(qj).view(np.uint8),
                                  qt.view(torch.uint8).numpy())


@pytest.mark.parametrize("cache_dtype", ["fp8", "bf16"])
def test_cache_append_prefill_then_decode(cache_dtype):
    rng = np.random.default_rng(5)
    b, s_max, hkv, d = 2, 16, 2, 8
    jd, td = ((j_e4m3, torch.float8_e4m3fn) if cache_dtype == "fp8"
              else (jnp.bfloat16, torch.bfloat16))
    ip = tkv.InferenceParams(b, s_max, td)
    cache = tkv.KVCache.allocate(ip, hkv, d, "cpu")
    assert cache.k.shape == (b, 128, hkv, d)        # allocated at 128s
    ck = jnp.zeros(cache.k.shape, jd)
    cv = jnp.zeros(cache.k.shape, jd)
    lj = jnp.zeros((b,), jnp.int32)
    scale = np.array([2.0, 0.5], np.float32)
    for s_new in (5, 1, 1):
        kn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((b, s_new, hkv, d)).astype(np.float32)
        ck, cv, lj = jkv.cache_append(ck, cv, lj, jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(scale))
        tkv.cache_append(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(scale))
        np.testing.assert_array_equal(np.asarray(lj), cache.length.numpy())
        for a, t in ((ck, cache.k), (cv, cache.v)):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          t.float().numpy())
