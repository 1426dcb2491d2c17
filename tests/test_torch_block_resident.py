"""The port's block-scaled resident weights against the JAX package, on
the CPU: ``decode_kn_matvec``'s plain version against the Pallas kernel
(interpret mode), MXFP8 prequantization in both resident forms against
``prequantize_kernel_array``, and LLAMA_TINY served from the reference's
own ``prequant`` collection.

XLA's CPU ``exp2`` is exact only for the exponents -12..12 (ROADMAP
Queue 3), so the prequantization is compared with the reference where
every block's exponent lies inside that range and held to an exact numpy
version of the MXFP8 rule where it does not (weights at stddev 0.02)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.inference import generate as j_generate
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.ops.decode_matmul import (
    decode_kn_matvec as j_kn_matvec)
from transformerengine_tpu.ops.gemm import (
    block_resident_dot as j_block_resident_dot)
from transformerengine_tpu.quantize.prequant import (
    BlockResidentKernel as JBlockResident,
    prequantize_kernel_array as j_prequantize_array,
    prequantize_kernels as j_prequantize)
from transformerengine_tpu_torch import MXFP8BlockScaling
from transformerengine_tpu_torch.inference import generate
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params, load_flax_state)
from transformerengine_tpu_torch.ops import decode_matmul as dm
from transformerengine_tpu_torch.ops import gemm
from transformerengine_tpu_torch.quantize.prequant import (
    BlockResidentKernel, PrequantizedKernel, prequantize_kernel_array)

torch.set_num_threads(2)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _kn_operands(rng, m, k, n, packed, block):
    """x (M, K) bf16; a (K, N) e4m3 payload with E8M0-derived bf16 scales
    (2^-10..2^4), or a (K/2, N) split-plane packed e2m1 payload built from
    random codes with e4m3-valued bf16 scales; a one-element out_scale
    for the packed form. As (JAX arrays, torch tensors)."""
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    if packed:
        codes = rng.integers(0, 16, (k, n))
        payload = (codes[:k // 2] | (codes[k // 2:] << 4)).astype(np.uint8)
        scale = rng.uniform(0.05, 4.0, (k // block, n)).astype(
            ml_dtypes.float8_e4m3fn).astype(np.float32)
        out_scale = np.array([0.37], np.float32)
        pj, pt = jnp.asarray(payload), torch.from_numpy(payload)
    else:
        payload = rng.standard_normal((k, n)).astype(
            ml_dtypes.float8_e4m3fn)
        scale = np.ldexp(1.0, rng.integers(-10, 5, (k // block, n))).astype(
            np.float32)
        out_scale = None
        pj = jnp.asarray(payload)
        pt = torch.from_numpy(payload.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    sj = jnp.asarray(scale, jnp.bfloat16)
    st = torch.from_numpy(scale).to(torch.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    oj = jnp.asarray(out_scale) if out_scale is not None else None
    ot = torch.from_numpy(out_scale) if out_scale is not None else None
    return (x, pj, sj, oj), (xt, pt, st, ot)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("packed,block", [(False, 32), (True, 16)])
def test_kn_matvec_plain_matches_pallas(m, packed, block):
    """The plain version against the Pallas ``decode_kn_matvec`` in
    interpret mode, unpacked (MXFP8-style) and packed. Both dequantize
    each weight to bf16 exactly and multiply bf16 operands with f32 sums,
    so they differ by the order of the f32 sums only: 1e-5 of the largest
    output (K = 512 terms)."""
    rng = np.random.default_rng(m)
    k, n = 512, 256
    (xj, pj, sj, oj), (xt, pt, st, ot) = _kn_operands(rng, m, k, n, packed,
                                                      block)
    ref = np.asarray(j_kn_matvec(xj, pj, sj, oj, block=block, packed=packed))
    got = dm.decode_kn_matvec(xt, pt, st, ot, block=block, packed=packed)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    plain = dm.decode_kn_matvec_plain(xt, pt, st, ot, block=block,
                                      packed=packed)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("packed", [False, True])
def test_block_resident_dot_routes_like_the_reference(packed, monkeypatch):
    """``block_resident_dot`` at a decode shape, the reference forced onto
    its Pallas kernel with TE_TPU_DECODE_MATVEC=1 (as
    tests/test_misc_api.py does): the port routes the same shape to
    ``decode_kn_matvec`` and matches to 1e-5 of the largest output; a
    prefill-sized M takes the dequantized bf16 GEMM on both sides."""
    monkeypatch.setenv("TE_TPU_DECODE_MATVEC", "1")
    rng = np.random.default_rng(7)
    k, n, block = 1024, 1024, 16 if packed else 32
    (xj, pj, sj, oj), (xt, pt, st, ot) = _kn_operands(rng, 8, k, n, packed,
                                                      block)
    jk = JBlockResident(payload=pj, scale=sj, out_scale=oj, block=block,
                        packed=packed, dq_dtype=jnp.bfloat16)
    tk = BlockResidentKernel(pt, st, ot, block, packed)
    assert (tk.k, tk.n) == (jk.k, jk.n) == (k, n)
    calls = []
    real = gemm.decode_kn_matvec
    monkeypatch.setattr(gemm, "decode_kn_matvec",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = np.asarray(j_block_resident_dot(xj, jk))
    got = gemm.block_resident_dot(xt, tk)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        tk.dequantize_kn().float().numpy(),
        np.asarray(jk.dequantize_kn(), np.float32))
    xl = jnp.asarray(rng.standard_normal((64, k)), jnp.bfloat16)
    xlt = torch.from_numpy(np.array(xl.astype(jnp.float32))).to(
        torch.bfloat16)
    monkeypatch.setenv("TE_TPU_DECODE_MATVEC", "0")
    ref = np.asarray(j_block_resident_dot(xl, jk))
    got = gemm.block_resident_dot(xlt, tk)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _np_mxfp8_colwise(k2d: np.ndarray):
    """The MXFP8 rule in exact numpy arithmetic, quantizing a (K, N)
    kernel along K: (e4m3 payload (N, K) as float32 values, biased E8M0
    exponents (N, K/32))."""
    x = k2d.T.astype(np.float32)
    r, c = x.shape
    amax = np.abs(x).reshape(r, c // 32, 32).max(axis=-1)
    e = (np.maximum(amax, np.float32(2.0 ** -126)).view(np.int32) >> 23) \
        - 127 - 8
    e = np.where(amax > 0, np.clip(e, -127, 127), 0)
    y = x * np.repeat(np.ldexp(np.float32(1.0), -e), 32, axis=1)
    data = np.clip(y, -448, 448).astype(ml_dtypes.float8_e4m3fn)
    return data, (e + 127).astype(np.uint8)


def _kernel(shape, std, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * std
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("mode", ["bf16", "quantized"])
@pytest.mark.parametrize("shape", [(256, 512), (128, 2, 256)])
def test_mxfp8_prequantization_bytes_match_jax(mode, shape, monkeypatch):
    """Both resident forms against the reference's
    ``prequantize_kernel_array`` under TE_TPU_BLOCK_DECODE: payload and
    scale bytes equal (``"quantized"``: the (K, N) e4m3 payload and the
    (K/32, N) bf16 scales; ``"bf16"``: the (N, K) bf16 weight). The
    kernel's stddev of 7 keeps every block exponent inside -12..12."""
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", mode)
    kj, kt = _kernel(shape, 7.0, 3)
    ref = j_prequantize_array(kj, te.MXFP8BlockScaling())
    got = prequantize_kernel_array(kt, MXFP8BlockScaling(), mode)
    assert isinstance(got, PrequantizedKernel)
    assert got.shape == ref.shape == shape
    if mode == "bf16":
        assert got.kn is None and got.scale_inv is None
        np.testing.assert_array_equal(_bytes(got.data), _bytes(ref.colwise))
        return
    kn, jkn = got.kn, ref.colwise
    assert got.data is None and not kn.packed and kn.block == jkn.block == 32
    assert kn.payload.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes(kn.payload), _bytes(jkn.payload))
    np.testing.assert_array_equal(_bytes(kn.scale), _bytes(jkn.scale))
    assert kn.out_scale is None and jkn.out_scale is None


@pytest.mark.parametrize("mode", ["bf16", "quantized"])
def test_mxfp8_prequantization_is_exact_where_xla_is_not(mode):
    """Weights at stddev 0.02 put block exponents at -13 and below, where
    XLA's CPU ``exp2`` is inexact: both resident forms hold to the exact
    numpy rule (payload bytes, and scales 2^(e - 127) in bf16)."""
    kj, kt = _kernel((256, 512), 0.02, 4)
    data, e = _np_mxfp8_colwise(np.asarray(kj.astype(jnp.float32)))
    assert (e.astype(int) - 127).min() <= -13
    scale = np.ldexp(np.float32(1.0), e.astype(np.int32) - 127)
    got = prequantize_kernel_array(kt, MXFP8BlockScaling(), mode)
    if mode == "bf16":
        want = (data.astype(np.float32) * np.repeat(scale, 32, axis=1))
        want = want.astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(_bytes(got.data), _bytes(want))
        return
    np.testing.assert_array_equal(_bytes(got.kn.payload),
                                  np.ascontiguousarray(data.T).view(np.uint8))
    np.testing.assert_array_equal(
        _bytes(got.kn.scale),
        np.ascontiguousarray(scale.T.astype(ml_dtypes.bfloat16)).view(
            np.uint8))


B, S, NEW = 2, 16, 8


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_served_from_the_reference_prequant_collection(dtype, monkeypatch):
    """LLAMA_TINY with the reference's MXFP8 ``"quantized"`` resident
    kernels, carried into the port by ``load_flax_params`` (``prequant=``)
    with the same payload bytes. The forward's logits agree to 1e-5 of
    the largest logit in f32 (sums in another order) and to one bf16 ulp
    (2^-8) in bf16, where the activations round one ulp apart as in
    test_torch_model.py. In f32 the greedy tokens equal the reference's
    generate; the port's decode GEMMs are routed to ``decode_kn_matvec``
    (its plain version here) at LLAMA_TINY's narrow widths. (In bf16 the
    generations part at a near-tie of 4.4e-4 of the largest logit, the
    bf16 rounding that test_torch_model.py's tolerance covers; the f32
    case shows the path itself.)"""
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", "quantized")
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JLlama(config=dataclasses.replace(J_TINY, dtype=jdt))
    variables = jm.init(jax.random.PRNGKey(1), jnp.ones((1, S), jnp.int32))
    params = fnn.meta.unbox(variables["params"])
    params["embedding"] = (params["embedding"].astype(jnp.float32)
                           * 0.02).astype(params["embedding"].dtype)
    jvars = j_prequantize({"params": params}, te.MXFP8BlockScaling())
    monkeypatch.delenv("TE_TPU_BLOCK_DECODE")
    params_np = jax.tree.map(np.asarray, jvars["params"])
    prequant_np = jax.tree.map(np.asarray, jvars["prequant"])
    cfg = dataclasses.replace(LLAMA_TINY, dtype=tdt)
    model = LlamaModel(cfg, device="cpu", seed=5)
    load_flax_state(model, load_flax_params(params_np, cfg, device="cpu",
                                            prequant=prequant_np))
    kn = model.layers[1].mlp.wi_kernel.kn
    jkn = jvars["prequant"]["layer_1"]["mlp"]["wi_kernel"].colwise
    np.testing.assert_array_equal(_bytes(kn.payload), _bytes(jkn.payload))
    np.testing.assert_array_equal(_bytes(kn.scale), _bytes(jkn.scale))
    assert sum(isinstance(m, BlockResidentKernel)
               for m in model.modules()) == 4 * cfg.num_layers

    tok = np.random.default_rng(0).integers(1, 256, (B, S)).astype(np.int32)
    lj = np.asarray(jm.apply(jvars, jnp.asarray(tok)), np.float32)
    with torch.no_grad():
        lt = model(torch.from_numpy(tok)).numpy()
    tol = 1e-5 if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(lt, lj, rtol=0, atol=tol * np.abs(lj).max())
    if dtype == "bf16":
        return

    calls = []
    real = gemm.decode_kn_matvec
    monkeypatch.setattr(gemm, "use_decode_matvec", lambda m, n, k: m <= B)
    monkeypatch.setattr(gemm, "decode_kn_matvec",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    lens = np.array([16, 11], np.int32)
    jt = np.array(j_generate(jm, jvars, jnp.asarray(tok), jnp.asarray(lens),
                             NEW, kv_cache_dtype=jnp.float32))
    tt = generate(model, torch.from_numpy(tok), torch.from_numpy(lens), NEW,
                  kv_cache_dtype=torch.float32, device="cpu").numpy()
    np.testing.assert_array_equal(tt, jt)
    assert len(calls) == 4 * cfg.num_layers * (NEW - 1)
