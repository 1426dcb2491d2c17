"""Serving from FP8-block resident weights in the port against the JAX
package: ``generate`` on LLAMA_TINY from each of the three forms
(``"bf16"``, ``"quantized"`` with the default 128 x 128 weight tiles,
dequantized at every call, and ``"quantized"`` with 1 x 128 weight
blocks on ``decode_kn_matvec``) against the reference's greedy tokens,
every resident byte equal; the 1 x 128 form's bf16 block scales with
power-of-two scales and without, against the reference's
``BlockResidentKernel.dequantize_kn``; and NVFP4's 16 x 16
``"quantized"`` form against ``prequantize_kernel_array``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.common.recipe import QParams as JQParams
from transformerengine_tpu.inference import generate as j_generate
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.ops import gemm as j_gemm
from transformerengine_tpu.quantize.prequant import (
    prequantize_kernel_array as j_prequantize_array,
    prequantize_kernels as j_prequantize)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import Float8BlockScaling
from transformerengine_tpu_torch.inference import generate
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)
from transformerengine_tpu_torch.ops import decode_matmul as dm
from transformerengine_tpu_torch.ops import gemm
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.prequant import (
    BlockResidentKernel, PrequantizedKernel, prequantize_kernel_array,
    prequantize_kernels)
from transformerengine_tpu_torch.quantize.quantizer import QuantizeLayout
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode

torch.set_num_threads(2)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


GB, GS, NEW = 4, 16, 6
FORMS = {"bf16": ({}, "bf16"), "quantized_2d": ({}, "quantized"),
         "quantized_1d": (dict(w_block_scaling_dim=1), "quantized")}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fp8_block_resident_generate_matches_jax(form, monkeypatch):
    """LLAMA_TINY in f32 prequantized in one FP8-block form on both sides:
    every resident buffer byte for byte equal to the reference's prequant
    collection (every tile's exponent inside -12..12), and the greedy
    tokens of ``generate`` equal; the 1 x 128 form's decode GEMMs reach
    ``decode_kn_matvec`` at block 128 (its plain version here), the
    128 x 128 form's none (its weights dequantized at each call)."""
    kw, mode = FORMS[form]
    cfg_j = dataclasses.replace(J_TINY, dtype=jnp.float32)
    jm = JLlama(config=cfg_j)
    variables = jm.init(jax.random.PRNGKey(7), jnp.ones((1, GS), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    params["embedding"] = (params["embedding"] * 0.02).astype(np.float32)
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", mode)
    jvars = j_prequantize({"params": params}, te.Float8BlockScaling(**kw))
    monkeypatch.delenv("TE_TPU_BLOCK_DECODE")
    cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu", seed=3)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    prequantize_kernels(model, Float8BlockScaling(**kw), block_decode=mode)
    pks = {n: m for n, m in model.named_modules()
           if isinstance(m, PrequantizedKernel)}
    assert len(pks) == 4 * cfg.num_layers
    for name, pk in pks.items():
        leaf = jvars["prequant"]
        for part in name.replace("layers.", "layer_").split("."):
            leaf = leaf[part]
        cw = leaf.colwise
        if form == "quantized_1d":
            assert isinstance(pk.kn, BlockResidentKernel)
            assert pk.kn.block == cw.block == 128 and not pk.kn.packed
            np.testing.assert_array_equal(_bytes(pk.kn.payload),
                                          _bytes(cw.payload), name)
            np.testing.assert_array_equal(_bytes(pk.kn.scale),
                                          _bytes(cw.scale), name)
        elif form == "quantized_2d":
            assert pk.kn is None and pk.scaling_mode is \
                ScalingMode.BLOCK_SCALING_2D
            np.testing.assert_array_equal(_bytes(pk.data), _bytes(cw.data))
            np.testing.assert_array_equal(pk.scale_inv.numpy(),
                                          np.asarray(cw.scale_inv))
            np.testing.assert_array_equal(
                np.log2(pk.scale_inv.numpy()) % 1, 0)
        else:
            assert pk.kn is None and pk.data.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bytes(pk.data), _bytes(cw), name)

    rng = np.random.default_rng(2)
    tok = rng.integers(1, 256, (GB, GS)).astype(np.int32)
    lens = rng.integers(GS // 2, GS + 1, GB).astype(np.int32)
    jt = np.array(j_generate(jm, jvars, jnp.asarray(tok), jnp.asarray(lens),
                             NEW, kv_cache_dtype=jnp.float32))
    calls = []
    real = gemm.decode_kn_matvec
    monkeypatch.setattr(gemm, "use_decode_matvec", lambda m, n, k: m <= GB)
    monkeypatch.setattr(gemm, "decode_kn_matvec",
                        lambda *a, **k: calls.append(k["block"])
                        or real(*a, **k))
    monkeypatch.setattr(gemm, "decode_tn_matvec", lambda *a, **k: (
        calls.append("tn") or dm.decode_tn_matvec(*a, **k)))
    got = generate(model, torch.from_numpy(tok), torch.from_numpy(lens), NEW,
                   kv_cache_dtype=torch.float32, device="cpu").numpy()
    np.testing.assert_array_equal(got, jt)
    steps = 4 * cfg.num_layers * (NEW - 1)
    assert calls == {"bf16": ["tn"] * steps, "quantized_2d": [],
                     "quantized_1d": [128] * steps}[form]


@pytest.mark.parametrize("pow2", [True, False])
def test_fp8_block_kn_scales_round_like_the_reference(pow2, monkeypatch):
    """The 1 x 128 ``"quantized"`` form stores its f32 block scales as
    bf16 (exact only for powers of two) and multiplies in bf16, as the
    reference's ``BlockResidentKernel``: the stored bytes, the
    dequantized (K, N) weight and the decode product against the
    reference's."""
    rng = np.random.default_rng(8)
    kj = jnp.asarray(rng.standard_normal((256, 384)) * 0.3, jnp.bfloat16)
    kt = torch.from_numpy(np.asarray(kj, np.float32)).to(torch.bfloat16)
    recipe_kw = dict(w_block_scaling_dim=1, force_pow_2_scales=pow2)
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", "quantized")
    ref = j_prequantize_array(kj, te.Float8BlockScaling(**recipe_kw)).colwise
    got = prequantize_kernel_array(kt, Float8BlockScaling(**recipe_kw),
                                   "quantized").kn
    np.testing.assert_array_equal(_bytes(got.payload), _bytes(ref.payload))
    np.testing.assert_array_equal(_bytes(got.scale), _bytes(ref.scale))
    f32 = QuantizerFactory.create(Float8BlockScaling(**recipe_kw), "kernel",
                                  QuantizeLayout.COLWISE).quantize(kt)
    exact = got.scale.float() == f32.scale_inv.t()
    assert bool(exact.all()) == pow2
    np.testing.assert_array_equal(_bytes(got.dequantize_kn()),
                                  _bytes(ref.dequantize_kn()))
    x = rng.standard_normal((8, 256)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    out_j = np.asarray(j_gemm.block_resident_dot(xj, ref), np.float32)
    out_t = gemm.block_resident_dot(xt, got).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())


def test_nvfp4_2d_quantized_prequant_matches_jax(monkeypatch):
    """NVFP4 with 16 x 16 weight blocks in the ``"quantized"`` form: the
    (N, K) e2m1 values in e4m3 bytes, their e4m3 block scales and the
    tensor scale, byte for byte the reference's, and the GEMM against it
    (dequantized at each call) the reference's ``resident_dot``."""
    two_d = dict(fp4_quant_fwd_weight=tt.QParams(fp4_2d_quantization=True))
    rng = np.random.default_rng(9)
    kj = jnp.asarray(rng.standard_normal((256, 192)) * 0.1, jnp.bfloat16)
    kt = torch.from_numpy(np.asarray(kj, np.float32)).to(torch.bfloat16)
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", "quantized")
    ref = j_prequantize_array(kj, te.NVFP4BlockScaling(
        fp4_quant_fwd_weight=JQParams(fp4_2d_quantization=True))).colwise
    got = prequantize_kernel_array(kt, tt.NVFP4BlockScaling(**two_d),
                                   "quantized")
    assert got.kn is None and got.scaling_mode is \
        ScalingMode.NVFP4_2D_SCALING
    cw = got.colwise
    np.testing.assert_array_equal(_bytes(cw.data), _bytes(ref.data))
    np.testing.assert_array_equal(_bytes(cw.scale_inv), _bytes(ref.scale_inv))
    np.testing.assert_array_equal(cw.tensor_scale_inv.numpy(),
                                  np.asarray(ref.tensor_scale_inv))
    x = rng.standard_normal((8, 256)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    out_j = np.asarray(j_gemm.resident_dot(xj, ref), np.float32)
    out_t = gemm.resident_dot(xt, cw).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())
