"""NVFP4-resident serving of LLAMA_TINY against the JAX package:
``prequantize_kernels`` in both ``block_decode`` forms against the
reference's under ``TE_TPU_BLOCK_DECODE`` (the same resident bytes:
packed e2m1 codes, bf16 block scales and the tensor scale as
``out_scale``, or the dequantized bf16 weight), and greedy ``generate``
under ``autocast(NVFP4BlockScaling())``, which quantizes every
activation before its GEMM, with the same tokens.

The reference quantizes the activation in both usages and keeps the
rowwise one; its colwise usage takes the RHT along the tokens, which
fails for a decode batch that is not a multiple of 16 (ROADMAP Queue 3).
The port does the same where 16 divides the rows and quantizes the
rowwise usage alone, the same values, elsewhere; the comparison of
``generate`` runs at B = 16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.inference import generate as j_generate
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.ops import gemm as jgemm
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
from transformerengine_tpu.quantize.prequant import (
    prequantize_kernel_array as j_prequantize_kernel_array,
    prequantize_kernels as j_prequantize)
from transformerengine_tpu.quantize.quantizer import QuantizeLayout as JLayout
from transformerengine_tpu_torch import NVFP4BlockScaling, autocast
from transformerengine_tpu_torch.inference import generate
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)
from transformerengine_tpu_torch.ops import decode_matmul as dm
from transformerengine_tpu_torch.ops import gemm
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.prequant import (
    BlockResidentKernel, PrequantizedKernel, prequantize_kernel_array,
    prequantize_kernels)

torch.set_num_threads(2)

B, S, NEW = 16, 16, 6


def _init(config):
    """The reference's initial weights (numpy), embedding at stddev 0.02:
    with the reference's stddev-1 tied embedding every greedy step
    repeats the previous token."""
    jm = JLlama(config=config)
    variables = jm.init(jax.random.PRNGKey(7), jnp.ones((1, S), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    emb = params["embedding"]
    params["embedding"] = (emb.astype(np.float32) * 0.02).astype(emb.dtype)
    return jm, params


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)



@pytest.mark.parametrize("mode", ["quantized", "bf16"])
def test_nvfp4_resident_generate_matches_jax(mode, monkeypatch):
    """LLAMA_TINY in f32, prequantized under NVFP4 on both sides: every
    resident buffer byte for byte equal to the reference's prequant
    collection ("quantized": the (K/2, N) packed codes, every kernel's K
    a multiple of 32), and the greedy tokens of ``generate`` under
    ``autocast(NVFP4BlockScaling())`` equal, the port's decode GEMMs
    routed to ``decode_kn_matvec``'s packed branch (its plain version
    here) at LLAMA_TINY's narrow widths in the "quantized" form."""
    cfg_j = dataclasses.replace(J_TINY, dtype=jnp.float32)
    jm, params = _init(cfg_j)
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", mode)
    jvars = j_prequantize({"params": params}, te.NVFP4BlockScaling())
    monkeypatch.delenv("TE_TPU_BLOCK_DECODE")
    cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu", seed=3)
    model.load_state_dict(load_flax_params(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))
    prequantize_kernels(model, NVFP4BlockScaling(), block_decode=mode)
    pks = {n: m for n, m in model.named_modules()
           if isinstance(m, PrequantizedKernel)}
    assert len(pks) == 4 * cfg.num_layers
    for name, pk in pks.items():
        path = name.replace("layers.", "layer_").split(".")
        leaf = jvars["prequant"]
        for part in path:
            leaf = leaf[part]
        cw = leaf.colwise
        if mode == "quantized":
            kn = pk.kn
            assert isinstance(kn, BlockResidentKernel) and kn.packed
            assert kn.payload.dtype == torch.uint8 and kn.block == 16
            np.testing.assert_array_equal(_bytes(kn.payload),
                                          _bytes(cw.payload), name)
            np.testing.assert_array_equal(_bytes(kn.scale), _bytes(cw.scale))
            np.testing.assert_array_equal(_bytes(kn.out_scale),
                                          _bytes(cw.out_scale).reshape(-1))
        else:
            assert pk.kn is None and pk.data.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bytes(pk.data), _bytes(cw), name)

    rng = np.random.default_rng(2)
    tok = rng.integers(1, 256, (B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, B).astype(np.int32)
    with te.autocast(enabled=True, recipe=te.NVFP4BlockScaling()):
        jt = np.array(j_generate(jm, jvars, jnp.asarray(tok),
                                 jnp.asarray(lens), NEW,
                                 kv_cache_dtype=jnp.float32))
    calls = []
    real = gemm.decode_kn_matvec
    monkeypatch.setattr(gemm, "use_decode_matvec", lambda m, n, k: m <= B)
    monkeypatch.setattr(gemm, "decode_kn_matvec",
                        lambda *a, **kw: calls.append(kw["packed"])
                        or real(*a, **kw))
    monkeypatch.setattr(gemm, "decode_tn_matvec", lambda *a, **kw: (
        calls.append("tn") or dm.decode_tn_matvec(*a, **kw)))
    with autocast(recipe=NVFP4BlockScaling()):
        tt = generate(model, torch.from_numpy(tok), torch.from_numpy(lens),
                      NEW, kv_cache_dtype=torch.float32, device="cpu").numpy()
    np.testing.assert_array_equal(tt, jt)
    if mode == "quantized":
        assert calls == [True] * (4 * cfg.num_layers * (NEW - 1))
    else:
        # The activation enters a plain GEMM against the bf16 weight.
        assert calls == []


@pytest.mark.parametrize("m", [16, 8])
def test_nvfp4_prequant_dot_activation_quantize(m, monkeypatch):
    """``prequant_dot`` against an NVFP4 "bf16" resident weight with the
    factory's activation quantizer (RHT on its colwise usage): where 16
    divides M the activation takes the reference's 2x quantize, one
    ``nvfp4_amax_2x`` and one ``nvfp4_quantize_2x`` (their plain versions
    here); at M = 8, a decode batch, the rowwise usage alone and no 2x
    call. Held against the reference's product, whose quantizer takes the
    rowwise layout at M = 8, where its 2x quantize fails; the products
    are exact, so only the order of the f32 sums over K differs: 1e-5 of
    the largest output."""
    rng = np.random.default_rng(4)
    k, n = 256, 512
    xj = jnp.asarray(rng.standard_normal((m, k))).astype(jnp.bfloat16)
    wj = (jnp.asarray(rng.standard_normal((k, n))) / 16).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(wj, np.float32)).to(torch.bfloat16)
    monkeypatch.setenv("TE_TPU_BLOCK_DECODE", "bf16")
    pj = j_prequantize_kernel_array(wj, te.NVFP4BlockScaling())
    pt = prequantize_kernel_array(wt, NVFP4BlockScaling(), block_decode="bf16")
    np.testing.assert_array_equal(_bytes(pt.colwise), _bytes(pj.colwise))
    qj = JFactory.create(te.NVFP4BlockScaling(), "x",
                         JLayout.ROWWISE_COLWISE if m % 16 == 0
                         else JLayout.ROWWISE)
    qt = QuantizerFactory.create(NVFP4BlockScaling(), "x")
    assert qt.with_rht
    calls = []
    for name in ("nvfp4_amax_2x", "nvfp4_quantize_2x"):
        real = getattr(qk, name)
        monkeypatch.setattr(qk, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append(_n) or _r(*a, **kw)))
    oj = np.asarray(jgemm.prequant_dot(xj, pj.colwise, qj), np.float32)
    ot = gemm.prequant_dot(xt, pt.colwise, qt)
    assert calls == (["nvfp4_amax_2x", "nvfp4_quantize_2x"] if m % 16 == 0
                     else [])
    assert ot.dtype == torch.float32 and ot.shape == (m, n)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-5 * np.abs(oj).max())
