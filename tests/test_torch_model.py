"""The port's Llama model and generation engine against the JAX package on
LLAMA_TINY, with the reference's own weights loaded through
``load_flax_params``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.attention import SequenceDescriptor as JDesc
from transformerengine_tpu.inference import generate as j_generate
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu.quantize.prequant import (
    prequantize_kernels as j_prequantize)
from transformerengine_tpu_torch import Float8CurrentScaling, autocast
from transformerengine_tpu_torch.attention import SequenceDescriptor
from transformerengine_tpu_torch.inference import (
    InferenceParams, KVCache, generate)
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)
from transformerengine_tpu_torch.quantize.prequant import prequantize_kernels

torch.set_num_threads(2)

B, S, NEW = 2, 16, 8
LENS = np.array([16, 11], np.int32)


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    """The reference model and its weights as numpy arrays, initialised
    once per dtype. The embedding is drawn with stddev 0.02 (the usual
    Llama init) instead of the reference's 1.0: with stddev-1 tied
    embeddings every greedy step repeats the previous token, which would
    make the generation tests pass on any model."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jm = JLlama(config=dataclasses.replace(J_TINY, dtype=jdt))
    variables = jm.init(jax.random.PRNGKey(1), jnp.ones((1, S), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    emb = params["embedding"]
    params["embedding"] = (emb.astype(np.float32) * 0.02).astype(emb.dtype)
    return jm, params


def _models(dtype: str):
    """The reference model and its variables, and a fresh port model with
    the same weights."""
    jm, params = _reference(dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cfg = dataclasses.replace(LLAMA_TINY, dtype=tdt)
    model = LlamaModel(cfg, device="cpu", seed=5)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    return jm, {"params": jax.tree.map(jnp.asarray, params)}, model


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)


def test_load_flax_params_covers_the_model():
    _, variables, model = _models("bf16")
    state = model.state_dict()
    names = set(load_flax_params(
        jax.tree.map(np.asarray, variables["params"]), LLAMA_TINY,
        device="cpu"))
    assert names == set(state)
    assert state["layers.1.mlp.wi_kernel"].shape == (128, 2, 256)
    assert state["layers.0.self_attention.qkv.scale"].dtype == torch.float32
    assert state["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_logits_match(dtype, padded):
    jm, variables, model = _models(dtype)
    tok = _tokens()
    desc_j = JDesc.from_seqlens(jnp.asarray(LENS)) if padded else None
    desc_t = (SequenceDescriptor.from_seqlens(torch.from_numpy(LENS))
              if padded else None)
    lj = np.asarray(jm.apply(variables, jnp.asarray(tok), desc_j))
    with torch.no_grad():
        lt = model(torch.from_numpy(tok), desc_t)
    assert lt.dtype == torch.float32 and lt.shape == (B, S, 256)
    # f32: summation order only. bf16: activations are rounded to bf16
    # after every op on both sides, and an order-dependent f32 sum can
    # round to the neighbouring bf16 value; one bf16 ulp (2^-8) of the
    # largest logit bounds what that leaves in the f32 logits.
    tol = (1e-5 if dtype == "f32" else 2 ** -8) * np.abs(lj).max()
    if padded:
        lj, lt = lj[1, :11], lt[1, :11]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj, np.float32),
                               rtol=0, atol=tol)


def _teacher_forced_logits(model, tok, ip, forced):
    """The port's logits at every generated position when the previous
    tokens are ``forced`` (B, NEW): the prompt's last position, then one
    decode step per forced token."""
    caches = [KVCache.allocate(ip, layer.self_attention.num_kv_heads,
                               layer.self_attention.head_dim, "cpu")
              for layer in model.layers]
    lens = torch.from_numpy(LENS)
    out = []
    with torch.no_grad():
        lg = model(torch.from_numpy(tok),
                   SequenceDescriptor.from_seqlens(lens), kv_caches=caches)
        for c in caches:
            c.length -= S - lens
        out.append(lg[torch.arange(B), (lens - 1).long()])
        for i in range(NEW - 1):
            step = torch.from_numpy(forced[:, i:i + 1].astype(np.int32))
            out.append(model(step, kv_caches=caches)[:, -1])
    return torch.stack(out, dim=1)


# The stated agreement for the low-precision cases. Greedy tokens must
# be identical, except at a step where the port's own logits hold a
# near-tie: there the reference's token may score up to this much
# (relative to the largest logit) below the port's top logit. The
# reason is the bf16 activations: the two packages sum in other orders,
# a sum can round to the neighbouring bf16 value, and that step of one
# bf16 ulp (2^-8 ~ 3.9e-3 relative) reaches the logits. (The f32 case
# has no such rounding and must agree exactly. On LLAMA_TINY the bf16
# case leaves the reference once, at a near-tie of 1.0e-3.)
_NEAR_TIE = 5e-3


@pytest.mark.parametrize("mode", ["f32", "bf16", "fp8"])
def test_generate_matches_jax(mode):
    jm, variables, model = _models("f32" if mode == "f32" else "bf16")
    tok = _tokens()
    jcache, tcache = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16),
                      "fp8": (j_e4m3, torch.float8_e4m3fn)}[mode]
    if mode != "f32":
        recipe = mode == "fp8"
        variables = j_prequantize(
            variables, te.Float8CurrentScaling() if recipe else None)
        prequantize_kernels(model, Float8CurrentScaling() if recipe else None)
    jt = np.array(j_generate(jm, variables, jnp.asarray(tok),
                               jnp.asarray(LENS), NEW,
                               kv_cache_dtype=jcache))
    tt = generate(model, torch.from_numpy(tok), torch.from_numpy(LENS), NEW,
                  kv_cache_dtype=tcache, device="cpu").numpy()
    assert tt.shape == (B, NEW) and tt.dtype == np.int32
    if mode == "f32":
        np.testing.assert_array_equal(tt, jt)
        return
    ip = InferenceParams(B, S + NEW, tcache)
    logits = _teacher_forced_logits(model, tok, ip, jt)
    # Along the reference's tokens, the port's greedy choice is the
    # reference's token or a near-tie with it at every step ...
    top = logits.max(dim=-1).values
    at_ref = logits.gather(-1, torch.from_numpy(jt).long()[..., None])[..., 0]
    gap = (top - at_ref) / logits.abs().amax(dim=-1)
    assert float(gap.max()) <= _NEAR_TIE, gap
    # ... and the engine's own greedy tokens are these argmaxes for as
    # long as they follow the reference, through the step that leaves it.
    picks = logits.argmax(dim=-1).numpy()
    for row in range(B):
        diff = np.nonzero(tt[row] != jt[row])[0]
        upto = int(diff[0]) + 1 if diff.size else NEW
        np.testing.assert_array_equal(tt[row, :upto], picks[row, :upto])


def test_prequantized_forward_under_autocast_matches_jax():
    """A prequantized model's forward under autocast(Float8CurrentScaling):
    each GEMM quantizes its activation with the recipe's x quantizer (a
    both-orientation quantizer, of which the product takes the rowwise
    usage) against the resident fp8 kernel, as the reference's
    ``prequant_dot`` does."""
    jm, variables, model = _models("bf16")
    tok = _tokens()
    variables = j_prequantize(variables, te.Float8CurrentScaling())
    prequantize_kernels(model, Float8CurrentScaling())
    with te.autocast(enabled=True, recipe=te.Float8CurrentScaling()):
        lj = np.asarray(jm.apply(variables, jnp.asarray(tok)), np.float32)
    with torch.no_grad(), autocast(recipe=Float8CurrentScaling()):
        lt = model(torch.from_numpy(tok))
    assert lt.shape == (B, S, 256) and bool(torch.isfinite(lt).all())
    # Equal fp8 payloads of the kernels; the activations' payloads follow
    # bf16 values that may round one ulp apart, as in the bf16 forward of
    # test_forward_logits_match (one bf16 ulp of the largest logit).
    # Readings 1.9e-7 of the largest logit.
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=2 ** -8 * np.abs(lj).max())
