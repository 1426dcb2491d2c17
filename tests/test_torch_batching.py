"""The port's ContinuousBatchingEngine (inference/batching.py) against the
JAX package's engine and its generate, on the CPU, with the reference's
LLAMA_TINY weights."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from transformerengine_tpu.inference import (
    ContinuousBatchingEngine as JEngine, InferenceParams as JIP,
    generate as j_generate)
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu_torch.inference import (
    ContinuousBatchingEngine, InferenceParams, generate)
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)

torch.set_num_threads(2)

P = 16
_DT = {"f32": (jnp.float32, torch.float32),
       "fp8": (j_e4m3, torch.float8_e4m3fn)}


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference LLAMA_TINY (f32) and its weights as numpy arrays, with
    the embedding at stddev 0.02 (tests/test_torch_model.py says why)."""
    jm = JLlama(config=dataclasses.replace(J_TINY, dtype=jnp.float32))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, P), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    params["embedding"] = params["embedding"] * np.float32(0.02)
    return jm, params


def _models():
    jm, params = _reference()
    cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu", seed=5)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    return jm, {"params": jax.tree.map(jnp.asarray, params)}, model


def _padded(prompt):
    toks = np.zeros((1, P), np.int32)
    toks[0, :len(prompt)] = prompt
    return toks


PROMPTS = [list(range(3, 3 + P)), list(range(40, 40 + 9)),
           list(range(101, 101 + P)), list(range(11, 11 + 7))]


@pytest.mark.parametrize("cache,fixed", [("f32", None), ("fp8", 0.08),
                                         ("fp8", None)])
def test_engine_matches_jax_engine_and_generate(cache, fixed):
    """More requests than slots (4 on 2): an f32 cache, an fp8 cache with
    ``fixed_kv_scale`` (one pinned scale) and an fp8 cache calibrated per
    slot at each admission (tests/test_inference.py
    TestContinuousBatching). Every request's tokens equal the JAX
    engine's, and the batch-1 generate of its prompt on both sides."""
    jm, variables, model = _models()
    jd, td = _DT[cache]
    new, b, max_seq = 5, 2, P + 5 + 8
    jeng = JEngine(jm, variables, max_batch_size=b,
                   max_sequence_length=max_seq, prompt_len=P,
                   max_new_tokens=new, kv_cache_dtype=jd,
                   fixed_kv_scale=fixed)
    teng = ContinuousBatchingEngine(
        model, max_batch_size=b, max_sequence_length=max_seq, prompt_len=P,
        max_new_tokens=new, kv_cache_dtype=td, fixed_kv_scale=fixed,
        device="cpu")
    jr = [jeng.submit(p) for p in PROMPTS]
    tr = [teng.submit(p) for p in PROMPTS]
    assert jr == tr
    jout, tout = jeng.run(), teng.run()
    assert sorted(tout) == sorted(tr)
    for rid, prompt in zip(tr, PROMPTS):
        assert tout[rid] == jout[rid], (rid, tout[rid], jout[rid])
        jip = JIP(1, max_seq, jd, fixed_kv_scale=fixed)
        ref = j_generate(jm, variables, jnp.asarray(_padded(prompt)),
                         jnp.asarray([len(prompt)], jnp.int32), new,
                         inference_params=jip)
        assert tout[rid] == [int(t) for t in ref[0]], rid
    # The port's own batch-1 generate gives the same tokens.
    for rid, prompt in zip(tr[:2], PROMPTS[:2]):
        ip = InferenceParams(1, max_seq, td, fixed_kv_scale=fixed)
        own = generate(model, torch.from_numpy(_padded(prompt)),
                       torch.tensor([len(prompt)]), new,
                       inference_params=ip, device="cpu")
        assert tout[rid] == own[0].tolist()


def test_idle_slot_passes_its_rows_without_writing_out_of_range():
    """Slot 1 serves one request and then idles while slot 0 serves one
    request after another: an idle slot keeps decoding, and its length
    grows by one a step past the cache's 128 rows. Its writes past the
    rows are dropped (an index past them would raise here and fault on
    the card; the last row keeps its value), and every request still gets
    the tokens of its own batch-1 generate."""
    _, _, model = _models()
    new, max_seq = 4, P + 4
    eng = ContinuousBatchingEngine(
        model, max_batch_size=2, max_sequence_length=max_seq, prompt_len=P,
        max_new_tokens=new, kv_cache_dtype=torch.float8_e4m3fn, device="cpu")
    s_alloc = eng.caches[0].k.shape[1]
    assert s_alloc == 128
    rng = np.random.default_rng(2)
    prompts = {}

    def submit():
        p = rng.integers(1, 256, int(rng.integers(4, P + 1))).tolist()
        prompts[eng.submit(p)] = p

    submit()
    submit()
    results = {}
    for _ in range(s_alloc + 40):
        done = eng.step()
        results.update(done)
        if done:            # one request at a time: it takes slot 0
            submit()
    assert eng.slot_req[1] is None
    assert int(eng.caches[0].length[1]) > s_alloc
    last_row = eng.caches[0].k[1, -1].clone()
    eng.step()
    assert torch.equal(eng.caches[0].k[1, -1], last_row)
    results.update(eng.run())
    assert len(results) == len(prompts) > s_alloc // new
    for rid in sorted(prompts)[::7]:
        p = prompts[rid]
        ref = generate(model, torch.from_numpy(_padded(p)),
                       torch.tensor([len(p)]), new,
                       kv_cache_dtype=torch.float8_e4m3fn, device="cpu")
        assert results[rid] == ref[0].tolist(), rid
