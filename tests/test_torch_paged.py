"""The port's paged KV cache (inference/kv_cache.py), paged decode
attention (ops/paged_attention.py) and paged generation against the JAX
package, on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from transformerengine_tpu.inference import (
    InferenceParams as JIP, generate as j_generate)
from transformerengine_tpu.inference import kv_cache as jkv
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.ops.paged_attention import (
    paged_decode_attention as j_paged_attention)
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu_torch.inference import (
    InferenceParams, PagedKVCache, generate, prefill)
from transformerengine_tpu_torch.inference import kv_cache as tkv
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)
from transformerengine_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)

torch.set_num_threads(2)

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "fp8": (j_e4m3, torch.float8_e4m3fn)}


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _same_state(js, tc: PagedKVCache):
    np.testing.assert_array_equal(np.asarray(js.page_table),
                                  tc.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(js.lengths), tc.length.numpy())
    assert int(js.free_head) == int(tc.free_head)
    np.testing.assert_array_equal(_bytes(js.pages_k), _bytes(tc.pages_k))
    np.testing.assert_array_equal(_bytes(js.pages_v), _bytes(tc.pages_v))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("prompt", [0, 12])
def test_paged_cache_functions_match_jax(dtype, prompt):
    """Tables, free_head, lengths and payload bytes after an optional
    prompt and then 12 tokens, page 8: the reference's round trip
    (tests/test_inference.py TestPagedCache) and a prompt that the tokens
    carry onto a new page. Neither rewinds a length, so both allocation
    rules give the same table."""
    jd, td = _DT[dtype]
    b, hkv, d, page, mpps = 2, 2, 16, 8, 4
    rng = np.random.default_rng(0)
    js = jkv.paged_init(16, page, b, mpps, hkv, d, dtype=jd)
    tc = tkv.paged_init(16, page, b, mpps, hkv, d, dtype=td, device="cpu")
    scale = np.array([3.0, 0.25], np.float32) if dtype == "fp8" else None
    js_scale = jnp.asarray(scale) if scale is not None else None
    t_scale = torch.from_numpy(scale) if scale is not None else None
    if prompt:
        kn = rng.standard_normal((b, prompt, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((b, prompt, hkv, d)).astype(np.float32)
        js = jkv.paged_append_prompt(js, jnp.asarray(kn), jnp.asarray(vn),
                                     js_scale)
        tkv.paged_append_prompt(tc, torch.from_numpy(kn),
                                torch.from_numpy(vn), t_scale)
        _same_state(js, tc)
    for _ in range(12):
        kn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
        js = jkv.paged_append_token(js, jnp.asarray(kn), jnp.asarray(vn),
                                    js_scale)
        tkv.paged_append_token(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                               t_scale)
        _same_state(js, tc)
    assert int(tc.free_head) == b * -(-(prompt + 12) // page)
    jk, jv = jkv.paged_gather_kv(js)
    tk, tv = tkv.paged_gather_kv(tc)
    np.testing.assert_array_equal(_bytes(jk), _bytes(tk))
    np.testing.assert_array_equal(_bytes(jv), _bytes(tv))


def test_paged_pool_overflow_raises_without_writing():
    """A pool too small for the tokens raises on the CPU, before any
    write past it (the reference's XLA scatter drops such writes; on the
    card an index past the pool would be a device fault)."""
    tc = tkv.paged_init(2, 4, 2, 2, 1, 16, dtype=torch.float32,
                        device="cpu")
    kn = torch.ones((2, 1, 1, 16))
    for _ in range(4):
        tkv.paged_append_token(tc, kn, kn)
    assert tc.page_table.tolist() == [[0, -1], [1, -1]]
    before = tc.pages_k.clone()
    with pytest.raises(RuntimeError, match="out of room"):
        tkv.paged_append_token(tc, kn, kn)
    assert torch.equal(tc.pages_k, before)
    # A sequence that outgrows its table raises too.
    tc = tkv.paged_init(8, 4, 1, 1, 1, 16, dtype=torch.float32,
                        device="cpu")
    for _ in range(4):
        tkv.paged_append_token(tc, kn[:1], kn[:1])
    with pytest.raises(RuntimeError, match="out of room"):
        tkv.paged_append_token(tc, kn[:1], kn[:1])


def _pool(rng, dtype, n_pages, page, hkv, d):
    """A pool of random pages: (JAX pages, torch pages) with equal values
    (fp8 pages cast on the JAX side and their bytes copied)."""
    x = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    jd, td = _DT[dtype]
    xj = jnp.asarray(x).astype(jd)
    if dtype == "fp8":
        xt = torch.from_numpy(_bytes(xj).copy()).view(td)
    else:
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    return xj, xt


@pytest.mark.parametrize("dtype", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("shuffled", [False, True])
def test_paged_plain_matches_pallas(dtype, sink, shuffled):
    """The plain version against the reference's Pallas kernel in
    interpret mode: per-slot dequant scales, GQA 4/2, lengths that end
    mid-page, fill whole pages and are 0, a sink and a shuffled
    (non-contiguous) table. Both dequantize K and V to f32 and take f32
    scores and softmax; they differ by the order of f32 sums only, so
    2e-5 (as the reference's own paged test) for f32 pages and queries;
    with bf16 and fp8 pages the query and output are bf16, rounded on
    both sides, which leaves one bf16 ulp (2^-8 of the largest output
    element)."""
    rng = np.random.default_rng(1)
    b, hq, hkv, d, page, mpps = 4, 4, 2, 32, 8, 5
    n_pages = b * mpps + 3
    kj, kt = _pool(rng, dtype, n_pages, page, hkv, d)
    vj, vt = _pool(rng, dtype, n_pages, page, hkv, d)
    table = np.arange(b * mpps, dtype=np.int32)
    if shuffled:
        table = rng.permutation(n_pages)[:b * mpps].astype(np.int32)
    table = table.reshape(b, mpps)
    table[2, 3:] = -1            # unallocated past the length
    lengths = np.array([37, 40, 17, 0], np.int32)
    qdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)), qdt)
    qt = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    kv_scale = (rng.uniform(0.01, 0.1, b).astype(np.float32)
                if dtype == "fp8" else np.ones(b, np.float32))
    s = (rng.standard_normal(hq) * 2).astype(np.float32) if sink else None
    out_j = np.asarray(j_paged_attention(
        q, kj, vj, jnp.asarray(table), jnp.asarray(lengths),
        kv_scale=jnp.asarray(kv_scale),
        softmax_sink=jnp.asarray(s) if sink else None), np.float32)
    out_t = paged_decode_attention(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lengths),
        kv_scale=torch.from_numpy(kv_scale),
        softmax_sink=torch.from_numpy(s) if sink else None)
    assert out_t.shape == (b, 1, hq, d) and out_t.dtype == qt.dtype
    out_t = out_t.float().numpy()
    assert not np.any(out_t[3])                 # length 0: a zero row
    tol = 2e-5 if dtype == "f32" else 2 ** -8 * np.abs(out_j).max()
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=tol)
    # The wrapper took the plain version on CPU tensors.
    ref = paged_decode_attention_plain(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lengths),
        kv_scale=torch.from_numpy(kv_scale), scale=d ** -0.5,
        out_dtype=qt.dtype,
        softmax_sink=torch.from_numpy(s) if sink else None)
    np.testing.assert_array_equal(ref.float().numpy(), out_t)


B, S, NEW = 2, 16, 8


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    """The reference LLAMA_TINY and its weights as numpy arrays, with the
    embedding at stddev 0.02 (as tests/test_torch_model.py explains)."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jm = JLlama(config=dataclasses.replace(J_TINY, dtype=jdt))
    variables = jm.init(jax.random.PRNGKey(1), jnp.ones((1, S), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    emb = params["embedding"]
    params["embedding"] = (emb.astype(np.float32) * 0.02).astype(emb.dtype)
    return jm, params


def _models(dtype: str):
    jm, params = _reference(dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cfg = dataclasses.replace(LLAMA_TINY, dtype=tdt)
    model = LlamaModel(cfg, device="cpu", seed=5)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    return jm, {"params": jax.tree.map(jnp.asarray, params)}, model


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("mode", ["bf16", "fp8"])
def test_paged_generate_matches_jax_paged(mode):
    """``generate`` with ``InferenceParams(is_paged=True, page_size=8)``
    against the reference's paged generate, token for token. Lengths 16
    and 11 in a 16-wide prompt: the prefill's rewind leaves row 0 on a
    page boundary whose page is not yet allocated (16 = 2 pages), so both
    allocation rules give the same table and the reference stays in its
    pool. Both decode through the Pallas form (f32 dequantized K and V)."""
    jm, variables, model = _models("bf16")
    jd, td = _DT[mode]
    tok = _tokens()
    lens = np.array([16, 11], np.int32)
    jip = JIP(B, S + NEW, jd, is_paged=True, page_size=8)
    tip = InferenceParams(B, S + NEW, td, is_paged=True, page_size=8)
    jt = np.array(j_generate(jm, variables, jnp.asarray(tok),
                             jnp.asarray(lens), NEW, inference_params=jip))
    tt = generate(model, torch.from_numpy(tok), torch.from_numpy(lens), NEW,
                  inference_params=tip, device="cpu").numpy()
    np.testing.assert_array_equal(tt, jt)
    _, caches = prefill(model, torch.from_numpy(tok), tip,
                        torch.from_numpy(lens), device="cpu")
    assert isinstance(caches[0], PagedKVCache)
    assert caches[0].page_table.tolist() == [[0, 1, -1], [2, 3, -1]]
    assert caches[0].length.tolist() == [16, 11]


def test_paged_rewind_reuses_the_page_where_the_reference_leaks():
    """The leak case. Page 8, B 2, prompts of 8 real tokens padded to 16,
    10 new tokens: the pool is B * ceil(26 / 8) = 8 pages. The prefill
    fills pages [0, 1] and [2, 3] and rewinds both lengths to 8, a page
    boundary. The reference's ``paged_append_token`` allocates at every
    offset 0, so it leaves pages 1 and 3 behind: its tables read
    [[0, 4, 6], [2, 5, 7]] with free_head 8 after the tokens, and with the
    pool of 6 pages that ``generate`` sizes for 6 new tokens, pages 6 and
    7 lie outside it (XLA drops those writes, and its kernel clamps the
    table, so sequence 0 reads sequence 1's page). The port allocates
    only where the table holds no page, so it reuses pages 1 and 3, never
    leaves the pool, and its tokens equal the reference's contiguous
    generate (f32, so that the two attention forms agree)."""
    jm, variables, model = _models("f32")
    new = 10
    tok = _tokens()
    lens = np.array([8, 8], np.int32)
    jt = np.array(j_generate(jm, variables, jnp.asarray(tok),
                             jnp.asarray(lens), new,
                             kv_cache_dtype=jnp.float32))
    tip = InferenceParams(B, S + new, torch.float32, is_paged=True,
                          page_size=8)
    tt = generate(model, torch.from_numpy(tok), torch.from_numpy(lens), new,
                  inference_params=tip, device="cpu").numpy()
    np.testing.assert_array_equal(tt, jt)
    first, caches = prefill(model, torch.from_numpy(tok), tip,
                            torch.from_numpy(lens), device="cpu")
    from transformerengine_tpu_torch.inference import decode_steps
    decode_steps(model, caches, first, new - 1, device="cpu")
    for c in caches:
        assert c.page_table.tolist() == [[0, 1, 4, -1], [2, 3, 5, -1]]
        assert int(c.free_head) == 6 <= c.num_pages == 8
        assert not bool(c.out_of_pages)
    # The reference's own allocation on the same lengths leaks.
    js = jkv.paged_init(6, 8, B, 3, 1, 16, dtype=jnp.float32)
    kn = jnp.zeros((B, 16, 1, 16), jnp.float32)
    js = jkv.paged_append_prompt(js, kn, kn)
    js = dataclasses.replace(js, lengths=js.lengths - 8)
    for _ in range(new):
        js = jkv.paged_append_token(js, kn[:, :1], kn[:, :1])
    assert np.asarray(js.page_table).tolist() == [[0, 4, 6], [2, 5, 7]]
    assert int(js.free_head) == 8 > 6
