"""The port's LLAMA_TINY training step on packed documents against the JAX
package's: a batch of the port's PackedDataLoader (tokens, segment ids,
positions), the descriptor from ``from_segment_ids_and_pos``, the
per-document RoPE positions and the next-token loss masked to targets
that continue their own document; the same weights (drawn with numpy from
the shapes of the reference's ``init``) and, under delayed scaling, the
same quantize_meta after one warm-up step of the port's. Without a
recipe, under DelayedScaling and under DelayedScaling(fp8_dpa=True,
fp8_mha=True): the loss, every parameter's gradient and the updated
delayed state against the reference's eager ``value_and_grad`` (``jax.jit``
moves the delayed-scaling loss, ROADMAP.md), and every layer's flash call
carrying the ids; then the forward's logits with and without
``positions``.

On CPU tensors the flash wrappers run their plain versions;
``chip_smoke.py`` phase 20 drives the same step through the kernels."""
import collections
import contextlib
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from test_torch_fp8_attention_step import UNUSED, _draw, _flat, _key
from transformerengine_tpu.attention import SequenceDescriptor as JDesc
from transformerengine_tpu.flax.module import QUANTIZE_META
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch.attention import SequenceDescriptor
from transformerengine_tpu_torch.data import (PackedDataLoader,
                                              write_token_bin)
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)
from transformerengine_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

B, S = 2, 32
RECIPES = {
    "bf16": None,
    "delayed": lambda m: m.DelayedScaling(amax_history_len=16),
    "delayed_mha": lambda m: m.DelayedScaling(amax_history_len=16,
                                              fp8_dpa=True, fp8_mha=True),
}


@functools.lru_cache(maxsize=None)
def _batch():
    """The first batch of the port's native loader over 40 seeded
    documents of 4-40 tokens (log-uniform, the longer ones split): numpy
    (tokens, segment_ids, positions), (B, S) int32."""
    rng = np.random.default_rng(17)
    lens = np.exp(rng.uniform(np.log(4), np.log(40), 40)).astype(np.int64)
    docs = [rng.integers(1, J_TINY.vocab_size, int(n)).astype(np.int32)
            for n in lens]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/docs.tebin"
        write_token_bin(path, docs)
        loader = PackedDataLoader(path, B, S, seed=5, n_threads=1)
        try:
            assert loader.native
            batch = loader.next_batch()
        finally:
            loader.close()
    # Each row packs several documents and padding.
    seg = batch[1]
    assert all(int(seg[r].max()) >= 2 and int(seg[r, -1]) == 0
               for r in range(B))
    return batch


def _autocast(mod, name):
    make = RECIPES[name]
    if make is None:
        return mod.autocast(enabled=False)
    return mod.autocast(enabled=True, recipe=make(mod))


def _j_loss(jm, coll, batch):
    tok, seg, pos = (jnp.asarray(a) for a in batch)
    desc = JDesc.from_segment_ids_and_pos(seg, seg, pos, pos)
    logits = jm.apply(coll, tok, desc, pos)
    mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    return j_cross_entropy(logits[:, :-1], tok[:, 1:], mask)


def _t_loss(model, batch):
    tok, seg, pos = (torch.from_numpy(a) for a in batch)
    desc = SequenceDescriptor.from_segment_ids_and_pos(seg, seg, pos, pos)
    logits = model(tok, desc, pos)
    mask = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    return cross_entropy_loss(logits[:, :-1], tok[:, 1:], mask=mask)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """The weights and quantize_meta (after the port's warm-up step under
    delayed scaling), and the reference's loss, gradients and updated
    quantize_meta of the packed step (numpy)."""
    jm = JLlama(config=J_TINY)
    batch = _batch()
    with _autocast(te, name):
        shapes = fnn.meta.unbox(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), jnp.asarray(batch[0])))
        drawn = _draw(shapes, np.random.default_rng(4))
        params = jax.tree.map(np.asarray, drawn["params"])
        qmeta = jax.tree.map(np.asarray, drawn.get(QUANTIZE_META, {}))
        if qmeta:
            qmeta = _warm_state(name, params, qmeta)

        def loss_fn(p, q):
            coll = {"params": p, **({QUANTIZE_META: q} if q else {})}
            return _j_loss(jm, coll, batch)

        p, q = jax.tree.map(jnp.asarray, params), \
            jax.tree.map(jnp.asarray, qmeta)
        loss, (gp, gq) = jax.value_and_grad(loss_fn, argnums=(0, 1))(p, q)
    return (params, qmeta, float(loss), jax.tree.map(np.asarray, gp),
            jax.tree.map(np.asarray, gq) if q else {})


def _model(name, params, qmeta):
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(params, LLAMA_TINY, device="cpu",
                                           quantize_meta=qmeta or None))
    return model


def _warm_state(name, params, qmeta):
    """The quantize_meta tree after one packed warm-up step of the port's
    model (its updated buffers, no SGD)."""
    model = _model(name, params, qmeta)
    with _autocast(tt, name):
        _t_loss(model, _batch()).backward()
    state = model.state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, a: state[_key(path)].numpy().astype(a.dtype), qmeta)


@contextlib.contextmanager
def _flash_calls(seen: collections.Counter):
    """Counts the flash wrappers' calls by direction, branch and whether
    they carried segment ids."""
    fwd, bwd = fa.flash_fwd, fa.flash_bwd

    def tag(kw):
        branch = ("fp8_mha" if kw.get("out_scale") is not None
                  or kw.get("do_scale_inv") is not None
                  else "fp8" if kw.get("scale_invs") is not None else "bf16")
        return branch + ("_seg" if kw.get("q_segment_ids") is not None
                         else "")

    def fwd_hook(*args, **kw):
        seen["fwd_" + tag(kw)] += 1
        return fwd(*args, **kw)

    def bwd_hook(*args, **kw):
        seen["bwd_" + tag(kw)] += 1
        return bwd(*args, **kw)
    fa.flash_fwd, fa.flash_bwd = fwd_hook, bwd_hook
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = fwd, bwd


# Loss: bf16 activations summed in other orders; readings 9.1e-6 (bf16)
# and 4.8e-7 of a loss of 5.57 (test_torch_train_step.py's limit).
LOSS_ATOL = 2e-4
# Gradients, each parameter's largest difference over its largest |ref|
# and, under the FP8 recipes, in norm. Layer 0 is bit-exact on this batch;
# in layer 1 one element of the attention's bf16 output lands one ulp
# apart (a rounding tie of p, 2.2e-3 of its largest), which moves the
# e4m3 code of the next quantize under delayed scaling, as
# test_torch_fp8_attention_step.py describes. Readings: bf16 8.8e-3
# largest (2^-5 is test_torch_train_step.py's limit); DelayedScaling
# 3.4e-2 largest and 1.4e-2 in norm, with fp8_dpa and fp8_mha 3.0e-2 and
# 7.4e-3 (test_torch_fp8_attention_step.py's 2^-4 and 2^-5).
GRAD_RTOL = {"bf16": 2 ** -5, "delayed": 2 ** -4, "delayed_mha": 2 ** -4}
GNORM_RTOL = 2 ** -5
# The delayed state: readings 0 (every amax equal); 2^-7 as both step
# tests hold it.
STATE_RTOL = 2 ** -7
# The forward's logits: the same one-ulp element gives 2.9e-3 of the
# largest logit at one token, the others below 1.5e-7.
LOGITS_RTOL = 2 ** -8


@pytest.mark.parametrize("name", list(RECIPES))
def test_packed_step_matches(name):
    """Loss, every gradient and the updated delayed state of one packed
    step; every layer's flash forward and backward took the ids, in the
    recipe's branch."""
    params, qmeta, loss_j, grads_j, meta_j = _reference(name)
    model = _model(name, params, qmeta)
    seen = collections.Counter()
    with _flash_calls(seen), _autocast(tt, name):
        loss = _t_loss(model, _batch())
        loss.backward()
    branch = "fp8_mha_seg" if name == "delayed_mha" else "bf16_seg"
    n = LLAMA_TINY.num_layers
    assert dict(seen) == {"fwd_" + branch: n, "bwd_" + branch: n}
    assert abs(float(loss.detach()) - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for pname, p in named.items():
        ref = grads_j[pname]
        assert p.grad is not None and p.grad.dtype == p.dtype, pname
        diff = p.grad.float().numpy() - ref
        err = np.abs(diff).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL[name], (pname, err)
        if name != "bf16":
            err = np.linalg.norm(diff) / np.linalg.norm(ref)
            assert err <= GNORM_RTOL, (pname, err)
    buffers = {k: v.numpy() for k, v in model.state_dict().items()
               if k.endswith(("_scale", "_amax_history"))}
    if name == "bf16":
        assert not buffers
        return
    new_j, start = _flat(meta_j), _flat(qmeta)
    assert set(buffers) == set(new_j)
    for key, buf in buffers.items():
        if any(u in key for u in UNUSED) and name == "delayed_mha":
            # Unused under fp8_mha: left as it was (ROADMAP.md Queue 3).
            np.testing.assert_array_equal(buf, start[key], err_msg=key)
            continue
        np.testing.assert_allclose(buf, new_j[key], rtol=STATE_RTOL, atol=0,
                                   err_msg=key)
        if key.endswith("_amax_history"):
            assert buf[-1] > 0, key


@functools.lru_cache(maxsize=None)
def _reference_logits(with_positions: bool):
    params = _reference("bf16")[0]
    tok, seg, pos = (jnp.asarray(a) for a in _batch())
    desc = JDesc.from_segment_ids_and_pos(seg, seg, pos, pos)
    coll = {"params": jax.tree.map(jnp.asarray, params)}
    return np.asarray(JLlama(config=J_TINY).apply(
        coll, tok, desc, pos if with_positions else None), np.float32)


@pytest.mark.parametrize("with_positions", [True, False])
def test_packed_forward_logits_match(with_positions):
    """The forward without a gradient on the packed batch, with the
    per-document positions and without them (RoPE at 0..S-1), against
    the reference's. (RoPE is relative, so within a contiguous document
    the two differ only in the bf16 roundings of the rotated q and k.)"""
    params = _reference("bf16")[0]
    model = _model("bf16", params, {})
    tok, seg, pos = (torch.from_numpy(a) for a in _batch())
    desc = SequenceDescriptor.from_segment_ids_and_pos(seg, seg, pos, pos)
    with torch.no_grad():
        logits = model(tok, desc, pos if with_positions else None)
    ref = _reference_logits(with_positions)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0,
                               atol=LOGITS_RTOL * np.abs(ref).max())
