"""The port's LLAMA_TINY training step against the JAX package's: the
reference's weights and quantize_meta carried by ``load_flax_params``,
the same tokens and targets, then the loss, every parameter's gradient,
the updated delayed-scaling state (the reference's quantize_meta
cotangent; the port's module buffers after ``loss.backward()``) and the
loss after one SGD step at 1e-3 in the parameter dtype, as
``__graft_entry__.dryrun_multichip`` trains. Without a recipe (bf16),
under DelayedScaling(amax_history_len=16) and under
Float8CurrentScaling()."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.flax.module import QUANTIZE_META
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu_torch import (DelayedScaling, Float8CurrentScaling,
                                         autocast)
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)

torch.set_num_threads(2)

B, S, LR = 2, 32, 1e-3
RECIPES = ["bf16", "delayed", "current"]


def _tokens():
    rng = np.random.default_rng(11)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


def _autocast_j(recipe):
    if recipe == "bf16":
        return te.autocast(enabled=False)
    if recipe == "current":
        return te.autocast(enabled=True, recipe=te.Float8CurrentScaling())
    return te.autocast(enabled=True,
                       recipe=te.DelayedScaling(amax_history_len=16))


def _autocast_t(recipe):
    if recipe == "bf16":
        return autocast(enabled=False)
    if recipe == "current":
        return autocast(recipe=Float8CurrentScaling())
    return autocast(recipe=DelayedScaling(amax_history_len=16))


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), fnn.meta.unbox(tree))


@functools.lru_cache(maxsize=None)
def _reference(recipe: str):
    """The reference's initial variables (quantize_meta after a warm-up
    step), the first step's loss, gradients and updated quantize_meta
    (numpy trees), and the loss after one SGD step."""
    jm = JLlama(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    with _autocast_j(recipe):
        variables = jm.init(jax.random.PRNGKey(3), tok)
        params = _to_np(variables["params"])
        emb = params["embedding"]
        params["embedding"] = (emb.astype(np.float32) * 0.02).astype(
            emb.dtype)
        qmeta = _to_np(variables.get(QUANTIZE_META, {}))

        def loss_fn(p, q):
            coll = {"params": p}
            if q:
                coll[QUANTIZE_META] = q
            return j_cross_entropy(jm.apply(coll, tok), tgt)

        step = jax.value_and_grad(loss_fn, argnums=(0, 1))
        p, q = jax.tree.map(jnp.asarray, params), \
            jax.tree.map(jnp.asarray, qmeta)
        if q:
            # Warm-up: one step's state update only, so the compared steps
            # quantize with scales set from real amaxes (at the initial
            # scale 1 the gradients fall among e5m2's subnormals).
            q = step(p, q)[1][1]
            qmeta = _to_np(q)
        loss, (gp, gq) = step(p, q)
        first = (float(loss), _to_np(gp), _to_np(gq) if q else {})
        p = jax.tree.map(lambda a, g: a - LR * g.astype(a.dtype), p, gp)
        second_loss = float(loss_fn(p, gq if q else q))
    return params, qmeta, first, second_loss


def _port(recipe: str):
    """A port model holding the reference's initial weights and state,
    after one training step; returns (model, loss)."""
    params, qmeta, _, _ = _reference(recipe)
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    state = load_flax_params(params, LLAMA_TINY, device="cpu",
                             quantize_meta=qmeta or None)
    model.load_state_dict(state)
    return model, _step(model, recipe)


def _step(model, recipe):
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    model.zero_grad(set_to_none=True)
    with _autocast_t(recipe):
        loss = cross_entropy_loss(model(tok), tgt)
    loss.backward()
    return loss


def _flat(tree, prefix=""):
    """Flax tree -> {state_dict key: array}."""
    out = {}
    for name, sub in tree.items():
        key = f"layers.{name[len('layer_'):]}" if name.startswith(
            "layer_") else name
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(sub, np.float32)
    return out


# The reference runs eagerly: under jax.jit, XLA on the CPU moves the
# DelayedScaling loss by about 1e-3 against its own eager run (5.61634
# against 5.61523), which the port matches to 1e-6.
# Loss: both sides keep bf16 activations and sum in other orders, so an
# activation can round to its neighbouring bf16 value; through two layers
# and a 256-way softmax that moves the mean loss (about 5.6) by under
# 3e-5 in the readings (both recipes, both steps).
LOSS_ATOL = 2e-4
# Gradients, each parameter's largest difference over its largest |ref|:
# the bf16 gradients of the backward chain differ by one-ulp roundings
# (2^-8) that accumulate through the layers; the readings are below 1e-2
# without a recipe (the embedding and the MLP kernels) and below 1e-4
# under DelayedScaling, where the bit-exact FP8 payloads absorb them.
GRAD_RTOL = 2 ** -5
# Delayed-scaling state: amaxes of bf16 tensors that may round one ulp
# apart, and the scales computed from them.
STATE_RTOL = 2 ** -7
# Float8CurrentScaling: XLA's CPU mean and rsqrt differ from torch's by
# an f32 ulp in a third of the RMSNorm rows, and at this seed one of
# layer 1's normalized bf16 values rounds the other way and moves its
# e4m3 code; every current-scaled quantize after it (each scale follows
# its tensor's own amax) carries the step. Readings: loss 5.9e-5, second
# loss 1.8e-3, gradients 1.2e-1 largest (the embedding; layer 0 8e-2 to
# 1.2e-1, layer 1 4e-2 to 6e-2, the final norm 5.5e-3).
# test_torch_fp8_attention_step.py holds the same recipe to 6.9e-4 from
# weights where no code moves.
CURRENT_GRAD_RTOL = 2 ** -2
CURRENT_SECOND_LOSS_ATOL = 5e-3


@pytest.mark.parametrize("recipe", RECIPES)
def test_train_step_loss_and_grads_match(recipe):
    loss_j, grads_j, _ = _reference(recipe)[2]
    model, loss = _port(recipe)
    assert torch.isfinite(loss) and abs(float(loss) - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for name, p in named.items():
        ref = grads_j[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        err = np.abs(p.grad.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= (CURRENT_GRAD_RTOL if recipe == "current"
                       else GRAD_RTOL), (name, err)


def test_train_step_updates_quantize_meta():
    _, qmeta, (_, _, new_meta), _ = _reference("delayed")
    model, _ = _port("delayed")
    new_j = _flat(new_meta)
    buffers = {k: v for k, v in model.state_dict().items()
               if k.endswith(("_scale", "_amax_history"))}
    assert set(buffers) == set(new_j) == set(_flat(qmeta))
    assert len(buffers) == 2 * 3 * 4 * LLAMA_TINY.num_layers
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), new_j[name], rtol=STATE_RTOL,
                                   atol=0, err_msg=name)
    # Every history recorded this step's amax in its last slot.
    hist = [b for k, b in buffers.items() if k.endswith("_amax_history")]
    assert all(float(h[-1]) > 0 for h in hist)


@pytest.mark.parametrize("recipe", RECIPES)
def test_second_sgd_step_loss_matches(recipe):
    second_loss_j = _reference(recipe)[3]
    model, _ = _port(recipe)
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad.to(p.dtype)
    loss = _step(model, recipe)
    assert abs(float(loss) - second_loss_j) <= (
        CURRENT_SECOND_LOSS_ATOL if recipe == "current" else LOSS_ATOL)
