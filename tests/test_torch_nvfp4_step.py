"""The port's LLAMA_TINY training step under NVFP4BlockScaling against
the JAX package's: the reference's weights carried by
``load_flax_params``, the same tokens and targets, then the loss, every
parameter's gradient and the loss after one SGD step at 1e-3; and the
forward without a gradient against the reference's primal. The reference
runs eagerly (under ``jax.jit`` XLA moves its NVFP4 gradients, the
embedding's by 0.29 of its largest element, and its loss by 2.4e-3),
with its default (on the CPU:
unfused) quantize path, which the kernel tests hold equal to its fused
kernels. The layers pass no generator, so no rounding is stochastic, as
the reference's layers pass no key. NVFP4-resident serving is held in
``test_torch_nvfp4_serving.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu_torch import NVFP4BlockScaling, autocast
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)

torch.set_num_threads(2)

B, S, LR = 2, 64, 1e-3


def _tokens():
    rng = np.random.default_rng(17)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


def _init(config):
    """The reference's initial weights (numpy), embedding at stddev 0.02
    (Llama's own init)."""
    jm = JLlama(config=config)
    variables = jm.init(jax.random.PRNGKey(7),
                        jnp.ones((1, S), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    emb = params["embedding"]
    params["embedding"] = (emb.astype(np.float32) * 0.02).astype(emb.dtype)
    return jm, params


@functools.lru_cache(maxsize=None)
def _reference():
    """The initial weights, the first step's loss and gradients (numpy
    trees), the loss after one SGD step and the logits of the forward
    without a gradient."""
    jm, params = _init(J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    with te.autocast(enabled=True, recipe=te.NVFP4BlockScaling()):

        def loss_fn(p):
            return j_cross_entropy(jm.apply({"params": p}, tok), tgt)

        p = jax.tree.map(jnp.asarray, params)
        logits = np.asarray(jm.apply({"params": p}, tok), np.float32)
        loss, gp = jax.value_and_grad(loss_fn)(p)
        grads = jax.tree.map(np.asarray, gp)
        p = jax.tree.map(lambda a, g: a - LR * g.astype(a.dtype), p, gp)
        second_loss = float(loss_fn(p))
    return params, float(loss), grads, second_loss, logits


def _model():
    params = _reference()[0]
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(params, LLAMA_TINY, device="cpu"))
    return model


def _step(model):
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    model.zero_grad(set_to_none=True)
    with autocast(recipe=NVFP4BlockScaling()):
        loss = cross_entropy_loss(model(tok), tgt)
    loss.backward()
    return loss.detach()


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


# Loss: both sides keep bf16 activations and sum in other orders, so an
# activation can round to its neighbouring bf16 value and, before a
# quantize, move its e2m1 code by a step (up to a third of the value);
# readings 4.8e-7 (first step) and 1.4e-6 (second) of a loss of 5.57.
LOSS_ATOL = 2e-4
# Gradients, each parameter's largest difference over its largest |ref|:
# those roundings, passed down the bf16 backward chain and through each
# quantized GEMM, where an e2m1 step is 16 times an e4m3 one; readings up
# to 1.1e-4 (the embedding; the norm scales 3e-7). The limit is the
# MXFP8 step's (test_torch_mxfp8_step.py).
GRAD_RTOL = 2 ** -5
# The forward without a gradient: bf16 roundings, some of which could
# move a code; readings 2.6e-7 of the largest logit.
LOGITS_RTOL = 2 ** -8


def test_nvfp4_step_loss_and_grads_match():
    _, loss_j, grads_j, _, _ = _reference()
    model = _model()
    loss = _step(model)
    assert torch.isfinite(loss) and abs(float(loss) - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for name, p in named.items():
        ref = grads_j[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        err = np.abs(p.grad.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)
    # NVFP4 keeps no quantizer state.
    assert not [n for n, _ in model.named_buffers()
                if n.endswith(("_scale", "_amax_history"))]


def test_nvfp4_second_sgd_step_loss_matches():
    second_loss_j = _reference()[3]
    model = _model()
    _step(model)
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad.to(p.dtype)
    loss = _step(model)
    assert abs(float(loss) - second_loss_j) <= LOSS_ATOL


def test_nvfp4_forward_without_grad_matches_primal():
    logits_j = _reference()[4]
    model = _model()
    with torch.no_grad(), autocast(recipe=NVFP4BlockScaling()):
        logits = model(torch.from_numpy(_tokens()[0]))
    assert logits.grad_fn is None and logits.shape == logits_j.shape
    np.testing.assert_allclose(
        logits.numpy(), logits_j, rtol=0,
        atol=LOGITS_RTOL * np.abs(logits_j).max())
