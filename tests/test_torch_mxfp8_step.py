"""The port's LLAMA_TINY training step under MXFP8BlockScaling against
the JAX package's: the reference's weights carried by
``load_flax_params``, the same tokens and targets (B·S = 256, so the
layers' fused norm + quantize path runs), then the loss, every
parameter's gradient and the loss after one SGD step at 1e-3 in the
parameter dtype; and the model's forward without a gradient against the
reference's primal. The reference runs eagerly, with its default (on
the CPU: unfused) quantize path, which the kernel tests hold equal to its
fused kernels.

Both sides scale the loss by 2^16 before the backward and the gradients
back after it, as loss scaling does; a power of two moves no rounding.
It lifts every gradient block's exponent into -12..12, where XLA's CPU
``exp2`` is exact (``test_torch_mxfp8_kernels.py``): unscaled, the
reference's gradient payloads move by an e4m3 code at ties of the
rounding, which reads as gradients 7.2e-2 apart (the embedding's)."""
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
from transformerengine_tpu_torch import MXFP8BlockScaling, autocast
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)

torch.set_num_threads(2)

B, S, LR = 2, 128, 1e-3
LOSS_SCALE = 2.0 ** 16


def _tokens():
    rng = np.random.default_rng(13)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's initial weights, the first step's loss and
    gradients (numpy trees), the loss after one SGD step and the logits
    of the forward without a gradient."""
    jm = JLlama(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    with te.autocast(enabled=True, recipe=te.MXFP8BlockScaling()):
        variables = jm.init(jax.random.PRNGKey(5), tok)
        params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
        emb = params["embedding"]
        params["embedding"] = (emb.astype(np.float32) * 0.02).astype(
            emb.dtype)

        def loss_fn(p):
            return j_cross_entropy(jm.apply({"params": p}, tok), tgt)

        p = jax.tree.map(jnp.asarray, params)
        logits = np.asarray(jm.apply({"params": p}, tok), np.float32)
        loss, gp = jax.value_and_grad(lambda p: loss_fn(p) * LOSS_SCALE)(p)
        loss = loss / LOSS_SCALE
        gp = jax.tree.map(lambda g: g / LOSS_SCALE, gp)
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
    with autocast(recipe=MXFP8BlockScaling()):
        loss = cross_entropy_loss(model(tok), tgt)
    (loss * LOSS_SCALE).backward()
    with torch.no_grad():
        for p in model.parameters():
            p.grad /= LOSS_SCALE
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
# quantize, move its e4m3 code by a step; readings 0 (first step) and
# 1.9e-6 (second) of a loss of 5.56.
LOSS_ATOL = 2e-4
# Gradients, each parameter's largest difference over its largest |ref|:
# those roundings, passed down the bf16 backward chain and through each
# quantized GEMM; readings up to 1.32e-2 (the embedding; layer 0's QKV
# kernel 1.02e-2), as the bf16 step of test_torch_train_step.py reads.
GRAD_RTOL = 2 ** -5
# The forward without a gradient: bf16 roundings only; readings 1.8e-7
# of the largest logit.
LOGITS_RTOL = 2 ** -8


def test_mxfp8_step_loss_and_grads_match():
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
    # MXFP8 keeps no quantizer state: the step registered no buffers, and
    # the state loads back whole into a fresh model.
    assert not [n for n, _ in model.named_buffers()
                if n.endswith(("_scale", "_amax_history"))]
    fresh = LlamaModel(LLAMA_TINY, device="cpu", seed=1)
    fresh.load_state_dict(model.state_dict())


def test_mxfp8_second_sgd_step_loss_matches():
    second_loss_j = _reference()[3]
    model = _model()
    _step(model)
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad.to(p.dtype)
    loss = _step(model)
    assert abs(float(loss) - second_loss_j) <= LOSS_ATOL


def test_mxfp8_forward_without_grad_matches_primal():
    logits_j = _reference()[4]
    model = _model()
    with torch.no_grad(), autocast(recipe=MXFP8BlockScaling()):
        logits = model(torch.from_numpy(_tokens()[0]))
    assert logits.grad_fn is None and logits.shape == logits_j.shape
    np.testing.assert_allclose(
        logits.numpy(), logits_j, rtol=0,
        atol=LOGITS_RTOL * np.abs(logits_j).max())
