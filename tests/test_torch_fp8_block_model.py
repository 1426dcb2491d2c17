"""LLAMA_TINY under ``Float8BlockScaling`` in the port against the JAX
package: the training step (the loss and every parameter's gradient, the
loss scaled by 2^16 on both sides so that every gradient block's exponent
lies where XLA's CPU ``exp2`` is exact, as ``test_torch_mxfp8_step.py``
does) and the forward without a gradient. Serving from the resident
forms is in ``test_torch_fp8_block_serving.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu_torch import Float8BlockScaling, autocast
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)
from transformerengine_tpu_torch.ops import quantize_kernels as qk

from test_torch_mxfp8_step import _flat

torch.set_num_threads(2)

B, S, LR = 2, 128, 1e-3
LOSS_SCALE = 2.0 ** 16


def _tokens():
    rng = np.random.default_rng(17)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's initial weights, the step's loss and gradients
    (numpy) and the logits of the forward without a gradient."""
    jm = JLlama(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    with te.autocast(enabled=True, recipe=te.Float8BlockScaling()):
        variables = jm.init(jax.random.PRNGKey(5), tok)
        params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
        emb = params["embedding"]
        params["embedding"] = (emb.astype(np.float32) * 0.02).astype(
            emb.dtype)
        p = jax.tree.map(jnp.asarray, params)
        logits = np.asarray(jm.apply({"params": p}, tok), np.float32)
        loss, gp = jax.value_and_grad(lambda p: j_cross_entropy(
            jm.apply({"params": p}, tok), tgt) * LOSS_SCALE)(p)
    grads = jax.tree.map(lambda g: np.asarray(g / LOSS_SCALE), gp)
    return params, float(loss / LOSS_SCALE), grads, logits


def _model():
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(_reference()[0], LLAMA_TINY,
                                           device="cpu"))
    return model


@pytest.fixture
def no_kernels(monkeypatch):
    """The quantize kernels FP8 block scaling must never reach."""
    def refuse(*args, **kwargs):
        raise AssertionError("a quantize kernel ran under FP8 block scaling")
    for name in ("cast_transpose", "norm_cast_transpose",
                 "mxfp8_quantize_1x", "mxfp8_quantize_2x",
                 "mxfp8_norm_quantize_2x", "nvfp4_amax_2x",
                 "nvfp4_quantize_2x"):
        monkeypatch.setattr(qk, name, refuse)


# Loss: bf16 activations summed in other orders; an activation can round
# to its neighbouring bf16 value and move its e4m3 code before a
# quantize. Gradients, each parameter's largest difference over its
# largest |ref|: those roundings passed down the bf16 backward chain and
# through each quantized GEMM, as test_torch_mxfp8_step.py reads them.
LOSS_ATOL = 2e-4
GRAD_RTOL = 2 ** -5
# The forward without a gradient: bf16 roundings only.
LOGITS_RTOL = 2 ** -8


def test_fp8_block_step_loss_and_grads_match(no_kernels):
    _, loss_j, grads_j, _ = _reference()
    model = _model()
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    with autocast(recipe=Float8BlockScaling()):
        loss = cross_entropy_loss(model(tok), tgt)
    (loss * LOSS_SCALE).backward()
    loss = float(loss.detach())
    assert np.isfinite(loss) and abs(loss - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for name, p in named.items():
        ref = grads_j[name]
        got = p.grad.float().numpy() / LOSS_SCALE
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)
    # Stateless: the step registered no quantizer buffers.
    assert not [n for n, _ in model.named_buffers()
                if n.endswith(("_scale", "_amax_history"))]


def test_fp8_block_forward_without_grad_matches_primal(no_kernels):
    logits_j = _reference()[3]
    model = _model()
    with torch.no_grad(), autocast(recipe=Float8BlockScaling()):
        logits = model(torch.from_numpy(_tokens()[0]))
    assert logits.grad_fn is None
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0,
                               atol=LOGITS_RTOL * np.abs(logits_j).max())
