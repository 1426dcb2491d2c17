"""FP8 attention under MXFP8BlockScaling(fp8_dpa=True), the port against
the JAX package. The reference's fp8_dpa gate does not look at the
recipe's type, so under this recipe its attention runs on FP8 Q/K/V
(current-scaling e4m3 payloads) while the GEMMs stay MXFP8; a port that
ran bf16 attention here would leave the reference's output, which the
forward test shows. Then the LLAMA_TINY training step: loss and every
gradient against the reference's eager ``value_and_grad``.

As in ``test_torch_mxfp8_step.py`` both sides scale the loss by 2^16
before the backward and the gradients back after it (a power of two
moves no rounding), which keeps every gradient block's exponent where
XLA's CPU ``exp2`` is exact. The weights are drawn with numpy from the
shapes of the reference's ``init``."""
import collections
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

from test_torch_fp8_attention_step import (
    _branches, _draw, _flat, _tokens)

torch.set_num_threads(2)

LOSS_SCALE = 2.0 ** 16


@functools.lru_cache(maxsize=None)
def _reference():
    """The weights (numpy), the logits of the forward under
    MXFP8BlockScaling(fp8_dpa=True) and under MXFP8BlockScaling(), and
    the fp8_dpa step's loss and gradients."""
    jm = JLlama(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    recipe = te.MXFP8BlockScaling(fp8_dpa=True)
    with te.autocast(enabled=True, recipe=recipe):
        shapes = fnn.meta.unbox(jax.eval_shape(jm.init,
                                               jax.random.PRNGKey(0), tok))
        params = jax.tree.map(np.asarray, _draw(
            shapes, np.random.default_rng(5))["params"])
        p = jax.tree.map(jnp.asarray, params)
        logits = np.asarray(jm.apply({"params": p}, tok), np.float32)

        def loss_fn(p):
            return j_cross_entropy(jm.apply({"params": p}, tok), tgt)

        loss, gp = jax.value_and_grad(lambda p: loss_fn(p) * LOSS_SCALE)(p)
        grads = jax.tree.map(lambda g: np.asarray(g / LOSS_SCALE), gp)
    with te.autocast(enabled=True, recipe=te.MXFP8BlockScaling()):
        logits_bf16_attn = np.asarray(jm.apply({"params": p}, tok),
                                      np.float32)
    return params, logits, logits_bf16_attn, float(loss) / LOSS_SCALE, grads


def _model():
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(_reference()[0], LLAMA_TINY,
                                           device="cpu"))
    return model


# The forward's logits: bf16 activations rounded at other places, each
# able to move an MXFP8 or e4m3 code at a tie; reading 1.6e-7 of the
# largest logit, where the reference's bf16 attention sits 1.3e-1 away
# from its FP8 attention.
LOGITS_RTOL = 2 ** -10
# Loss and gradients as in test_torch_mxfp8_step.py: readings loss 0 of
# 5.56, gradients below 4.8e-5 largest and 1.2e-5 in norm.
LOSS_ATOL = 2e-4
GRAD_RTOL = 2 ** -5
GNORM_RTOL = 2 ** -6


def test_mxfp8_fp8_dpa_forward_matches_reference():
    """The forward without a gradient runs the FP8 branch and matches the
    reference's FP8 attention; the reference's bf16 attention is far
    outside the tolerance, so bf16 attention under this recipe fails."""
    _, logits_j, logits_bf16_attn, _, _ = _reference()
    model = _model()
    seen = collections.Counter()
    with torch.no_grad(), _branches(seen), \
            autocast(recipe=MXFP8BlockScaling(fp8_dpa=True)):
        logits = model(torch.from_numpy(_tokens()[0]))
    top = np.abs(logits_j).max()
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0,
                               atol=LOGITS_RTOL * top)
    assert np.abs(logits_bf16_attn - logits_j).max() > 8 * LOGITS_RTOL * top
    assert dict(seen) == {"fwd_fp8": LLAMA_TINY.num_layers}


def test_mxfp8_fp8_dpa_step_matches():
    """Loss and every gradient of the step, with FP8 attention forward and
    backward in each layer."""
    _, _, _, loss_j, grads_j = _reference()
    model = _model()
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    seen = collections.Counter()
    with _branches(seen), autocast(recipe=MXFP8BlockScaling(fp8_dpa=True)):
        loss = cross_entropy_loss(model(tok), tgt)
        (loss * LOSS_SCALE).backward()
    n = LLAMA_TINY.num_layers
    assert dict(seen) == {"fwd_fp8": n, "bwd_fp8": n}
    assert abs(float(loss.detach()) - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for name, p in named.items():
        ref = grads_j[name]
        diff = p.grad.float().numpy() / LOSS_SCALE - ref
        assert np.abs(diff).max() / np.abs(ref).max() <= GRAD_RTOL, name
        assert np.linalg.norm(diff) / np.linalg.norm(ref) <= GNORM_RTOL, name
