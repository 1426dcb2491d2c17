"""Three training steps of the port's LLAMA_TINY against the JAX
package's, as examples/train_llama_fp8.py's low-precision form trains:
DelayedScaling() and ``fused_adam(3e-4, store_param_remainders=True)``
applied after each step's backward (the port's in place through
``apply``, the reference's ``step`` run eagerly, with its quantize_meta
taken from the gradient's cotangent). The weights are drawn with numpy
from the reference's init shapes (test_torch_fp8_attention_step.py's
helpers) and both sides start from the port's warm-up state."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from test_torch_fp8_attention_step import _draw, _flat, _key
from transformerengine_tpu.flax.module import QUANTIZE_META
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu.optimizers import fused_adam as j_adam
from transformerengine_tpu.optimizers.fused_adam import (
    _combine_master as j_combine)
from transformerengine_tpu_torch import DelayedScaling, autocast
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params)
from transformerengine_tpu_torch.optimizers import fused_adam
from transformerengine_tpu_torch.optimizers.fused_adam import (
    _combine_master)

torch.set_num_threads(2)

B, S, LR, STEPS = 2, 32, 3e-4, 3
# The first step: the loss within the bf16 step's tolerance
# (test_torch_train_step.py; reading 4.8e-7), and the f32 masters after
# it within a few f32 roundings of the update (Adam's first update is
# +-lr an element; reading 2.8e-7).
FIRST_LOSS_ATOL = 2e-4
FIRST_MASTER_ATOL = 1e-6
# Later steps: where the first update leaves a master across a bf16
# boundary on one side only (the parameter is the master's truncated
# high half), the bf16 parameters differ by an ulp, and under delayed
# scaling that moves e4m3 codes and every quantized product after them,
# as test_torch_train_step.py's current-scaling case describes. Readings
# over four steps: gradients up to 31 % of a tensor's largest element
# apart, losses 1.5e-3 and 1.7e-3 apart from the third step on, masters
# up to 1.2e-3 apart, the gradients' amaxes up to 6.3 % apart. The
# losses are held to 5e-3 and the masters to 2 lr a step (the most
# Adam's sign-like early steps can move an element); the delayed state is
# held to STATE_RTOL after the first step, and after the last to have
# rolled as often on both sides.
LOSS_ATOL = 5e-3
MASTER_ATOL = 2 * LR * STEPS
# test_torch_train_step.py's: amaxes of bf16 tensors one ulp apart.
STATE_RTOL = 2 ** -7


def _tokens():
    rng = np.random.default_rng(21)
    return (rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32))


def _start():
    """The drawn params and the quantize_meta after the port's warm-up
    step (no update), as numpy trees."""
    jm = JLlama(config=J_TINY)
    tok = jnp.asarray(_tokens()[0])
    with te.autocast(enabled=True, recipe=te.DelayedScaling()):
        shapes = fnn.meta.unbox(jax.eval_shape(jm.init,
                                               jax.random.PRNGKey(0), tok))
    drawn = _draw(shapes, np.random.default_rng(4))
    params = jax.tree.map(np.asarray, drawn["params"])
    qmeta = jax.tree.map(np.asarray, drawn[QUANTIZE_META])
    model = _port(params, qmeta)
    _port_loss(model)
    state = model.state_dict()
    qmeta = jax.tree_util.tree_map_with_path(
        lambda path, a: state[_key(path)].numpy().astype(a.dtype), qmeta)
    return params, qmeta


def _port(params, qmeta):
    model = LlamaModel(LLAMA_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(params, LLAMA_TINY, device="cpu",
                                           quantize_meta=qmeta))
    return model


def _port_loss(model) -> float:
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    model.zero_grad(set_to_none=True)
    with autocast(recipe=DelayedScaling()):
        loss = cross_entropy_loss(model(tok), tgt)
    loss.backward()
    return float(loss.detach())


def test_three_adam_steps_with_remainders_match_reference():
    params, qmeta = _start()
    jm = JLlama(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())

    def loss_fn(p, q):
        return j_cross_entropy(jm.apply({"params": p, QUANTIZE_META: q},
                                        tok), tgt)

    grad_fn = jax.value_and_grad(loss_fn, argnums=(0, 1))
    jopt = j_adam(LR, store_param_remainders=True)
    p, q = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, qmeta)
    js = jopt.init(p)
    model = _port(params, qmeta)
    topt = fused_adam(LR, store_param_remainders=True)
    ts = topt.init(model)
    for step in range(STEPS):
        with te.autocast(enabled=True, recipe=te.DelayedScaling()):
            loss_j, (gp, q) = grad_fn(p, q)
        p, js = jopt.step(gp, js, p)
        loss = _port_loss(model)
        ts = topt.apply(model, ts)
        first = step == 0
        assert abs(loss - float(loss_j)) <= (
            FIRST_LOSS_ATOL if first else LOSS_ATOL), (step, loss, loss_j)
        _same_masters(model, ts, p, js,
                      FIRST_MASTER_ATOL if first else MASTER_ATOL)
        buffers = model.state_dict()
        for key, want in _flat(jax.tree.map(np.asarray, q)).items():
            got = buffers[key].numpy()
            if first:
                np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                                           err_msg=key)
            elif key.endswith("_amax_history"):
                # Rolled once a step on both sides.
                np.testing.assert_array_equal(got > 0, want > 0, key)
    assert int(ts.step) == int(js.step) == STEPS


def _same_masters(model, ts, p, js, atol):
    """The f32 masters of both sides (remainders recombined with their
    bf16 parameters) within ``atol``; every bf16 leaf has a remainder,
    the f32 norm scales f32 masters."""
    j_masters = jax.tree.map(
        lambda pw, w: np.asarray(j_combine(pw, w) if w.dtype == jnp.int16
                                 else w, np.float32), p, js.master)
    named = dict(model.named_parameters())
    remainders = 0
    for key, want in _flat(j_masters).items():
        w = ts.master[key]
        if w.dtype == torch.int16:
            remainders += 1
            got = _combine_master(named[key].detach(), w)
        else:
            got = w
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                   err_msg=key)
    assert remainders == sum(1 for k in named if "scale" not in k)
