"""The port's LLAMA_TINY and MIXTRAL_TINY with ``remat=True`` against the
JAX package's models with ``remat=True`` (their eager
``value_and_grad``): the loss and every gradient of one bf16 step, within
the bf16 train-step tests' tolerances. Weights, tokens and the port's
step are test_torch_remat.py's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_remat import (J_LLAMA, J_MIXTRAL, JLlama, JMixtral, _port,
                              _step, _tokens, _weights)
from transformerengine_tpu.models.llama import (
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu.models.mixtral import (
    collect_aux_loss as j_collect_aux_loss)

torch.set_num_threads(2)

# test_torch_train_step.py's and test_torch_mixtral.py's tolerances of
# the bf16 step: bf16 roundings summed in other orders move the loss by
# under 3e-5 and a gradient's largest element by under 1e-2 of it.
LOSS_ATOL = 2e-4
GRAD_RTOL = 2 ** -5


def _reference_step(kind, remat_policy):
    """The reference's loss and gradients (numpy, f32) of one bf16 step
    with ``remat=True`` under ``remat_policy``, run eagerly."""
    cls, cfg = (JLlama, J_LLAMA) if kind == "llama" else (JMixtral, J_MIXTRAL)
    jm = cls(dataclasses.replace(cfg, remat=True, remat_policy=remat_policy))
    params, _ = _weights(kind)
    tok, tgt = (jnp.asarray(a) for a in _tokens(cfg.vocab_size))

    def loss_fn(p):
        if kind == "llama":
            return j_cross_entropy(jm.apply({"params": p}, tok), tgt)
        logits, state = jm.apply({"params": p}, tok,
                                 mutable=["intermediates"])
        return j_cross_entropy(logits, tgt) + j_collect_aux_loss(
            state["intermediates"])

    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(lambda g: np.asarray(g, np.float32),
                                     grads)


def _flat(tree, prefix=""):
    out = {}
    for name, sub in tree.items():
        key = f"layers.{name[len('layer_'):]}" if name.startswith(
            "layer_") else name
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(sub, np.float32)
    return out


@pytest.mark.parametrize("kind,policy", [("llama", "nothing_saveable"),
                                         ("mixtral", "dots")])
def test_remat_step_matches_the_reference_with_remat(kind, policy):
    loss_j, grads_j = _reference_step(kind, policy)
    model = _port(kind, remat=True, remat_policy=policy)
    loss = _step(model, kind, None)
    assert abs(loss - loss_j) <= LOSS_ATOL
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    for name, p in named.items():
        ref = grads_j[name]
        err = np.abs(p.grad.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)
