"""The port's LLAMA_TINY training step with context parallelism on 4 gloo
ranks of the CPU against the JAX package's step on the whole sequence
without it: each rank feeds its contiguous shard of a (2, 64) batch and
its tokens' global RoPE positions, every layer's attention runs the ring
over the group, each rank's loss is its summed cross entropy over the
global token count, and the loss and every gradient are summed over the
group (the caller's sums, which the reference's ``shard_map`` transpose
makes); held to the reference's eager ``value_and_grad`` (the same
weights, drawn with numpy from the shapes of its ``init``). Then the
ranks' logits against the reference's forward.

The ranks are processes of ``test_torch_cp_group.py``'s pool; on CPU
tensors the flash wrappers run their plain versions."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as fnn

from test_torch_cp_group import CP, pool  # noqa: F401 (the fixture)
from test_torch_fp8_attention_step import _draw, _flat
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama,
    cross_entropy_loss as j_cross_entropy)

B, S = 2, 64
# bf16 activations summed in other orders, and the ring's partial O and
# step gradients rounded to bf16 before its f32 merges and sums, as the
# reference's ring rounds them: readings loss 1.15e-4 of 5.57, the
# largest gradient difference 1.6e-2 of its largest element (1.3e-2 in
# norm), the logits 1.03e-2 of the largest (3.6e-3 on rank 0's rows, the
# ring's first chunk). About twice each.
LOSS_ATOL = 2e-4
GRAD_RTOL = 2 ** -5
LOGITS_RTOL = 2e-2


@functools.lru_cache(maxsize=None)
def _reference():
    """Weights, tokens and targets (numpy), and the reference's loss,
    gradients (flat, by state_dict key) and logits of the step on the
    whole sequence."""
    rng = np.random.default_rng(61)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    jm = JLlama(config=J_TINY)
    shapes = fnn.meta.unbox(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.asarray(tok)))
    params = jax.tree.map(np.asarray, _draw(shapes, rng)["params"])

    def loss_fn(p):
        return j_cross_entropy(jm.apply({"params": p}, jnp.asarray(tok)),
                               jnp.asarray(tgt))

    p = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(loss_fn)(p)
    logits = np.asarray(jm.apply({"params": p}, jnp.asarray(tok)),
                        np.float32)
    return params, tok, tgt, float(loss), _flat(grads), logits


@functools.lru_cache(maxsize=None)
def _port(pool):  # noqa: F811
    params, tok, tgt = _reference()[:3]
    return pool.run("llama_cp_step", params, tok, tgt)


def test_cp_step_matches_whole_sequence(pool):  # noqa: F811
    """The loss and every gradient, summed over the ranks, against the
    reference's step without CP; every layer's ring ran cp forward and
    cp backward steps on every rank, each with its runtime offset."""
    _, _, _, loss_j, grads_j, _ = _reference()
    outs = _port(pool)
    layers = J_TINY.num_layers
    for o in outs:
        assert o["calls"] == {"fwd_qoff": CP * layers,
                              "bwd_qoff": CP * layers}, o["calls"]
        assert abs(o["loss"] - loss_j) <= LOSS_ATOL
    grads = outs[0]["grads"]
    assert set(grads) == set(grads_j)
    for name, ref in grads_j.items():
        diff = grads[name] - ref
        err = np.abs(diff).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)


def test_cp_forward_logits_match(pool):  # noqa: F811
    """The ranks' logits, in sequence order, against the reference's
    forward on the whole sequence."""
    logits_j = _reference()[5]
    got = np.concatenate([o["logits"] for o in _port(pool)], axis=1)
    np.testing.assert_allclose(got, logits_j, rtol=0,
                               atol=LOGITS_RTOL * np.abs(logits_j).max())
