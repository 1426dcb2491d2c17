"""A 2-layer encoder stack of the port against the JAX package on the
CPU (padding lengths, the relative bias, LayerNorm, a zero-centred gamma,
GELU and GeGLU) under ``value_and_grad`` of a seeded linear read-out,
``(y.float() * r).sum() / n_valid``: in bf16, under
``MXFP8BlockScaling()`` and under ``DelayedScaling(fp8_dpa=True,
fp8_mha=True)``, where the bias closes the FP8 attention gates on both
sides. The loss, every parameter's gradient (``rel_embedding``'s among
them) and which flash branch each layer ran. The weights are drawn with
numpy from the shapes of the reference's ``init`` (quantize_meta at its
initial state) and carried by ``nn.transformer.load_flax_params``, the
stack's list form; the reference runs eagerly."""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from test_torch_encoder import (
    B, FFN, HEADS, HIDDEN, KV_HEADS, LENS, S, _branches, _draw, _hold_loss,
    _no_reference_fp8_attention, _np, _readout)
from transformerengine_tpu.attention import (
    AttnMaskType as JMask, SequenceDescriptor as JDesc)
from transformerengine_tpu.flax.module import QUANTIZE_META
from transformerengine_tpu.flax.transformer import TransformerLayer as JLayer
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor)
from transformerengine_tpu_torch.nn.transformer import (
    TransformerLayer, load_flax_params)

torch.set_num_threads(2)


class _JStack(fnn.Module):
    """Two reference encoder layers: relative bias, LayerNorm, a padding
    mask; layer 0 GELU, layer 1 GeGLU with a zero-centred gamma."""

    @fnn.compact
    def __call__(self, x, desc):
        for i, (acts, zcg) in enumerate(((("gelu",), False),
                                         (("gelu", "linear"), True))):
            x = JLayer(hidden_size=HIDDEN, mlp_hidden_size=FFN,
                       num_attention_heads=HEADS, num_gqa_groups=KV_HEADS,
                       layernorm_epsilon=1e-5, norm_type="layernorm",
                       zero_centered_gamma=zcg, mlp_activations=acts,
                       self_attn_mask_type=JMask.PADDING,
                       enable_relative_embedding=True,
                       name=f"layer_{i}{'_zcg' if zcg else ''}")(x, None,
                                                                 desc)
        return x


def _port_stack():
    return torch.nn.ModuleList(
        TransformerLayer(HIDDEN, FFN, HEADS, num_gqa_groups=KV_HEADS,
                         layernorm_epsilon=1e-5, norm_type="layernorm",
                         zero_centered_gamma=zcg, mlp_activations=acts,
                         self_attn_mask_type=AttnMaskType.PADDING,
                         enable_relative_embedding=True, device="cpu")
        for acts, zcg in ((("gelu",), False), ("geglu", True)))


# Both sides scale the loss by 2^16 before the backward and the
# gradients back after it, as loss scaling does (a power of two moves no
# rounding): it lifts the gradients' MXFP8 block exponents into the range
# where XLA's CPU exp2 is exact (test_torch_mxfp8_step.py) and keeps the
# e5m2 gradients of the delayed recipe's first step (scale 1) out of the
# subnormals.
LOSS_SCALE = 2.0 ** 16
STACK_RECIPES = {
    "bf16": None,
    "mxfp8": lambda m: m.MXFP8BlockScaling(),
    "delayed_mha": lambda m: m.DelayedScaling(amax_history_len=16,
                                              fp8_dpa=True, fp8_mha=True),
}


@functools.lru_cache(maxsize=None)
def _stack_reference(name: str):
    """The drawn weights (and quantize_meta), the input, the read-out,
    and the reference's loss and gradients (params, quantize_meta)."""
    rng = np.random.default_rng(51)
    x = (rng.standard_normal((B, S, HIDDEN)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    lens = np.asarray(LENS, np.int32)
    desc = JDesc.from_seqlens(jnp.asarray(lens))
    r = _readout(rng)
    jm = _JStack()
    make = STACK_RECIPES[name]
    with te.autocast(enabled=make is not None,
                     recipe=make(te) if make else None), \
            _no_reference_fp8_attention():
        shapes = fnn.meta.unbox(jax.eval_shape(jm.init,
                                               jax.random.PRNGKey(0), xj,
                                               desc))
        drawn = _draw(shapes, rng)
        params = jax.tree.map(np.asarray, drawn["params"])
        qmeta = jax.tree.map(np.asarray, drawn.get(QUANTIZE_META, {}))

        def loss_fn(p, q):
            coll = {"params": p, **({QUANTIZE_META: q} if q else {})}
            y = jm.apply(coll, xj, desc)
            return (y.astype(jnp.float32) * r).sum() / lens.sum() \
                * LOSS_SCALE

        loss, (gp, gq) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, qmeta))
    return (params, qmeta, np.asarray(xj.astype(jnp.float32)), r,
            float(loss) / LOSS_SCALE,
            jax.tree.map(lambda g: np.asarray(g) / LOSS_SCALE, gp))


def _stack_trees(tree):
    """The reference stack's tree as the list of its layers' trees."""
    return [tree[k] for k in sorted(tree)]


# Gradients in norm, each parameter's. Without a recipe: the flash
# backward's bf16 p and ds one ulp apart in a few elements, LayerNorm's
# statistics and GELU's tanh (XLA's against torch's) in other f32 orders;
# readings up to 6.9e-3. MXFP8 (the loss scaled): one-ulp differences of
# bf16 activations move a few e4m3 codes; readings up to 1.1e-2 (layer
# 0's QKV). DelayedScaling's first step (scale 1, HYBRID): the gradients
# quantize to e5m2, whose 2-bit mantissa turns such a one-ulp difference
# at a rounding tie into a code step of a quarter of the value, and layer
# 0 takes layer 1's quantized gradients: readings up to 6.2e-2 in layer 0
# (its QKV scale) and 6.0e-3 in layer 1, which is held tighter. The e5m2
# and e4m3 casts themselves are equal on both sides. rel_embedding's
# gradient also sums its (q, k) terms in another order; it is held with
# the rest.
STACK_GNORM_RTOL = {"bf16": 2 ** -6, "mxfp8": 2 ** -5, "delayed_mha": 2 ** -3}
LAST_LAYER_GNORM_RTOL = 2 ** -6


@pytest.mark.parametrize("name", list(STACK_RECIPES))
def test_encoder_stack_step_matches_the_reference(name):
    """Loss and every parameter's gradient of the 2-layer encoder stack
    against the reference's value_and_grad; the flash kernels take the
    relative bias in every layer and FP8 attention is off on both sides
    (the port: no FP8 flash call; the reference: its FP8 cores never
    run)."""
    params, qmeta, x, r, loss_j, gp = _stack_reference(name)
    stack = _port_stack()
    state = load_flax_params(_stack_trees(params), device="cpu")
    if qmeta:
        state.update(load_flax_params(
            [jax.tree.map(np.asarray, t) for t in _stack_trees(qmeta)],
            device="cpu", dtype=torch.float32))
    missing, unexpected = stack.load_state_dict(state, strict=False)
    assert not unexpected and not [k for k in missing if "_amax" not in k
                                   and not k.endswith("_scale")], missing
    lens = torch.tensor(LENS, dtype=torch.int32)
    desc = SequenceDescriptor.from_seqlens(lens)
    make = STACK_RECIPES[name]
    seen = collections.Counter()
    y = torch.from_numpy(x).to(torch.bfloat16)
    with tt.autocast(enabled=make is not None,
                     recipe=make(tt) if make else None), _branches(seen):
        for layer in stack:
            y = layer(y, desc)
        loss = (y.float() * torch.from_numpy(r)).sum() / lens.sum()
        (loss * LOSS_SCALE).backward()
    for p in stack.parameters():
        p.grad /= LOSS_SCALE
    assert dict(seen) == {"fwd_bias": 2, "bwd_bias": 2}, seen
    _hold_loss(loss, loss_j, y, r, lens.sum())
    ref = load_flax_params(_stack_trees(gp), device="cpu",
                           dtype=torch.float32)
    grads = {k: p.grad for k, p in stack.named_parameters()}
    assert set(ref) == set(grads)
    for k in ref:
        a, b = _np(grads[k]), _np(ref[k])
        assert np.linalg.norm(b) > 0, k
        limit = LAST_LAYER_GNORM_RTOL if k.startswith("1.") else \
            STACK_GNORM_RTOL[name]
        assert np.linalg.norm(a - b) <= limit * np.linalg.norm(b), (
            k, np.linalg.norm(a - b) / np.linalg.norm(b))
    assert any(k.endswith("relpos_bias.rel_embedding") for k in grads)
