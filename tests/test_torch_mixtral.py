"""The port's MIXTRAL_TINY against the JAX package's, with the reference's
weights carried by ``load_flax_params`` (the embedding scaled to stddev
0.02, as the Llama tests do: at the reference's stddev 1 every greedy
step repeats its token): the logits and aux loss of the forward, the
bf16 training step (``mixtral_loss``: the loss and every parameter's
gradient) against the reference's eager ``value_and_grad`` of the same
loss, cached
greedy ``generate`` against the JAX ``generate``, and the parameter
names both ways. ``test_torch_mixtral_mxfp8.py`` holds the MXFP8 step
with these helpers.

Routing is discontinuous, so each comparison first holds both sides'
routing maps equal and, without a recipe, every token's gap between its
2nd and 3rd router logit above the difference of those logits between
the sides: the inputs (seed 33) are chosen so that no gap is near 0."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.inference import generate as j_generate
from transformerengine_tpu.models.llama import (
    cross_entropy_loss as j_cross_entropy)
from transformerengine_tpu.models.mixtral import (
    MIXTRAL_TINY as J_TINY, MixtralModel as JMixtral,
    collect_aux_loss as j_collect_aux_loss)
from transformerengine_tpu_torch import MXFP8BlockScaling, autocast
from transformerengine_tpu_torch import moe as t_moe
from transformerengine_tpu_torch.inference import generate
from transformerengine_tpu_torch.models.mixtral import (
    MIXTRAL_TINY, MixtralModel, collect_aux_loss, load_flax_params,
    mixtral_loss)

torch.set_num_threads(2)

B, S, SEED = 2, 64, 33
LOSS_SCALE = 2.0 ** 16

# The forward without a recipe: bf16 roundings of GEMMs summed in
# another order; readings 2.0e-3 of the largest logit, aux loss 3.2e-6.
LOGITS_RTOL = 2 ** -6
AUX_RTOL = 1e-5
# The bf16 step: readings 1.5e-5 (loss) and up to 8.0e-3 of a gradient's
# largest element (the second layer's router kernel).
BF16_LOSS_ATOL = 2e-4
BF16_GRAD_RTOL = 2 ** -5


def _tokens():
    rng = np.random.default_rng(SEED)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


@functools.lru_cache(maxsize=None)
def _params():
    tok = jnp.asarray(_tokens()[0])
    variables = JMixtral(config=J_TINY).init(jax.random.PRNGKey(5), tok)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    emb = params["embedding"]
    params["embedding"] = (emb.astype(np.float32) * 0.02).astype(emb.dtype)
    return params


def _model():
    model = MixtralModel(MIXTRAL_TINY, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(_params(), MIXTRAL_TINY,
                                           device="cpu"))
    return model


@functools.lru_cache(maxsize=None)
def _reference(recipe: str):
    """The reference's loss and gradients (numpy tree) of one step, the
    logits and aux loss of its forward, and each MoE layer's normed
    input. The loss is ``mixtral_loss``'s own body (cross entropy plus
    ``collect_aux_loss`` of the sown aux losses), its apply also
    capturing the intermediates, so that one eager ``value_and_grad``
    gives them all."""
    jm = JMixtral(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    p = jax.tree.map(jnp.asarray, _params())
    scale = LOSS_SCALE if recipe == "mxfp8" else 1.0

    def loss_fn(p):
        logits, state = jm.apply({"params": p}, tok,
                                 mutable=["intermediates"],
                                 capture_intermediates=True)
        loss = j_cross_entropy(logits, tgt) + j_collect_aux_loss(
            state["intermediates"])
        return loss * scale, (logits, state["intermediates"])

    with te.autocast(enabled=recipe == "mxfp8",
                     recipe=te.MXFP8BlockScaling()):
        (loss, (logits, inter)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
    aux = sum(float(np.asarray(inter[f"layer_{i}"]["mlp"]["moe_aux_loss"][0]))
              for i in range(J_TINY.num_layers))
    ln = [np.asarray(inter[f"layer_{i}"]["mlp"]["ln"]["__call__"][0],
                     np.float32).reshape(-1, J_TINY.hidden_size)
          for i in range(J_TINY.num_layers)]
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32) / scale, grads)
    return (float(loss) / scale, grads, np.asarray(logits, np.float32), aux,
            ln)


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


def _routing_inputs(model):
    """A context recording each MoE layer's normed input."""
    seen = []
    hooks = [layer.mlp.ln.register_forward_hook(
        lambda mod, args, out: seen.append(
            out.detach().float().reshape(-1, out.shape[-1]).numpy()))
        for layer in model.layers]
    return seen, hooks


def _assert_same_routing(ln_port, ln_ref, strict: bool = True):
    """Both sides select the same top-2 experts for every token and, with
    ``strict``, each token's 2nd-to-3rd gap exceeds its router logits'
    difference."""
    for i, (a, r) in enumerate(zip(ln_port, ln_ref)):
        kernel = _params()[f"layer_{i}"]["mlp"]["router_kernel"]
        la, lr = a @ kernel, r @ kernel
        top = lambda l: np.sort(np.argsort(-l, axis=1)[:, :2], axis=1)
        np.testing.assert_array_equal(top(la), top(lr), err_msg=f"layer {i}")
        s = -np.sort(-lr, axis=1)
        gap = s[:, 1] - s[:, 2]
        assert gap.min() > 0, i
        if strict:
            assert (gap > np.abs(la - lr).max(axis=1)).all(), i


def test_forward_logits_and_aux_loss_match():
    _, _, logits_j, aux_j, ln_j = _reference("bf16")
    model = _model()
    seen, hooks = _routing_inputs(model)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(_tokens()[0]),
                            return_aux_loss=True)
    for h in hooks:
        h.remove()
    _assert_same_routing(seen, ln_j)
    assert logits.dtype == torch.float32 and logits.shape == logits_j.shape
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0,
                               atol=LOGITS_RTOL * np.abs(logits_j).max())
    assert aux.dim() == 0 and float(aux) > 0
    np.testing.assert_allclose(float(aux), aux_j, rtol=AUX_RTOL)
    # Without the aux loss the forward returns the logits alone.
    with torch.no_grad():
        alone = model(torch.from_numpy(_tokens()[0]))
    torch.testing.assert_close(alone, logits, rtol=0, atol=0)


def _step(model, recipe: str):
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    scale = LOSS_SCALE if recipe == "mxfp8" else 1.0
    model.zero_grad(set_to_none=True)
    seen, hooks = _routing_inputs(model)
    with autocast(enabled=recipe == "mxfp8", recipe=MXFP8BlockScaling()):
        loss = mixtral_loss(model, tok, tgt)
    (loss * scale).backward()
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for p in model.parameters():
            p.grad /= scale
    return float(loss.detach()), seen


def test_bf16_step_loss_and_grads_match(monkeypatch):
    loss_j, grads_j, _, _, ln_j = _reference("bf16")
    # Each MoE layer reads its group sizes to the host once per step.
    reads = []
    real = t_moe.host_sizes
    monkeypatch.setattr(t_moe, "host_sizes",
                        lambda g: reads.append(1) or real(g))
    model = _model()
    loss, seen = _step(model, "bf16")
    assert len(reads) == MIXTRAL_TINY.num_layers
    _assert_same_routing(seen, ln_j)
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    assert abs(loss - loss_j) <= BF16_LOSS_ATOL
    for name, p in named.items():
        ref = grads_j[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        err = np.abs(p.grad.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= BF16_GRAD_RTOL, (name, err)


def test_cached_greedy_generate_matches_jax():
    """The reference test's serving path (``tests/test_mixtral.py``:
    prompts of 12 and 9 tokens, 4 new ones): cached greedy tokens equal
    the JAX ``generate``'s, and the port's own full recompute."""
    jm = JMixtral(config=J_TINY)
    b, sp, n_new = 2, 12, 4
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 200, (b, sp)).astype(np.int32)
    lengths = np.array([sp, sp - 3], np.int32)
    got_j = np.asarray(j_generate(
        jm, {"params": jax.tree.map(jnp.asarray, _params())},
        jnp.asarray(tokens), jnp.asarray(lengths), n_new))
    model = _model()
    got = generate(model, torch.from_numpy(tokens),
                   torch.from_numpy(lengths), n_new, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), got_j)
    for i in range(b):
        seq = torch.from_numpy(tokens[i, :lengths[i]])
        with torch.no_grad():
            for _ in range(n_new):
                nxt = model(seq[None])[0, -1].argmax().to(torch.int32)
                seq = torch.cat([seq, nxt[None]])
        np.testing.assert_array_equal(seq[lengths[i]:].numpy(), got[i].numpy())


def test_load_flax_params_round_trip():
    """Every reference parameter maps to one port parameter of the same
    shape and value (router kernels and norm scales in f32, the rest in
    bf16), and back."""
    flat = _flat(_params())
    state = load_flax_params(_params(), MIXTRAL_TINY, device="cpu")
    model = MixtralModel(MIXTRAL_TINY, device="cpu", seed=1)
    named = dict(model.named_parameters())
    assert set(state) == set(flat) == set(named)
    model.load_state_dict(state)
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith(("scale", "router_kernel")) \
            else torch.bfloat16
        assert p.dtype == want and tuple(p.shape) == flat[name].shape, name
        np.testing.assert_array_equal(p.detach().float().numpy(), flat[name])
    assert collect_aux_loss([]).item() == 0.0
