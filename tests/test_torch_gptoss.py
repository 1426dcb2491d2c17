"""The port's GPT-OSS family against the JAX package's: the clamped SwiGLU
(forward and backward, ties with the clip included), dense and
layernorm_dense with a bias, GPTOSS_TINY's logits, loss and every
gradient against the reference's eager ``value_and_grad``, cached greedy
``generate`` with prompts longer than the band against the JAX
``generate``, the banded layers' locality, and the paged cache, which
the port refuses for a windowed layer where the reference's drops the
window.

The reference's weights come through ``load_flax_params``, with the
embedding scaled to stddev 0.02 (at the reference's stddev 1 every greedy
step repeats its token) and the biases and sinks, which the reference
initializes at zero, drawn at random so that they matter. Routing is
discontinuous: each comparison holds both sides' routing maps equal and
every token's gap between its 2nd and 3rd router logit above the
difference of those logits between the sides (seed 41 keeps every gap
away from 0)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from transformerengine_tpu.dense import dense as j_dense
from transformerengine_tpu.inference import (
    InferenceParams as JParams, generate as j_generate)
from transformerengine_tpu.layernorm_dense import (
    layernorm_dense as j_ln_dense)
from transformerengine_tpu.layernorm_mlp import layernorm_mlp as j_ln_mlp
from transformerengine_tpu.models.gptoss import (
    GPTOSS_TINY as J_TINY, GptOssModel as JGptOss, gptoss_loss as j_loss)
from transformerengine_tpu.ops.activation import (
    act_lu as j_act_lu, dact_lu as j_dact_lu)
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.inference import InferenceParams, generate
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.models.gptoss import (
    GPTOSS_TINY, GptOssModel, gptoss_loss, layer_window, load_flax_params)
from transformerengine_tpu_torch.ops.activation import (
    act_lu, clamped_swiglu, dact_lu, is_gated, normalize_activation_type)

torch.set_num_threads(2)

B, S, SEED = 2, 48, 41
# Prompts longer than GPTOSS_TINY's window of 32.
PROMPT, PROMPT_LENS, NEW = 48, (48, 40), 6

# The forward: bf16 roundings of GEMMs summed in another order, the
# flash plain version against the Pallas kernel (reading 1.5e-3 of the
# largest logit).
LOGITS_RTOL = 2 ** -6
# The bf16 step: the loss (reading 1.9e-6) and each gradient relative to
# its largest element (readings up to 1.23e-2, the second layer's router
# kernel: a sum over every token of terms with one-ulp bf16 roundings).
LOSS_ATOL = 2e-4
GRAD_RTOL = 2 ** -5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(x: np.ndarray, dtype=jnp.bfloat16, grad=True):
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return xj, xt.requires_grad_(grad)


# ---------------------------------------------------------------------------
# Clamped SwiGLU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_clamped_swiglu_matches_reference(dtype):
    """Forward and backward over [..., 2, H], with inputs exactly at the
    clip bounds +-7 (exact in bf16), where JAX's ``minimum`` and ``clip``
    give half the gradient (``lax.min``'s balanced JVP); through
    ``act_lu``/``dact_lu`` and through autograd."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2, 64)).astype(np.float32) * 5
    x[0, 0, :8] = [7, -7, 7, 8, 6.5, -9, 7, 0]
    x[0, 1, :8] = [7, -7, -7, 7, 9, -8, 0.5, 7]
    dz = rng.standard_normal((6, 64)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    dzj, dzt = _pair(dz, dtype, grad=False)
    oj = j_act_lu(xj, "clamped_swiglu")
    dxj = j_dact_lu(dzj, xj, "clamped_swiglu")
    ot = act_lu(xt, "clamped_swiglu")
    dxt = dact_lu(dzt, xt.detach(), "clamped_swiglu")
    assert normalize_activation_type("clamped_swiglu") == ("clamped_swiglu",)
    assert is_gated("clamped_swiglu") and is_gated("swiglu")
    assert not is_gated("silu")
    # f32: sigmoid and the products in f32 on both sides, to a few ulps;
    # bf16: the results round once to bf16 from those, an ulp (2^-8)
    # apart at most (both read equal, element for element).
    tol = 1e-6 if dtype == jnp.float32 else 2 ** -8
    for got, ref in ((ot, oj), (dxt, dxj)):
        ref = _np(ref)
        assert got.dtype == xt.dtype and got.shape == ref.shape
        np.testing.assert_allclose(_np(got), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
    clamped_swiglu(xt).backward(dzt)
    np.testing.assert_array_equal(_np(xt.grad), _np(dxt))
    # At the ties the gradient is half the inside one: x0 = 7 (the min)
    # and x1 = +-7 (the clip) against a neighbour just inside, in f32.
    if dtype == jnp.float32:
        g = _np(dxj)
        dzn = dz[0, :8]
        np.testing.assert_array_equal(g[0, 1, :3] == 0, [False] * 3)
        assert g[0, 0, 3] == 0 and g[0, 1, 4] == 0 and g[0, 1, 5] == 0
        np.testing.assert_allclose(_np(dxt)[0, 1, 0],
                                   0.5 * dzn[0] * (7 / (1 + np.exp(
                                       -1.702 * 7))), rtol=1e-6)


def test_layernorm_mlp_takes_the_clamped_swiglu():
    """The dense MLP with the sentinel: two FFN halves in the up
    projection, forward and backward against the reference's
    layernorm_mlp (the unbiased layers' tolerance, 2^-6 of each output's
    largest element; readings equal but dgamma, 1.3e-7)."""
    rng = np.random.default_rng(4)
    h, ffn = 64, 96
    xj, xt = _pair(rng.standard_normal((2, 16, h)))
    gmj, gmt = _pair(1 + 0.1 * rng.standard_normal(h), jnp.float32)
    w1j, w1t = _pair(rng.standard_normal((h, 2, ffn)) / 2)
    w2j, w2t = _pair(rng.standard_normal((ffn, h)) / 10)
    gj, gt = _pair(rng.standard_normal((2, 16, h)), grad=False)
    oj, vjp = jax.vjp(lambda x, gm, w1, w2: j_ln_mlp(
        x, gm, None, w1, w2, norm_type="rmsnorm",
        activation_type="clamped_swiglu"), xj, gmj, w1j, w2j)
    grads_j = vjp(gj)
    ot = layernorm_mlp(xt, gmt, w1t, w2t, activation_type="clamped_swiglu")
    ot.backward(gt)
    for got, ref in zip((ot, xt.grad, gmt.grad, w1t.grad, w2t.grad),
                        (oj,) + tuple(grads_j)):
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=2 ** -6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Biased projections
# ---------------------------------------------------------------------------

# As the unbiased layers' tests: one-ulp bf16 differences of GEMMs summed
# in another order, passed on through one more product in the norm's
# backward; the bias's gradient is a sum over 48 rows (readings: dense
# equal, layernorm_dense below 2e-7).
OUT_RTOL = 2 ** -7
GRAD_RTOL_LAYER = 2 ** -6


def _close(got, ref, rtol):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def test_dense_with_bias_matches_reference():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 24, 64)))
    kj, kt = _pair(rng.standard_normal((64, 48)) / 8)
    bj, bt = _pair(rng.standard_normal(48))
    gj, gt = _pair(rng.standard_normal((2, 24, 48)), grad=False)
    oj, vjp = jax.vjp(lambda x, k, b: j_dense(x, k, b), xj, kj, bj)
    dxj, dkj, dbj = vjp(gj)
    ot = dense(xt, kt, bt)
    ot.backward(gt)
    assert bt.grad.dtype == torch.bfloat16 and bt.grad.shape == (48,)
    _close(ot, oj, OUT_RTOL)
    _close(xt.grad, dxj, OUT_RTOL)
    _close(kt.grad, dkj, OUT_RTOL)
    _close(bt.grad, dbj, GRAD_RTOL_LAYER)
    # The bias is added to the f32 product before the one rounding: the
    # output equals round(x.k in f32 + b), not round(round(x.k) + b).
    with torch.no_grad():
        f32 = xt.float().reshape(-1, 64) @ kt.float() + bt.float()
        torch.testing.assert_close(
            dense(xt, kt, bt).reshape(-1, 48), f32.to(torch.bfloat16),
            rtol=0, atol=0)


def test_layernorm_dense_with_bias_matches_reference():
    rng = np.random.default_rng(2)
    h = 64
    xj, xt = _pair(rng.standard_normal((2, 24, h)) * 2)
    kj, kt = _pair(rng.standard_normal((h, 80)) / 8)
    gmj, gmt = _pair(rng.standard_normal(h) * 0.1 + 1, jnp.float32)
    bj, bt = _pair(rng.standard_normal(80))
    gj, gt = _pair(rng.standard_normal((2, 24, 80)), grad=False)
    oj, vjp = jax.vjp(lambda x, k, gm, b: j_ln_dense(
        x, k, gm, None, b, norm_type="rmsnorm", epsilon=1e-5),
        xj, kj, gmj, bj)
    dxj, dkj, dgj, dbj = vjp(gj)
    ot = layernorm_dense(xt, kt, gmt, bias=bt, epsilon=1e-5)
    ot.backward(gt)
    _close(ot, oj, OUT_RTOL)
    for got, ref in ((xt.grad, dxj), (kt.grad, dkj), (gmt.grad, dgj),
                     (bt.grad, dbj)):
        _close(got, ref, GRAD_RTOL_LAYER)


# ---------------------------------------------------------------------------
# GPTOSS_TINY
# ---------------------------------------------------------------------------

def _tokens(seed=SEED):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, J_TINY.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return tok, tgt


def _perturbed(params, rng):
    """The reference's zero-initialized biases and sinks drawn at random
    (stddev 0.1 and 1), and the embedding scaled to stddev 0.02."""
    out = {}
    for name, sub in params.items():
        if isinstance(sub, dict):
            out[name] = _perturbed(sub, rng)
        elif name in ("bias", "softmax_offset"):
            std = 1.0 if name == "softmax_offset" else 0.1
            out[name] = (rng.standard_normal(sub.shape) * std).astype(
                sub.dtype)
        elif name == "embedding":
            out[name] = (sub.astype(np.float32) * 0.02).astype(sub.dtype)
        else:
            out[name] = sub
    return out


@functools.lru_cache(maxsize=None)
def _params(config=J_TINY):
    tok = jnp.asarray(_tokens()[0])
    variables = JGptOss(config=config).init(jax.random.PRNGKey(5), tok)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    return _perturbed(params, np.random.default_rng(6))


def _model(config=GPTOSS_TINY, jconfig=J_TINY):
    model = GptOssModel(config, device="cpu", seed=0)
    model.load_state_dict(load_flax_params(_params(jconfig), config,
                                           device="cpu"))
    return model


@functools.lru_cache(maxsize=None)
def _reference():
    """Loss, gradients (numpy tree), logits and each MoE layer's normed
    input, from one eager ``value_and_grad`` of ``gptoss_loss``'s body."""
    jm = JGptOss(config=J_TINY)
    tok, tgt = (jnp.asarray(a) for a in _tokens())
    p = jax.tree.map(jnp.asarray, _params())
    seen = {}

    def loss_fn(p):
        logits, state = jm.apply({"params": p}, tok,
                                 mutable=["intermediates"],
                                 capture_intermediates=True)
        from transformerengine_tpu.models.llama import cross_entropy_loss
        from transformerengine_tpu.models.mixtral import collect_aux_loss
        loss = cross_entropy_loss(logits, tgt) + collect_aux_loss(
            state["intermediates"])
        return loss, (logits, state["intermediates"])

    (loss, (logits, inter)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(p)
    # gptoss_loss is that body; the two agree.
    np.testing.assert_allclose(
        float(j_loss(jm, {"params": p}, tok, tgt)), float(loss), rtol=1e-6)
    ln = [np.asarray(inter[f"layer_{i}"]["mlp"]["ln"]["__call__"][0],
                     np.float32).reshape(-1, J_TINY.hidden_size)
          for i in range(J_TINY.num_layers)]
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
    return float(loss), grads, np.asarray(logits, np.float32), ln


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
    seen = []
    hooks = [layer.mlp.ln.register_forward_hook(
        lambda mod, args, out: seen.append(
            out.detach().float().reshape(-1, out.shape[-1]).numpy()))
        for layer in model.layers]
    return seen, hooks


def _assert_same_routing(ln_port, ln_ref):
    """Both sides select the same top-2 experts for every token, and each
    token's 2nd-to-3rd gap exceeds its router logits' difference."""
    for i, (a, r) in enumerate(zip(ln_port, ln_ref)):
        kernel = _params()[f"layer_{i}"]["mlp"]["router_kernel"]
        la, lr = a @ kernel, r @ kernel
        top = lambda l: np.sort(np.argsort(-l, axis=1)[:, :2], axis=1)
        np.testing.assert_array_equal(top(la), top(lr), err_msg=f"layer {i}")
        s = -np.sort(-lr, axis=1)
        gap = s[:, 1] - s[:, 2]
        assert (gap > np.abs(la - lr).max(axis=1)).all(), i


def test_forward_logits_match():
    _, _, logits_j, ln_j = _reference()
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
    # aux_loss_coeff is 0: the aux loss is an exact zero, as the
    # reference's.
    assert float(aux) == 0.0
    # Layer 0 is banded, layer 1 full, every layer has a learnable sink.
    assert [layer_window(GPTOSS_TINY, i) for i in range(2)] == [(32, 0), None]
    assert model.layers[0].self_attention.window_size == (32, 0)
    assert model.layers[1].self_attention.window_size is None


def test_bf16_step_loss_and_grads_match():
    loss_j, grads_j, _, ln_j = _reference()
    model = _model()
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    seen, hooks = _routing_inputs(model)
    loss = gptoss_loss(model, tok, tgt)
    loss.backward()
    for h in hooks:
        h.remove()
    _assert_same_routing(seen, ln_j)
    grads_j = _flat(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(grads_j)
    assert abs(float(loss.detach()) - loss_j) <= LOSS_ATOL
    for name, p in named.items():
        ref = grads_j[name]
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        err = np.abs(p.grad.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)
    # The sinks and biases take part: their gradients are not zero.
    for name in named:
        if name.endswith(("softmax_offset", "bias")):
            assert float(named[name].grad.abs().max()) > 0, name


def _prompts():
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 200, (B, PROMPT)).astype(np.int32)
    return tokens, np.array(PROMPT_LENS, np.int32)


def test_cached_greedy_generate_matches_jax():
    """Prompts of 48 and 40 tokens against the window of 32: cached
    greedy tokens (bf16 cache) equal the JAX ``generate``'s and the
    port's own full recompute."""
    tokens, lengths = _prompts()
    got_j = np.asarray(j_generate(
        JGptOss(config=J_TINY),
        {"params": jax.tree.map(jnp.asarray, _params())},
        jnp.asarray(tokens), jnp.asarray(lengths), NEW))
    model = _model()
    got = generate(model, torch.from_numpy(tokens),
                   torch.from_numpy(lengths), NEW, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), got_j)
    for i in range(B):
        seq = torch.from_numpy(tokens[i, :lengths[i]])
        with torch.no_grad():
            for _ in range(NEW):
                nxt = model(seq[None])[0, -1].argmax().to(torch.int32)
                seq = torch.cat([seq, nxt[None]])
        np.testing.assert_array_equal(seq[lengths[i]:].numpy(),
                                      got[i].numpy())


def test_banded_layer_ignores_distant_context():
    """The reference test's locality check on the port: a one-layer
    stack (banded, window 32) gives position 63 a logit that does not
    depend on token 0, and position 16 one that does."""
    cfg = dataclasses.replace(GPTOSS_TINY, num_layers=1)
    model = GptOssModel(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, 256, (1, 64)).astype(np.int32))
    perturbed = tokens.clone()
    perturbed[0, 0] = (tokens[0, 0] + 7) % 255 + 1
    with torch.no_grad():
        base, out = model(tokens), model(perturbed)
    assert float((out[0, 63] - base[0, 63]).abs().max()) < 1e-5
    assert float((out[0, 16] - base[0, 16]).abs().max()) > 1e-6


def test_paged_cache_refuses_a_windowed_layer():
    tokens, lengths = _prompts()
    model = _model()
    ip = InferenceParams(B, PROMPT + NEW, is_paged=True, page_size=16)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        generate(model, torch.from_numpy(tokens), torch.from_numpy(lengths),
                 NEW, inference_params=ip, device="cpu")
    # Without the window the same layers serve from the paged cache.
    plain = _model()
    plain.layers[0].self_attention.window_size = None
    out = generate(plain, torch.from_numpy(tokens),
                   torch.from_numpy(lengths), 2, inference_params=ip,
                   device="cpu")
    assert out.shape == (B, 2)


def test_reference_paged_generate_drops_the_window():
    """The reference's fault that the port refuses: its paged path calls
    the flash prefill and the paged decode without the layer's window, so
    on a prompt longer than the band its paged ``generate`` leaves its own
    contiguous one (and the prefill's logits past the band differ from
    the uncached forward's, while those within it agree)."""
    tokens, lengths = _prompts()
    jm = JGptOss(config=J_TINY)
    variables = {"params": jax.tree.map(jnp.asarray, _params())}
    contiguous = np.asarray(j_generate(jm, variables, jnp.asarray(tokens),
                                       jnp.asarray(lengths), NEW))
    paged = np.asarray(j_generate(
        jm, variables, jnp.asarray(tokens), jnp.asarray(lengths), NEW,
        inference_params=JParams(B, PROMPT + NEW, is_paged=True,
                                 page_size=16)))
    assert not np.array_equal(paged, contiguous)

    def prefill_logits(ip):
        from transformerengine_tpu.attention import SequenceDescriptor
        desc = SequenceDescriptor.from_seqlens(jnp.asarray(lengths))
        out, _ = jm.apply(variables, jnp.asarray(tokens), desc,
                          inference_params=ip,
                          mutable=["cache", "intermediates"])
        return np.asarray(out, np.float32)

    full = np.asarray(jm.apply(variables, jnp.asarray(tokens[:1]),
                               mutable=["intermediates"])[0], np.float32)
    got = prefill_logits(JParams(B, PROMPT + NEW, is_paged=True,
                                 page_size=16))[:1]
    near = np.abs(got[0, :33] - full[0, :33]).max()
    far = np.abs(got[0, 33:] - full[0, 33:]).max()
    assert near < 2e-2 * np.abs(full).max() < far


def test_load_flax_params_round_trip():
    """Every reference parameter (sinks and biases included) maps to one
    port parameter of the same shape and value (router kernels, norm
    scales and sinks in f32, the rest in bf16)."""
    flat = _flat(_params())
    state = load_flax_params(_params(), GPTOSS_TINY, device="cpu")
    model = GptOssModel(GPTOSS_TINY, device="cpu", seed=1)
    named = dict(model.named_parameters())
    assert set(state) == set(flat) == set(named)
    assert {n for n in named if n.endswith(("bias", "softmax_offset"))} == {
        f"layers.{i}.self_attention.{n}" for i in range(2)
        for n in ("qkv.bias", "out.bias", "softmax_offset")}
    model.load_state_dict(state)
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith(
            ("scale", "router_kernel", "softmax_offset")) else torch.bfloat16
        assert p.dtype == want and tuple(p.shape) == flat[name].shape, name
        np.testing.assert_array_equal(p.detach().float().numpy(), flat[name])
