"""Dropout in the port's layers against the JAX package on the CPU:
``DotProductAttention``, ``MultiHeadAttention``, ``TransformerLayer`` and
``LayerNormMLP`` take the reference's ``attention_dropout``,
``hidden_dropout``, ``drop_path`` and ``intermediate_dropout_rate``.

At ``deterministic=True`` (the default) and at rates 0 they compute the
reference's function. With attention dropout in training they match the
reference's forward and gradients on the seed words the reference's layer
draws (captured from its ``fused_attn`` and handed to the port in place of
the words it draws from its generator). Hidden, intermediate and drop-path
dropout draw from the port's ``torch.Generator`` (the reference's bits are
flax's and not copied): they are held by their keep rate within a
binomial bound, by the 1 / keep rescale, by drop path's whole-sample mask
and by the order of the draws. ``DelayedScaling(fp8_dpa, fp8_mha)`` runs
no FP8 attention under dropout on either side, and a training call with a
rate above 0 and no generator raises. The weights are drawn with numpy
from the shapes of the reference's ``init``; the reference runs eagerly,
its Pallas kernels in interpret mode."""
import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
import transformerengine_tpu.flax.transformer as j_tr
from test_torch_encoder import (
    B, FFN, HEADS, HIDDEN, KV_HEADS, LENS, S, _branches, _draw, _hold_loss,
    _no_reference_fp8_attention, _np, _readout)
from transformerengine_tpu.attention import (
    AttnMaskType as JMask, SequenceDescriptor as JDesc)
from transformerengine_tpu.flax.module import LayerNormMLP as JLayerNormMLP
from transformerengine_tpu.flax.transformer import (
    DotProductAttention as JDPA, MultiHeadAttention as JMHA,
    TransformerLayer as JLayer)
import transformerengine_tpu_torch as tt
import transformerengine_tpu_torch.nn.transformer as t_tr
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor)
from transformerengine_tpu_torch.nn.module import LayerNormMLP, dropout
from transformerengine_tpu_torch.nn.transformer import (
    DotProductAttention, MultiHeadAttention, TransformerLayer, flax_state)
from transformerengine_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

D = HIDDEN // HEADS
RATE = 0.2
# Gradients in norm against the reference's, as the encoder's MHA test
# holds them: bf16 layers whose attention rounds at other places.
GRAD_RTOL = 2e-2


@contextlib.contextmanager
def _capture_reference_seeds(seen: list):
    """Records the seed words of each reference fused_attn call, as the
    reference's flash wrapper reads them ((2,) int32)."""
    real = j_tr.fused_attn

    def hook(*args, **kw):
        seed = kw.get("seed")
        if seed is not None:
            words = np.asarray(jax.random.key_data(seed)
                               if jnp.issubdtype(seed.dtype,
                                                 jax.dtypes.prng_key)
                               else seed)
            seen.append(words.astype(np.uint32).view(np.int32).copy())
        return real(*args, **kw)
    j_tr.fused_attn = hook
    try:
        yield
    finally:
        j_tr.fused_attn = real


def _handing(monkeypatch, words: list):
    """The port's layers draw these seed words, in order, in place of
    their generator's."""
    it = iter(words)
    monkeypatch.setattr(t_tr, "draw_seed",
                        lambda generator: torch.from_numpy(next(it)))


def _inputs(rng):
    x = (rng.standard_normal((B, S, HIDDEN)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    lens = np.asarray(LENS, np.int32)
    return (xj, xt, lens, JDesc.from_seqlens(jnp.asarray(lens)),
            SequenceDescriptor.from_seqlens(torch.from_numpy(lens)))


def _hold_grads(grads: dict, ref: dict) -> None:
    for k in ref:
        a, b = _np(grads[k]), _np(ref[k])
        assert np.linalg.norm(a - b) <= GRAD_RTOL * np.linalg.norm(b), (
            k, np.linalg.norm(a - b) / np.linalg.norm(b))


def _layer_kw():
    return dict(num_gqa_groups=KV_HEADS, layernorm_epsilon=1e-5,
                norm_type="layernorm")


def _port_module(kind: str, attention_dropout=RATE, hidden_dropout=0.0,
                 drop_path=0.0):
    if kind == "mha":
        return MultiHeadAttention(HIDDEN, HEADS, attn_mask_type=(
            AttnMaskType.PADDING), attention_dropout=attention_dropout,
            device="cpu", **_layer_kw())
    return TransformerLayer(HIDDEN, FFN, HEADS, mlp_activations=("gelu",),
                            self_attn_mask_type=AttnMaskType.PADDING,
                            enable_relative_embedding=True,
                            attention_dropout=attention_dropout,
                            hidden_dropout=hidden_dropout,
                            drop_path=drop_path, device="cpu", **_layer_kw())


def _reference_module(kind: str, attention_dropout=RATE, hidden_dropout=0.0,
                      drop_path=0.0):
    kw = dict(num_attention_heads=HEADS, num_gqa_groups=KV_HEADS,
              layernorm_epsilon=1e-5, norm_type="layernorm",
              attention_dropout=attention_dropout)
    if kind == "mha":
        return JMHA(hidden_size=HIDDEN, attn_mask_type=JMask.PADDING, **kw)
    return JLayer(hidden_size=HIDDEN, mlp_hidden_size=FFN,
                  mlp_activations=("gelu",),
                  self_attn_mask_type=JMask.PADDING,
                  enable_relative_embedding=True,
                  hidden_dropout=hidden_dropout, drop_path=drop_path, **kw)


@pytest.mark.parametrize("kind", ["mha", "layer"])
def test_attention_dropout_matches_the_reference(kind, monkeypatch):
    """MultiHeadAttention and an encoder TransformerLayer (LayerNorm,
    GELU, padding lengths, the relative bias) trained with attention
    dropout: the read-out and every gradient against the reference's
    value_and_grad on the seed words its layer draws; one seed a call."""
    rng = np.random.default_rng(91 if kind == "mha" else 92)
    xj, xt, lens, desc_j, desc_t = _inputs(rng)
    r = _readout(rng)
    jm = _reference_module(kind)
    shapes = fnn.meta.unbox(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), xj, None, desc_j)))
    params = jax.tree.map(np.asarray, _draw(shapes, rng)["params"])
    seeds = []

    def fj(p, x):
        y = jm.apply({"params": p}, x, None, desc_j, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(7)})
        return (y.astype(jnp.float32) * r).sum() / lens.sum()

    with _capture_reference_seeds(seeds):
        loss_j, (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1))(
            jax.tree.map(jnp.asarray, params), xj)
    assert len(seeds) == 1
    mt = _port_module(kind)
    mt.load_state_dict(flax_state(params, torch.bfloat16, "cpu"))
    _handing(monkeypatch, seeds)
    seen = collections.Counter()
    rates = []
    real_fwd = fa.flash_fwd

    def fwd(*a, **kw):
        rates.append(kw.get("dropout_probability"))
        return real_fwd(*a, **kw)
    monkeypatch.setattr(fa, "flash_fwd", fwd)
    leaf = xt.clone().requires_grad_(True)
    with _branches(seen):
        y = mt(leaf, desc_t, deterministic=False,
               generator=torch.Generator().manual_seed(0))
        loss_t = (y.float() * torch.from_numpy(r)).sum() / lens.sum()
        loss_t.backward()
    term = "bias" if kind == "layer" else "bf16"
    assert dict(seen) == {f"fwd_{term}": 1, f"bwd_{term}": 1}, seen
    assert rates == [RATE]
    _hold_loss(loss_t, loss_j, y, r, lens.sum())
    grads = {k: p.grad for k, p in mt.named_parameters()}
    ref = dict(flax_state(gp, None, "cpu"))
    ref["x"], grads["x"] = torch.from_numpy(np.asarray(
        gx.astype(jnp.float32))), leaf.grad
    _hold_grads(grads, ref)
    # The test has teeth: other seed words move the read-out well past
    # the limit.
    _handing(monkeypatch, [seeds[0] + np.int32(1)])
    with torch.no_grad():
        y2 = mt(xt, desc_t, deterministic=False,
                generator=torch.Generator())
    moved = abs(float((y2.float() * torch.from_numpy(r)).sum()
                      / lens.sum()) - float(loss_j))
    size = float((y.detach().float() * torch.from_numpy(r)).norm()) / \
        lens.sum()
    assert moved > 4 * 2 ** -6 * size, (moved, size)


def test_dot_product_attention_matches_the_reference(monkeypatch):
    """DotProductAttention alone, causal over BSHD q, k, v with GQA and a
    learnable sink: at deterministic=True (its dropout rate set) and in
    training with attention dropout on the reference's seed words, output
    and the gradients of q, k, v and the sink."""
    rng = np.random.default_rng(93)
    shapes = ((B, S, HEADS, D), (B, S, KV_HEADS, D), (B, S, KV_HEADS, D))
    qkv_j = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
             for s in shapes]
    qkv_t = [torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(
        torch.bfloat16) for t in qkv_j]
    r = rng.standard_normal((B, S, HEADS * D)).astype(np.float32)
    sink = (rng.standard_normal(HEADS) * 0.5).astype(np.float32)
    from transformerengine_tpu.attention import SoftmaxType as JSoftmax
    from transformerengine_tpu_torch.attention import SoftmaxType
    jm = JDPA(head_dim=D, num_attention_heads=HEADS, num_gqa_groups=KV_HEADS,
              attention_dropout=RATE, softmax_type=JSoftmax.LEARNABLE)
    mt = DotProductAttention(D, HEADS, num_gqa_groups=KV_HEADS,
                             attention_dropout=RATE,
                             softmax_type=SoftmaxType.LEARNABLE)
    mt.softmax_offset.data.copy_(torch.from_numpy(sink))
    for train in (False, True):
        seeds = []

        def fj(q, k, v, s):
            kw = dict(deterministic=not train)
            if train:
                kw["rngs"] = {"dropout": jax.random.PRNGKey(3)}
            y = jm.apply({"params": {"softmax_offset": s}}, q, k, v, **kw)
            return (y.astype(jnp.float32) * r).sum()

        with _capture_reference_seeds(seeds):
            loss_j, grads_j = jax.value_and_grad(fj, argnums=(0, 1, 2, 3))(
                *qkv_j, jnp.asarray(sink))
        assert len(seeds) == int(train)
        _handing(monkeypatch, seeds)
        leaves = [t.clone().requires_grad_(True) for t in qkv_t]
        mt.zero_grad(set_to_none=True)
        y = mt(*leaves, deterministic=not train,
               generator=torch.Generator() if train else None)
        loss_t = (y.float() * torch.from_numpy(r)).sum()
        loss_t.backward()
        size = float((y.detach().float() * torch.from_numpy(r)).norm())
        assert abs(float(loss_t) - float(loss_j)) <= 2 ** -6 * size
        got = {"q": leaves[0].grad, "k": leaves[1].grad, "v": leaves[2].grad,
               "sink": mt.softmax_offset.grad}
        ref = dict(zip(("q", "k", "v", "sink"),
                       (torch.from_numpy(np.asarray(g.astype(jnp.float32)))
                        for g in grads_j)))
        _hold_grads(got, ref)


@pytest.mark.parametrize("kind", ["mha", "layer", "mlp"])
def test_deterministic_and_rate_zero_are_the_reference(kind):
    """With every rate set and ``deterministic=True`` (no generator), and
    with rates 0 in a training call (no generator needed), each module
    computes the reference's deterministic forward."""
    rng = np.random.default_rng(95)
    xj, xt, lens, desc_j, desc_t = _inputs(rng)
    if kind == "mlp":
        jm = JLayerNormMLP(intermediate_dim=FFN, activations=("gelu",),
                           intermediate_dropout_rate=RATE, use_bias=False)
        shapes = fnn.meta.unbox(jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), xj)))
        params = jax.tree.map(np.asarray, _draw(shapes, rng)["params"])
        ref = jm.apply({"params": params}, xj)

        def port(rate):
            m = LayerNormMLP(HIDDEN, FFN, activations=("gelu",),
                             intermediate_dropout_rate=rate, device="cpu")
            m.load_state_dict(flax_state(params, torch.bfloat16, "cpu"))
            return m
        outs = [port(RATE)(xt), port(0.0)(xt, deterministic=False)]
    else:
        jm = _reference_module(kind, RATE, RATE, RATE) if kind == "layer" \
            else _reference_module(kind)
        shapes = fnn.meta.unbox(jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), xj, None, desc_j)))
        params = jax.tree.map(np.asarray, _draw(shapes, rng)["params"])
        ref = jm.apply({"params": params}, xj, None, desc_j)
        outs = []
        for rates, det in (((RATE, RATE, RATE), True), ((0.0,) * 3, False)):
            m = _port_module(kind, *rates)
            m.load_state_dict(flax_state(params, torch.bfloat16, "cpu"))
            outs.append(m(xt, desc_t, deterministic=det))
    r = _np(ref)
    for out in outs:
        with torch.no_grad():
            np.testing.assert_allclose(_np(out), r, rtol=0,
                                       atol=2 ** -6 * np.abs(r).max())


def _keep_bound(n: int, rate: float) -> float:
    """Five binomial standard deviations of a keep share over n draws."""
    return 5 * np.sqrt(rate * (1 - rate) / n)


def test_hidden_dropout_keep_rate_and_rescale():
    """``dropout`` keeps a share 1 - rate within the binomial bound,
    divides the kept values by 1 - rate (in the input's dtype) and zeroes
    the rest; the same generator state draws the same mask."""
    x = torch.rand((64, 1000), dtype=torch.float32) + 0.5
    for rate in (0.1, 0.5):
        g = torch.Generator().manual_seed(5)
        y = dropout(x, rate, g)
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - rate)) <= \
            _keep_bound(x.numel(), rate)
        assert torch.equal(y[kept], x[kept] / (1 - rate))
        again = dropout(x, rate, torch.Generator().manual_seed(5))
        assert torch.equal(y, again)
    xb = x.to(torch.bfloat16)
    yb = dropout(xb, 0.1, torch.Generator().manual_seed(1))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], xb[yb != 0] / 0.9)


def test_drop_path_drops_whole_samples():
    """Drop path keeps or drops each sample's whole branch, a share
    1 - rate within the binomial bound, the kept ones divided by it."""
    x = torch.rand((4000, 3, 5)) + 0.5
    rate = 0.3
    y = t_tr._drop_path(x, rate, torch.Generator().manual_seed(2))
    per_sample = (y != 0).reshape(4000, -1)
    assert bool((per_sample.all(1) | ~per_sample.any(1)).all())
    kept = per_sample.all(1)
    assert abs(float(kept.float().mean()) - (1 - rate)) <= \
        _keep_bound(4000, rate)
    assert torch.equal(y[kept], x[kept] / (1 - rate))


def test_transformer_layer_draws_in_the_references_order():
    """A training call with attention, hidden and drop-path dropout is the
    composition the reference's layer makes: the attention (its seed
    words first), hidden dropout and drop path on its branch, then the
    MLP branch's, all from one generator in that order."""
    rng = np.random.default_rng(97)
    _, xt, _, _, desc_t = _inputs(rng)
    layer = TransformerLayer(HIDDEN, FFN, HEADS, attention_dropout=0.1,
                             hidden_dropout=0.2, drop_path=0.3,
                             self_attn_mask_type=AttnMaskType.PADDING,
                             device="cpu", generator=torch.Generator()
                             .manual_seed(1), **_layer_kw())
    with torch.no_grad():
        y = layer(xt, desc_t, deterministic=False,
                  generator=torch.Generator().manual_seed(11))
        g = torch.Generator().manual_seed(11)
        a = layer.self_attention(xt, desc_t, deterministic=False,
                                 generator=g)
        x1 = xt + t_tr._drop_path(dropout(a, 0.2, g), 0.3, g)
        m = layer.mlp(x1)
        want = x1 + t_tr._drop_path(dropout(m, 0.2, g), 0.3, g)
        det = layer(xt, desc_t)
    assert torch.equal(y, want)
    assert not torch.equal(y, det)


def test_intermediate_dropout_runs_the_unfused_chain():
    """LayerNormMLP with ``intermediate_dropout_rate`` in training: the
    norm, the up projection, the activation, dropout from the generator
    and the down projection, as the reference's unfused chain (GeGLU: the
    gated pair), its gradients flowing to both kernels. The reference's
    chain keeps a (..., 1, H) axis for a non-gated activation and returns
    (B, S, 1, H); the port returns (B, S, H), equal to it along that axis
    (ROADMAP.md, Queue 3)."""
    from transformerengine_tpu_torch.dense import dense
    from transformerengine_tpu_torch.layernorm import layernorm
    from transformerengine_tpu_torch.ops.activation import act_lu
    rng = np.random.default_rng(98)
    xj, xt, *_ = _inputs(rng)
    m = LayerNormMLP(HIDDEN, FFN, activations=("gelu", "linear"),
                     intermediate_dropout_rate=0.25, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    y = m(xt, deterministic=False, generator=torch.Generator().manual_seed(8))
    y.float().sum().backward()
    assert m.wi_kernel.grad is not None and m.wo_kernel.grad is not None
    with torch.no_grad():
        n = layernorm(xt, m.scale, m.ln_bias, "layernorm", False, 1e-6)
        a = dense(n, m.wi_kernel.reshape(HIDDEN, 2 * FFN)).reshape(
            B, S, 2, FFN)
        act = act_lu(a, ("gelu", "linear"))
        want = dense(dropout(act, 0.25, torch.Generator().manual_seed(8)),
                     m.wo_kernel)
    assert torch.equal(y.detach(), want)
    # The keep share of the intermediate activations.
    mask = dropout(torch.ones_like(act), 0.25,
                   torch.Generator().manual_seed(8)) != 0
    assert abs(float(mask.float().mean()) - 0.75) <= \
        _keep_bound(mask.numel(), 0.25)

    jm = JLayerNormMLP(intermediate_dim=FFN, activations=("gelu",),
                       intermediate_dropout_rate=0.25, use_bias=False)
    shapes = fnn.meta.unbox(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), xj)))
    assert jm.apply(jax.tree.map(jnp.zeros_like, shapes), xj,
                    deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)}).shape == \
        (B, S, 1, HIDDEN)
    mt = LayerNormMLP(HIDDEN, FFN, activations=("gelu",),
                      intermediate_dropout_rate=0.25, device="cpu")
    assert mt(xt, deterministic=False,
              generator=torch.Generator()).shape == (B, S, HIDDEN)


def test_fp8_attention_gates_close_under_dropout():
    """Under DelayedScaling(fp8_dpa, fp8_mha) a training call with
    attention dropout runs its flash attention in bf16 on both sides (the
    reference's FP8 cores are never called), with the dropout rate; the
    same layer at deterministic=True runs the fp8_mha branch."""
    rng = np.random.default_rng(99)
    xj, xt, lens, desc_j, desc_t = _inputs(rng)
    kw = dict(num_gqa_groups=KV_HEADS, layernorm_epsilon=1e-5,
              enable_rotary_pos_emb=True)
    jl = JLayer(hidden_size=HIDDEN, mlp_hidden_size=FFN,
                num_attention_heads=HEADS, attention_dropout=RATE, **kw)
    with te.autocast(recipe=te.DelayedScaling(fp8_dpa=True, fp8_mha=True)):
        shapes = fnn.meta.unbox(jax.eval_shape(
            lambda: jl.init(jax.random.PRNGKey(0), xj)))
        variables = _draw(shapes, rng)
        with _no_reference_fp8_attention():
            jl.apply(variables, xj, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(1)})
    layer = TransformerLayer(HIDDEN, FFN, HEADS, attention_dropout=RATE,
                             device="cpu", **kw)
    recipe = tt.DelayedScaling(fp8_dpa=True, fp8_mha=True)
    for det in (False, True):
        seen = collections.Counter()
        with tt.autocast(recipe=recipe), _branches(seen):
            y = layer(xt.clone().requires_grad_(True), deterministic=det,
                      generator=torch.Generator())
            y.float().sum().backward()
        want = {"fwd_fp8": 1, "bwd_fp8": 1} if det else \
            {"fwd_bf16": 1, "bwd_bf16": 1}
        assert dict(seen) == want, (det, seen)


def test_training_with_dropout_needs_a_generator():
    """A training call with a rate above 0 and no generator raises, in
    every module; deterministic calls and rates 0 need none."""
    xt = torch.zeros((B, 8, HIDDEN), dtype=torch.bfloat16)
    q = torch.zeros((B, 8, HEADS, D), dtype=torch.bfloat16)
    kv = torch.zeros((B, 8, KV_HEADS, D), dtype=torch.bfloat16)
    dpa = DotProductAttention(D, HEADS, num_gqa_groups=KV_HEADS,
                              attention_dropout=RATE)
    calls = [
        lambda **kw: dpa(q, kv, kv, **kw),
        lambda **kw: MultiHeadAttention(HIDDEN, HEADS, attention_dropout=RATE,
                                        device="cpu")(xt, **kw),
        lambda **kw: LayerNormMLP(HIDDEN, FFN, intermediate_dropout_rate=RATE,
                                  device="cpu")(xt, **kw),
    ] + [lambda name=name, **kw: TransformerLayer(
        HIDDEN, FFN, HEADS, device="cpu", **{name: RATE})(xt, **kw)
        for name in ("attention_dropout", "hidden_dropout", "drop_path")]
    for call in calls:
        with pytest.raises(ValueError, match="torch.Generator"):
            call(deterministic=False)
        call()
        call(deterministic=False, generator=torch.Generator())
    TransformerLayer(HIDDEN, FFN, HEADS, device="cpu")(xt,
                                                       deterministic=False)
