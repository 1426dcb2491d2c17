"""Remat (``remat``, ``remat_policy``) and ``scan_layers`` in the port's
LLAMA_TINY and MIXTRAL_TINY (and GPT-OSS's remat): a step under each
policy bit for bit equal
to the step without remat (every gradient and, under DelayedScaling,
every ``*_scale``/``*_amax_history`` buffer; MXFP8 too), a
dropout step drawing from an explicit generator equal with and without
remat (and ``torch.utils.checkpoint`` alone drawing other masks), the
unknown policy's refusal, and a ``scan_layers=True`` reference model's
stacked params and quantize_meta loaded into the port. The port with
remat against the reference with remat is in
test_torch_remat_reference.py."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.flax.module import QUANTIZE_META
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_LLAMA, LlamaModel as JLlama)
from transformerengine_tpu.models.mixtral import (
    MIXTRAL_TINY as J_MIXTRAL, MixtralModel as JMixtral)
from transformerengine_tpu_torch import (DelayedScaling, MXFP8BlockScaling,
                                         autocast)
from transformerengine_tpu_torch import checkpoint_policies as cp
from transformerengine_tpu_torch.models.gptoss import (
    GPTOSS_TINY, GptOssModel, gptoss_loss)
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, cross_entropy_loss, load_flax_params,
    unstack_layers)
from transformerengine_tpu_torch.models.mixtral import (
    MIXTRAL_TINY, MixtralModel, mixtral_loss)
from transformerengine_tpu_torch.nn.transformer import TransformerLayer

torch.set_num_threads(2)

B, S = 2, 32
POLICIES = ["nothing_saveable", "dots", "offload_dots"]


def _tokens(vocab):
    rng = np.random.default_rng(11)
    return (rng.integers(1, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _draw(shapes, rng):
    """Numpy weights of the reference's shapes: kernels at stddev 0.05,
    norm scales 1, the embedding at stddev 0.02; quantize_meta scales 1
    and histories 0."""
    def leaf(path, s):
        name = path[-1].key
        if name.endswith("_scale") or name == "scale":
            return np.ones(s.shape, np.float32).astype(s.dtype)
        if name.endswith("_amax_history"):
            return np.zeros(s.shape, s.dtype)
        std = 0.02 if name == "embedding" else 0.05
        return (rng.standard_normal(s.shape) * std).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _weights(kind: str, scan: bool = False, delayed: bool = False):
    """(params, quantize_meta) numpy trees of the reference's LLAMA_TINY
    or MIXTRAL_TINY (plain or scanned), drawn from its init's shapes."""
    cls, cfg = (JLlama, J_LLAMA) if kind == "llama" else (JMixtral, J_MIXTRAL)
    jm = cls(dataclasses.replace(cfg, scan_layers=scan))
    tok = jnp.zeros((B, S), jnp.int32)
    with te.autocast(enabled=delayed,
                     recipe=te.DelayedScaling(amax_history_len=16)):
        shapes = fnn.meta.unbox(jax.eval_shape(jm.init,
                                               jax.random.PRNGKey(0), tok))
    tree = _draw(shapes, np.random.default_rng(3))
    return tree["params"], tree.get(QUANTIZE_META)


def _port(kind: str, **cfg_kw):
    cfg = dataclasses.replace(LLAMA_TINY if kind == "llama" else MIXTRAL_TINY,
                              **cfg_kw)
    cls = LlamaModel if kind == "llama" else MixtralModel
    model = cls(cfg, device="cpu", seed=0)
    params, _ = _weights(kind)
    model.load_state_dict(load_flax_params(params, cfg, device="cpu"))
    return model


def _recipe(name):
    return {"bf16": None, "delayed": DelayedScaling(amax_history_len=16),
            "mxfp8": MXFP8BlockScaling()}[name]


def _step(model, kind, recipe):
    tok, tgt = (torch.from_numpy(a) for a in _tokens(model.config.vocab_size))
    model.zero_grad(set_to_none=True)
    with autocast(enabled=recipe is not None, recipe=recipe):
        if kind == "llama":
            loss = cross_entropy_loss(model(tok), tgt)
        else:
            loss = mixtral_loss(model, tok, tgt)
    loss.backward()
    return float(loss.detach())


def _readings(model):
    return ({n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("_scale", "_amax_history"))})


STEP_CASES = [("llama", "bf16"), ("llama", "delayed"), ("llama", "mxfp8"),
              ("mixtral", "bf16"), ("mixtral", "mxfp8")]


@pytest.mark.parametrize("kind,recipe", STEP_CASES,
                         ids=[f"{k}-{r}" for k, r in STEP_CASES])
def test_remat_step_is_bitwise_the_step_without_remat(kind, recipe):
    """Under every policy: the loss, every gradient and every delayed
    buffer after the step equal the step without remat bit for bit (the
    second forward reads the scales the first read, and the state rolls
    once). Under DelayedScaling a warm-up step sets the state first."""
    rec = _recipe(recipe)
    base = _port(kind)
    if recipe == "delayed":
        _step(base, kind, rec)
    start = copy.deepcopy(base.state_dict())
    loss = _step(base, kind, rec)
    grads, buffers = _readings(base)
    if recipe == "delayed":
        assert buffers and all(
            not torch.equal(b, start[n]) for n, b in buffers.items()
            if n.endswith("_amax_history"))
    for policy in POLICIES:
        model = _port(kind, remat=True, remat_policy=policy)
        model.load_state_dict(start)
        assert _step(model, kind, rec) == loss, policy
        got_grads, got_buffers = _readings(model)
        assert set(got_grads) == set(grads)
        for n, g in grads.items():
            assert torch.equal(got_grads[n], g), (policy, n)
        assert set(got_buffers) == set(buffers)
        for n, b in buffers.items():
            assert torch.equal(got_buffers[n], b), (policy, n)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots"])
def test_gptoss_remat_step_is_bitwise_the_step_without_remat(policy):
    """GPT-OSS's banded and sink layers and its biased MoE under remat:
    the bf16 step's loss and gradients equal the step without it."""
    tok, tgt = (torch.from_numpy(a) for a in _tokens(GPTOSS_TINY.vocab_size))
    readings = []
    for cfg in (GPTOSS_TINY, dataclasses.replace(
            GPTOSS_TINY, remat=True, remat_policy=policy)):
        model = GptOssModel(cfg, device="cpu", seed=4)
        with torch.no_grad():
            model.embedding.mul_(0.02)
        loss = gptoss_loss(model, tok, tgt)
        loss.backward()
        readings.append((float(loss.detach()), _readings(model)[0]))
    (loss0, grads0), (loss1, grads1) = readings
    assert loss1 == loss0
    for n, g in grads0.items():
        assert torch.equal(grads1[n], g), n


def _dropout_layer():
    gen = torch.Generator().manual_seed(5)
    return TransformerLayer(64, 128, 4, num_gqa_groups=2,
                            hidden_dropout=0.1, attention_dropout=0.1,
                            drop_path=0.1, mlp_activations="swiglu",
                            enable_rotary_pos_emb=True, device="cpu",
                            generator=gen)


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_step_with_a_generator_is_equal_under_remat(policy):
    """Attention, hidden and drop-path dropout draw from an explicit
    generator; the second forward draws the first's masks and seeds, and
    the generator ends where the step without remat leaves it."""
    layer = _dropout_layer()
    x0 = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(6))

    def run(call):
        layer.zero_grad(set_to_none=True)
        x = x0.clone().to(torch.bfloat16).requires_grad_()
        gen = torch.Generator().manual_seed(7)
        out = call(x, gen)
        out.float().square().sum().backward()
        return (out.detach(), x.grad, {n: p.grad.clone() for n, p in
                                       layer.named_parameters()},
                gen.get_state())

    plain = run(lambda x, g: layer(x, deterministic=False, generator=g))
    remat = run(lambda x, g: cp.checkpoint(
        layer, x, deterministic=False, generator=g,
        policy=cp.remat_policy(policy)))
    assert torch.equal(remat[0], plain[0]) and torch.equal(remat[1], plain[1])
    for n, g in plain[2].items():
        assert torch.equal(remat[2][n], g), n
    assert torch.equal(remat[3], plain[3])
    # torch.utils.checkpoint alone restores only the default generators:
    # the second forward draws other masks, and the gradients move.
    alone = run(lambda x, g: torch.utils.checkpoint.checkpoint(
        layer, x, deterministic=False, generator=g, use_reentrant=False))
    assert torch.equal(alone[0], plain[0])
    assert not torch.equal(alone[1], plain[1])


def test_unknown_policy_raises_and_policies_exist():
    with pytest.raises(ValueError, match="unknown remat_policy 'all'"):
        LlamaModel(dataclasses.replace(LLAMA_TINY, remat=True,
                                       remat_policy="all"), device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        MixtralModel(dataclasses.replace(MIXTRAL_TINY, remat=True,
                                         remat_policy="dot"), device="cpu")
    # Without remat the name is not read, as in the reference.
    LlamaModel(dataclasses.replace(LLAMA_TINY, remat_policy="all"),
               device="cpu")
    assert cp.remat_policy("dots") is cp.dots_with_no_batch_dims_saveable
    assert cp.checkpoint_dots is cp.dots_saveable
    with pytest.raises(ValueError, match="pinned_host"):
        cp.offload_dot_with_no_batch_dims(offload_dst="device")


class _Square(torch.autograd.Function):
    """(2x)^2 with the doubled value made through ``keep`` under a name:
    the second forward takes the first's value where the policy keeps
    the name, and computes it again where it does not."""
    calls = []

    @staticmethod
    def forward(ctx, x):
        y = cp.keep("name:doubled", lambda: _Square.calls.append(1) or x * 2)
        y = cp.checkpoint_name(y, "tagged")
        ctx.save_for_backward(y)
        return y * y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * 4 * y


def test_named_policies_keep_their_tagged_values():
    """``save_only_these_names`` (and its offloaded form) hands the
    second forward the first's value; another name, ``nothing_saveable``
    and ``everything_saveable`` (no recompute) compute it again or once;
    the gradients are the same under each."""
    cases = ((cp.save_only_these_names("doubled"), 1),
             (cp.save_only_these_names("tagged", "other"), 2),
             (cp.save_and_offload_only_these_names(
                 names_which_can_be_offloaded=("doubled",)), 1),
             (cp.everything_saveable, 1), (cp.nothing_saveable, 2))
    for policy, calls in cases:
        _Square.calls.clear()
        x = torch.arange(4.0, requires_grad=True)
        cp.checkpoint(lambda t: _Square.apply(t).sum(), x,
                      policy=policy).backward()
        assert torch.equal(x.grad, 8 * torch.arange(4.0)), policy.name
        assert len(_Square.calls) == calls, policy.name
    # Outside a checkpointed call, and where autograd records, a tag is
    # the value itself.
    x = torch.ones(2, requires_grad=True)
    assert cp.checkpoint_name(x, "doubled") is x


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_scan_layers_reference_model_loads_and_matches(kind):
    """A scanned reference model (its layers' params and quantize_meta
    stacked under ``layers``) loads into the port with ``scan_layers``:
    each layer's state is the stack's slice, and the forward matches the
    reference's. Llama is held to the scanned forward itself; Mixtral to
    the unscanned forward on the same weights, because the scanned body,
    which XLA compiles, rounds other bits than the eager layers (Llama's
    two reference forwards differ by 7.9e-3 of the largest logit) and so
    moves near-tied tokens to other experts (9 of 64 tokens at this
    seed)."""
    params, qmeta = _weights(kind, scan=True, delayed=True)
    cls, cfg = (JLlama, J_LLAMA) if kind == "llama" else (JMixtral, J_MIXTRAL)
    tok, _ = _tokens(cfg.vocab_size)
    if kind == "llama":
        jm, ref_params = cls(dataclasses.replace(cfg, scan_layers=True)), \
            params
    else:
        jm, ref_params = cls(cfg), unstack_layers(params, cfg.num_layers)
    want = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray,
                                                       ref_params)},
                               jnp.asarray(tok)), np.float32)
    port_cfg = dataclasses.replace(
        LLAMA_TINY if kind == "llama" else MIXTRAL_TINY, scan_layers=True)
    state = load_flax_params(params, port_cfg, device="cpu",
                             quantize_meta=qmeta)
    model = (LlamaModel if kind == "llama" else MixtralModel)(
        port_cfg, device="cpu")
    model.load_state_dict(state)
    stacked = params["layers"]["self_attention"]["qkv"]["kernel"]
    for i in range(cfg.num_layers):
        got = model.layers[i].self_attention.qkv.kernel.detach().float()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(stacked[i], np.float32))
    hist = [n for n in state if n.endswith("_amax_history")]
    assert hist and all(n.startswith("layers.") for n in hist)
    assert len(hist) == len(jax.tree.leaves(qmeta)) // 2 * cfg.num_layers
    with torch.no_grad():
        got = model(torch.from_numpy(tok)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2 ** -6, err
    with pytest.raises(KeyError, match="stacked"):
        load_flax_params(_weights(kind)[0], port_cfg, device="cpu")
