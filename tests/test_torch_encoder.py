"""The encoder TransformerLayer of the port against the JAX package on the
CPU: the T5 bucket function exactly over every distance of a 2048-token
sequence, ``RelativePositionBiases`` and its gradient, the unfused
backend's pre- and post-scale bias and materialized ALiBi,
``MultiHeadAttention`` with ALiBi (FP8 attention off under
``MXFP8BlockScaling(fp8_dpa=True)`` on both sides), and the cached path:
the port refuses a relative bias or ALiBi on a KV cache, where the
reference's cached layer drops the bias. ``test_torch_encoder_step.py``
holds a 2-layer encoder stack's step with this file's helpers.

The weights are drawn with numpy from the shapes of the reference's
``init`` and carried by ``nn.transformer.flax_state``; the reference
runs eagerly, its Pallas kernels in interpret mode."""
import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
import transformerengine_tpu.ops.flash_attention as j_fa
from transformerengine_tpu.attention import (
    AttnBackend as JBackend, AttnBiasType as JBias, AttnMaskType as JMask,
    SequenceDescriptor as JDesc, fused_attn as j_fused_attn)
from transformerengine_tpu.flax.transformer import (
    MultiHeadAttention as JMHA, RelativePositionBiases as JRelPos,
    TransformerLayer as JLayer)
from transformerengine_tpu.inference.kv_cache import (
    InferenceParams as JInferenceParams)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch.attention import (
    AttnBackend, AttnBiasType, AttnMaskType, SequenceDescriptor, fused_attn,
    get_attention_backend)
from transformerengine_tpu_torch.inference.kv_cache import (
    InferenceParams, KVCache)
from transformerengine_tpu_torch.nn.transformer import (
    MultiHeadAttention, RelativePositionBiases, TransformerLayer, flax_state)
from transformerengine_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

B, S, HIDDEN, FFN, HEADS, KV_HEADS = 2, 64, 128, 256, 4, 2
LENS = (64, 40)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def test_bucket_function_is_exact_over_a_2048_sequence():
    """Every relative position of a 2048-token sequence (-2047..2047)
    gets the reference's bucket, bidirectional and causal, at the
    reference's 32 buckets and max distance 128 and at others."""
    rp = np.arange(-2047, 2048, dtype=np.int32)
    for bidirectional in (True, False):
        for nb, md in ((32, 128), (32, 64), (16, 256)):
            want = np.asarray(JRelPos._bucket(jnp.asarray(rp), bidirectional,
                                              nb, md))
            got = RelativePositionBiases.bucket(
                torch.from_numpy(rp), bidirectional, nb, md).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_relative_position_biases_match_the_reference():
    """The bias (1, H, q, k) equals the reference's one-hot product
    element for element, in f32; the gradient of rel_embedding sums in
    another order (an exact gather against a one-hot contraction over
    q * k terms): within 1e-5 of its largest element."""
    rng = np.random.default_rng(21)
    for bidirectional in (True, False):
        jm = JRelPos(num_buckets=32, max_distance=128, num_attention_heads=4)
        emb = rng.standard_normal((32, 4)).astype(np.float32)
        g = rng.standard_normal((1, 4, 48, 56)).astype(np.float32)

        def fj(e):
            return jm.apply({"params": {"rel_embedding": e}}, 48, 56,
                            bidirectional)

        bj, vjp = jax.vjp(fj, jnp.asarray(emb))
        (dj,) = vjp(jnp.asarray(g))
        mod = RelativePositionBiases(32, 128, 4, device="cpu")
        mod.load_state_dict({"rel_embedding": torch.from_numpy(emb)})
        bt = mod(48, 56, bidirectional)
        assert bt.dtype == torch.float32 and bt.shape == (1, 4, 48, 56)
        np.testing.assert_array_equal(_np(bt), np.asarray(bj))
        bt.backward(torch.from_numpy(g))
        d = np.asarray(dj)
        np.testing.assert_allclose(_np(mod.rel_embedding.grad), d, rtol=0,
                                   atol=1e-5 * np.abs(d).max())


def _qkv(rng, dtype=jnp.float32, sq=24, skv=24, hq=4, hkv=2, d=32):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((2, sq, hq, d), (2, skv, hkv, d), (2, skv, hkv, d))]
    js = [jnp.asarray(a).astype(dtype) for a in arrs]
    ts = [torch.from_numpy(np.asarray(j.astype(jnp.float32))) for j in js]
    return js, ts


@pytest.mark.parametrize("bias_type", ["pre_scale_bias", "post_scale_bias",
                                       "alibi"])
def test_unfused_bias_matches_the_reference(bias_type):
    """The unfused backend's pre- and post-scale bias and its
    materialized ALiBi (the distance on the indices, no offset) against
    the reference's, padding-causal with lengths, in f32."""
    rng = np.random.default_rng(31)
    (qj, kj, vj), (qt, kt, vt) = _qkv(rng)
    bias = (None if bias_type == "alibi" else
            rng.standard_normal((1, 4, 24, 24)).astype(np.float32))
    lens = np.asarray([24, 13], np.int32)
    out_j = j_fused_attn(
        (qj, kj, vj), None if bias is None else jnp.asarray(bias),
        JDesc.from_seqlens(jnp.asarray(lens)), attn_bias_type=JBias(bias_type),
        attn_mask_type=JMask.PADDING_CAUSAL, backend=JBackend.UNFUSED)
    out_t = fused_attn(
        (qt, kt, vt), SequenceDescriptor.from_seqlens(torch.from_numpy(lens)),
        bias=None if bias is None else torch.from_numpy(bias),
        attn_bias_type=AttnBiasType(bias_type),
        attn_mask_type=AttnMaskType.PADDING_CAUSAL,
        backend=AttnBackend.UNFUSED)
    r = _np(out_j)
    np.testing.assert_allclose(_np(out_t), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())


def test_backend_choice_and_bias_rules():
    """A pre-scale bias takes the unfused backend; a post-scale bias and
    ALiBi stay on the flash kernels; ALiBi takes no bias; the flash
    backend's ALiBi (with its bottom-right-free square shape) equals the
    unfused materialization within f32 rounding."""
    assert get_attention_backend(
        attn_bias_type=AttnBiasType.PRE_SCALE_BIAS) is AttnBackend.UNFUSED
    for bt in (AttnBiasType.POST_SCALE_BIAS, AttnBiasType.ALIBI,
               AttnBiasType.NO_BIAS):
        assert get_attention_backend(attn_bias_type=bt) is AttnBackend.FLASH
    rng = np.random.default_rng(32)
    _, (q, k, v) = _qkv(rng)
    with pytest.raises(ValueError, match="ALIBI computes its own bias"):
        fused_attn((q, k, v), bias=torch.zeros((1, 4, 24, 24)),
                   attn_bias_type=AttnBiasType.ALIBI)
    with pytest.raises(ValueError, match="pre-scale"):
        fused_attn((q, k, v), bias=torch.zeros((1, 4, 24, 24)),
                   attn_bias_type=AttnBiasType.PRE_SCALE_BIAS,
                   backend=AttnBackend.FLASH)
    flash = fused_attn((q, k, v), attn_bias_type=AttnBiasType.ALIBI,
                       attn_mask_type=AttnMaskType.CAUSAL)
    unfused = fused_attn((q, k, v), attn_bias_type=AttnBiasType.ALIBI,
                         attn_mask_type=AttnMaskType.CAUSAL,
                         backend=AttnBackend.UNFUSED)
    torch.testing.assert_close(flash, unfused, rtol=0, atol=2e-6)


def _draw(shapes, rng):
    """Numpy weights of the reference's shapes: kernels LeCun-normal,
    norm scales 1 (0 with a zero-centred gamma) plus noise of 0.1,
    LayerNorm biases noise of 0.1, rel_embedding normal at 0.5;
    quantize_meta scales 1 and histories 0 (its initial state)."""
    def leaf(path, s):
        name = path[-1].key
        if name.endswith("_scale"):
            return np.ones(s.shape, s.dtype)
        if name.endswith("_amax_history"):
            return np.zeros(s.shape, s.dtype)
        if name == "scale":
            base = 0.0 if "zcg" in str(path) else 1.0
            return (base + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        if name == "ln_bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        if name == "rel_embedding":
            return (0.5 * rng.standard_normal(s.shape)).astype(s.dtype)
        std = s.shape[0] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def _branches(seen: collections.Counter):
    """Counts the port's flash calls: "fp8" with FP8 Q/K/V or an fp8 O,
    "bias" with a bias, "alibi" with ALiBi, else "bf16"."""
    fwd, bwd = fa.flash_fwd, fa.flash_bwd

    def kind(kw):
        if kw.get("scale_invs") is not None:
            return "fp8"
        if kw.get("bias") is not None:
            return "bias"
        return "alibi" if kw.get("score_mod") is not None else "bf16"

    def fwd_hook(*args, **kw):
        seen["fwd_" + kind(kw)] += 1
        return fwd(*args, **kw)

    def bwd_hook(*args, **kw):
        seen["bwd_" + kind(kw)] += 1
        return bwd(*args, **kw)
    fa.flash_fwd, fa.flash_bwd = fwd_hook, bwd_hook
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = fwd, bwd


@contextlib.contextmanager
def _no_reference_fp8_attention():
    """The reference's FP8 attention cores raise if called."""
    def boom(*args, **kwargs):
        raise AssertionError("the reference ran FP8 attention")
    saved = j_fa._fp8_core, j_fa._fp8_mha_core
    j_fa._fp8_core = j_fa._fp8_mha_core = boom
    try:
        yield
    finally:
        j_fa._fp8_core, j_fa._fp8_mha_core = saved


def _readout(rng):
    return rng.standard_normal((B, S, HIDDEN)).astype(np.float32)


def _hold_loss(loss_t, loss_j, y, r, n_valid) -> None:
    """The read-out ``sum(y * r) / n`` sums terms of both signs, so it is
    held against its terms' size, ``||y * r|| / n``: each element of the
    bf16 output may sit one bf16 ulp (2^-8 of itself) away, and random
    signs add those like a norm; 2^-6 of it is four times that (readings:
    up to 2^-9 of it)."""
    size = float((y.detach().float() * torch.from_numpy(r)).norm()) / \
        float(n_valid)
    diff = abs(float(loss_t) - float(loss_j))
    assert diff <= 2 ** -6 * size, (float(loss_t), float(loss_j), size)


def test_mha_alibi_matches_the_reference():
    """MultiHeadAttention with ALiBi (padding mask with lengths,
    LayerNorm, no RoPE), forward and gradients against the reference's,
    in bf16 and under MXFP8BlockScaling(fp8_dpa=True), where the
    reference's gate builds FP8 quantizers and fused_attn drops them: FP8
    attention is off on both sides."""
    kw = dict(hidden_size=HIDDEN, num_attention_heads=HEADS,
              num_gqa_groups=KV_HEADS, layernorm_epsilon=1e-5)
    jm = JMHA(attn_mask_type=JMask.PADDING, attn_bias_type=JBias.ALIBI, **kw)
    rng = np.random.default_rng(41)
    x = (rng.standard_normal((B, S, HIDDEN)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    lens = np.asarray(LENS, np.int32)
    desc_j = JDesc.from_seqlens(jnp.asarray(lens))
    desc_t = SequenceDescriptor.from_seqlens(torch.from_numpy(lens))
    r = _readout(rng)
    shapes = fnn.meta.unbox(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           xj, None, desc_j))
    params = jax.tree.map(np.asarray, _draw(shapes, rng)["params"])
    for recipe in (None, "mxfp8_dpa"):
        make = (lambda m: m.MXFP8BlockScaling(fp8_dpa=True)) \
            if recipe else None

        def fj(p, x):
            y = jm.apply({"params": p}, x, None, desc_j)
            return (y.astype(jnp.float32) * r).sum() / lens.sum()

        with te.autocast(enabled=recipe is not None,
                         recipe=make(te) if make else None), \
                _no_reference_fp8_attention():
            loss_j, (gp, gx) = jax.value_and_grad(fj, argnums=(0, 1))(
                jax.tree.map(jnp.asarray, params), xj)
        mt = MultiHeadAttention(
            HIDDEN, HEADS, num_gqa_groups=KV_HEADS, layernorm_epsilon=1e-5,
            attn_mask_type=AttnMaskType.PADDING,
            attn_bias_type=AttnBiasType.ALIBI, device="cpu")
        mt.load_state_dict(flax_state(params, torch.bfloat16, "cpu"))
        leaf = xt.clone().requires_grad_(True)
        seen = collections.Counter()
        with tt.autocast(enabled=recipe is not None,
                         recipe=make(tt) if make else None), _branches(seen):
            y = mt(leaf, desc_t)
            loss_t = (y.float() * torch.from_numpy(r)).sum() / lens.sum()
            loss_t.backward()
        assert dict(seen) == {"fwd_alibi": 1, "bwd_alibi": 1}, seen
        _hold_loss(loss_t, loss_j, y, r, lens.sum())
        grads = {k: p.grad for k, p in mt.named_parameters()}
        ref = {k: v for k, v in flax_state(gp, None, "cpu").items()}
        ref["x"], grads["x"] = torch.from_numpy(np.asarray(
            gx.astype(jnp.float32))), leaf.grad
        for k in ref:
            a, b = _np(grads[k]), _np(ref[k])
            assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b), (
                recipe, k, np.linalg.norm(a - b) / np.linalg.norm(b))


def test_cached_relative_bias_is_refused_and_differs_in_the_reference():
    """The port refuses a relative bias or ALiBi on a KV cache. The
    reference builds no relative bias with ``inference_params``, so its
    cached prefill of the same prompt computes another function than its
    cache-free forward (ROADMAP.md, Queue 3)."""
    layer = TransformerLayer(HIDDEN, FFN, HEADS, num_gqa_groups=KV_HEADS,
                             enable_relative_embedding=True, device="cpu")
    cache = KVCache.allocate(InferenceParams(B, 32), KV_HEADS,
                             HIDDEN // HEADS, "cpu")
    x = torch.zeros((B, 8, HIDDEN), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="relative-position bias"):
        layer(x, kv_cache=cache)
    mha = MultiHeadAttention(HIDDEN, HEADS, num_gqa_groups=KV_HEADS,
                             attn_bias_type=AttnBiasType.ALIBI, device="cpu")
    with pytest.raises(NotImplementedError, match="KV cache"):
        mha(x, kv_cache=cache)

    jl = JLayer(hidden_size=HIDDEN, mlp_hidden_size=FFN,
                num_attention_heads=HEADS, num_gqa_groups=KV_HEADS,
                enable_relative_embedding=True)
    rng = np.random.default_rng(61)
    xj = jnp.asarray(rng.standard_normal((B, 8, HIDDEN)) * 0.5, jnp.bfloat16)
    shapes = fnn.meta.unbox(jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                                           xj))
    params = _draw(shapes, rng)["params"]
    plain = jl.apply({"params": params}, xj)
    cached, _ = jl.apply({"params": params}, xj,
                         inference_params=JInferenceParams(B, 32),
                         mutable=["cache"])
    diff = float(jnp.abs(plain.astype(jnp.float32)
                         - cached.astype(jnp.float32)).max())
    assert diff > 0.05, diff
