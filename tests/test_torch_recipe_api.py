"""The rest of the recipe API in the port against the JAX package:
``CustomRecipe`` (a factory returning the MXFP8 quantizer is
``MXFP8BlockScaling``; returning None is the unquantized path),
``MMParams``, the six ``Recipe`` predicates, the ``QParams`` fields, and
FP8 stochastic rounding: ``qmath.stochastic_cast`` fed the bits
``jax.random.bits`` draws for the reference's key equals the reference's
``stochastic_cast`` bit for bit, its mean over many draws is unbiased, and
a quantizer given a generator rounds stochastically in its generic
passes (never in a fused kernel)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.common import recipe as j_recipe
from transformerengine_tpu.dense import dense as j_dense
from transformerengine_tpu.quantize import qmath as j_qmath
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch.common import recipe as t_recipe
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.nn import DenseGeneral
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout, noop_quantizer_set)

torch.set_num_threads(2)

PREDICATES = ("mxfp8", "delayed", "float8_current_scaling",
              "float8_block_scaling", "nvfp4", "custom")
RECIPES = ("DelayedScaling", "Float8CurrentScaling", "MXFP8BlockScaling",
           "Float8BlockScaling", "NVFP4BlockScaling", "CustomRecipe")


@pytest.mark.parametrize("name", RECIPES)
def test_predicates(name):
    got = getattr(t_recipe, name)()
    ref = getattr(j_recipe, name)()
    assert [getattr(got, p)() for p in PREDICATES] == \
        [getattr(ref, p)() for p in PREDICATES]
    assert sum(getattr(got, p)() for p in PREDICATES) == 1


def test_qparams_and_mmparams_fields():
    for cls in ("QParams", "MMParams"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(t_recipe, cls))]
        ref = [(f.name, f.default) for f in
               dataclasses.fields(getattr(j_recipe, cls))]
        assert got == ref, cls
    assert tt.MMParams().use_split_accumulator
    fields = ("fp8_quant_fwd_inp", "fp8_quant_fwd_weight",
              "fp8_quant_bwd_grad")
    cur = tt.Float8CurrentScaling(fp8_quant_fwd_inp=tt.QParams(
        power_2_scale=True, amax_epsilon=1e-3))
    assert cur.fp8_quant_fwd_inp.power_2_scale
    assert cur.fp8_quant_fwd_inp.amax_epsilon == 1e-3
    for f in fields:
        assert getattr(tt.Float8CurrentScaling(), f) == tt.QParams()
    # Read by no recipe: the knobs change no quantizer.
    assert QuantizerFactory.create(cur, "x") == \
        QuantizerFactory.create(tt.Float8CurrentScaling(), "x")
    block = [(f.name, f.default) for f in
             dataclasses.fields(t_recipe.Float8BlockScaling)]
    assert [n for n, _ in block] == [
        f.name for f in dataclasses.fields(j_recipe.Float8BlockScaling)]


def _mxfp8_factory(role):
    return QuantizerFactory.create(tt.MXFP8BlockScaling(), role)


def _dense_grads(qset, x, k, g):
    x, k = x.clone().requires_grad_(), k.clone().requires_grad_()
    out = dense(x, k, quantizer_set=qset)
    out.backward(g)
    return out, x.grad, k.grad


def test_custom_recipe_is_its_factory():
    """A factory returning the MXFP8 quantizer gives MXFP8BlockScaling's
    layer bit for bit, and the reference's CustomRecipe the same values
    (one bf16 ulp of the largest element, the f32 sums' order); one
    returning None gives the unquantized layer."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    k = (rng.standard_normal((128, 256)) / 8).astype(np.float32)
    g = rng.standard_normal((256, 256)).astype(np.float32)
    xt, kt, gt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, k, g))
    custom = QuantizerFactory.create_set(tt.CustomRecipe(_mxfp8_factory))
    built = QuantizerFactory.create_set(tt.MXFP8BlockScaling())
    assert custom == built
    for a, b in zip(_dense_grads(custom, xt, kt, gt),
                    _dense_grads(built, xt, kt, gt)):
        assert torch.equal(a, b)
    jset = JFactory.create_set(te.CustomRecipe(
        lambda role: JFactory.create(te.MXFP8BlockScaling(), role)))
    xj, kj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    ref = np.asarray(j_dense(xj, kj, quantizer_set=jset), np.float32)
    out = _dense_grads(custom, xt, kt, gt)[0].detach().float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 ** -8 * np.abs(ref).max())
    none = QuantizerFactory.create_set(tt.CustomRecipe(lambda role: None))
    assert none == noop_quantizer_set
    assert QuantizerFactory.create_set(tt.CustomRecipe()) == \
        noop_quantizer_set
    for a, b in zip(_dense_grads(none, xt, kt, gt),
                    _dense_grads(noop_quantizer_set, xt, kt, gt)):
        assert torch.equal(a, b)
    model = DenseGeneral(128, 256, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    with tt.autocast(recipe=tt.CustomRecipe(lambda role: None)):
        y = model(xt)
    with torch.no_grad():
        assert torch.equal(y, dense(xt, model.kernel))


# The reference's own inputs (tests/test_quantize.py) and a spread of
# values across e4m3's and e5m2's binades, subnormals and the clip.
def _sr_inputs():
    rng = np.random.default_rng(3)
    spread = (rng.standard_normal((64, 128))
              * np.exp(rng.uniform(-12, 7, (64, 1)))).astype(np.float32)
    spread[0, :4] = (500.0, -1e6, 448.0, -57344.0)
    return {"midpoint": np.full((200, 128), 336.0, np.float32),
            "exact": np.asarray([[1.0, 2.0, -4.0, 448.0] * 32], np.float32),
            "spread": spread}


@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
@pytest.mark.parametrize("case", ["midpoint", "exact", "spread"])
def test_stochastic_cast_matches_reference(case, q):
    x = _sr_inputs()[case]
    jq = {"e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}[q]
    tq = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[q]
    key = jax.random.PRNGKey(0 if case == "midpoint" else 1)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    ref = j_qmath.stochastic_cast(jnp.asarray(x), jq, key)
    got = qmath.stochastic_cast(torch.from_numpy(x), tq,
                                torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(ref).view(np.uint8))
    if case == "exact" and q == "e4m3":
        np.testing.assert_array_equal(got.float().numpy(), x)


def test_stochastic_cast_is_unbiased():
    """Over 256 draws of ``sr_bits`` each element's mean lies within 0.2
    of its grid spacing of the value (six standard deviations of the
    mean), and the mean of those errors within 0.02; every draw is one of
    the value's two grid neighbours."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.uniform(1, 2, (16, 64))
                          * 2.0 ** rng.integers(-5, 8, (16, 1))).astype(
        np.float32))
    draws = torch.stack([
        qmath.stochastic_cast(x, torch.float8_e4m3fn,
                              qmath.sr_bits(seed, 0, x.shape)).float()
        for seed in range(256)])
    lo = x.clone()
    # The grid neighbours: the value truncated to 3 mantissa bits and the
    # next one up.
    word = lo.view(torch.int32) & -(1 << 20)
    lo = word.view(torch.float32)
    hi = (word + (1 << 20)).view(torch.float32)
    spacing = hi - lo
    assert bool(((draws == lo) | (draws == hi)).all())
    bias = (draws.mean(0) - x) / spacing
    assert float(bias.abs().max()) < 0.2
    assert abs(float(bias.mean())) < 0.02


def test_quantizer_generator_rounds_stochastically(monkeypatch):
    """A generator makes the quantizer round stochastically in its generic
    passes (the fused cast_transpose declines it, as the reference's
    fused kernels decline a key); the colwise payload is the rowwise one
    transposed; one seed gives one result."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fused kernel took a stochastic quantize")
    monkeypatch.setattr(qk, "cast_transpose", refuse)
    monkeypatch.setattr(qk, "mxfp8_quantize_2x", refuse)
    monkeypatch.setattr(qk, "mxfp8_quantize_1x", refuse)
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(5))
    q = CurrentScaleQuantizer(torch.float8_e4m3fn,
                              QuantizeLayout.ROWWISE_COLWISE)
    a = q.quantize(x, generator=torch.Generator().manual_seed(9))
    b = q.quantize(x, generator=torch.Generator().manual_seed(9))
    c = q.quantize(x, generator=torch.Generator().manual_seed(10))
    assert torch.equal(a.rowwise.data.float(), b.rowwise.data.float())
    assert not torch.equal(a.rowwise.data.float(), c.rowwise.data.float())
    assert torch.equal(a.colwise.data.float(), a.rowwise.data.float().t())
    seed = int(torch.randint(0, 2 ** 32, (),
                             generator=torch.Generator().manual_seed(9)))
    scale = qmath.compute_scale_from_amax(x.abs().amax(), torch.float8_e4m3fn)
    want = qmath.stochastic_cast(x * scale, torch.float8_e4m3fn,
                                 qmath.sr_bits(seed, 0, x.shape))
    assert torch.equal(a.rowwise.data.float(), want.float())
    for recipe in (tt.MXFP8BlockScaling(), tt.Float8BlockScaling()):
        bq = QuantizerFactory.create(recipe, "x")
        t = bq.quantize(x, generator=torch.Generator().manual_seed(9))
        data, scale, _, _ = bq._quantize_2d(x)       # to nearest
        assert not torch.equal(t.rowwise.data.float(), data.float())
        assert torch.equal(t.rowwise.scale_inv, scale)
