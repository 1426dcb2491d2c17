"""The port's dense, layernorm_dense and layernorm_mlp, forward and
backward, against ``jax.vjp`` of the JAX package's layers: without a
recipe (bf16), under Float8CurrentScaling and under DelayedScaling
started from non-unit scales and amax histories. Under delayed scaling
the reference returns the updated quantizer set as the set's cotangent;
the port writes the same state into the set's tensors in its backward,
and both are compared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.dense import dense as j_dense
from transformerengine_tpu.layernorm_dense import (
    layernorm_dense as j_ln_dense)
from transformerengine_tpu.layernorm_mlp import layernorm_mlp as j_ln_mlp
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
from transformerengine_tpu.quantize.quantizer import (
    noop_quantizer_set as j_noop)
from transformerengine_tpu_torch import DelayedScaling, Float8CurrentScaling
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    DelayedScaleQuantizer, noop_quantizer_set)

torch.set_num_threads(2)

HIST = 8
RECIPES = ["bf16", "current", "delayed"]


def _pair(x: np.ndarray, dtype=jnp.bfloat16, grad=True):
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return xj, xt.requires_grad_(grad)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _qsets(recipe: str, seed: int):
    """A JAX quantizer set and the port's, with the same state: for
    delayed scaling, scales of 2^-3 .. 2^2 and histories holding earlier
    amaxes, so that the update's max, roll and scale all show."""
    if recipe == "bf16":
        return j_noop, noop_quantizer_set
    if recipe == "current":
        return (JFactory.create_set(te.Float8CurrentScaling()),
                QuantizerFactory.create_set(Float8CurrentScaling()))
    rng = np.random.default_rng(seed)
    js = JFactory.create_set(te.DelayedScaling(amax_history_len=HIST))
    ts = QuantizerFactory.create_set(DelayedScaling(amax_history_len=HIST))
    jout, tout = {}, {}
    for role in ("x", "kernel", "dgrad"):
        scale = np.float32(2.0 ** rng.integers(-3, 3)).reshape(1)
        hist = np.zeros(HIST, np.float32)
        hist[1:4] = rng.uniform(0.5, 4.0, 3).astype(np.float32)
        jout[role] = dataclasses.replace(
            getattr(js, role), scale=jnp.asarray(scale),
            amax_history=jnp.asarray(hist))
        tout[role] = dataclasses.replace(
            getattr(ts, role), scale=torch.from_numpy(scale.copy()),
            amax_history=torch.from_numpy(hist.copy()))
    return type(js)(**jout), type(ts)(**tout)


def _check_state(jset, tset, rtol=0.0):
    """The port's written-back state against the reference's cotangent.
    ``rtol`` 0 means bit-exact."""
    for role in ("x", "kernel", "dgrad"):
        tq = getattr(tset, role)
        if not isinstance(tq, DelayedScaleQuantizer):
            continue
        jq = getattr(jset, role)
        np.testing.assert_allclose(tq.amax_history.numpy(),
                                   _np(jq.amax_history), rtol=rtol, atol=0)
        np.testing.assert_allclose(tq.scale.numpy(), _np(jq.scale),
                                   rtol=rtol, atol=0)


def _close(got, ref, rtol):
    """Every element within ``rtol`` of the largest |ref|."""
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


# Tolerances, relative to the largest element. The quantized payloads are
# bit-exact on both sides, and every product is exact in f32 (bf16 or fp8
# operands); only the order of the f32 sums differs, and the bf16 results
# may round one ulp (2^-8) apart. Chained GEMMs (the MLP, the norm
# backward) pass such a one-ulp difference on through one more product.
OUT_RTOL = 2 ** -7
GRAD_RTOL = 2 ** -6


@pytest.mark.parametrize("recipe", RECIPES)
def test_dense_fwd_bwd(recipe):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 24, 64)))
    kj, kt = _pair(rng.standard_normal((64, 48)) / 8)
    gj, gt = _pair(rng.standard_normal((2, 24, 48)), grad=False)
    jset, tset = _qsets(recipe, 1)
    oj, vjp = jax.vjp(lambda x, k, q: j_dense(x, k, quantizer_set=q),
                      xj, kj, jset)
    dxj, dkj, jnew = vjp(gj)
    ot = dense(xt, kt, quantizer_set=tset)
    ot.backward(gt)
    assert ot.dtype == torch.bfloat16 and ot.shape == (2, 24, 48)
    _close(ot, oj, OUT_RTOL)
    _close(xt.grad, dxj, OUT_RTOL)
    _close(kt.grad, dkj, OUT_RTOL)
    # x, the kernel and the given gradient are the same bytes on both
    # sides, so their amaxes and the rolled state are bit-exact.
    _check_state(jnew, tset)


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_layernorm_dense_fwd_bwd(norm, recipe):
    rng = np.random.default_rng(2)
    h = 64
    xj, xt = _pair(rng.standard_normal((2, 24, h)) * 2)
    kj, kt = _pair(rng.standard_normal((h, 80)) / 8)
    gmj, gmt = _pair(rng.standard_normal(h) * 0.1, jnp.float32)
    bj, bt = _pair(rng.standard_normal(h) * 0.1, jnp.float32)
    gj, gt = _pair(rng.standard_normal((2, 24, 80)), grad=False)
    jset, tset = _qsets(recipe, 3)
    ln = norm == "layernorm"
    # Zero-centered gamma with LayerNorm, plain gamma with RMSNorm.

    def fj(x, k, gm, b, q):
        return j_ln_dense(x, k, gm, b if ln else None, norm_type=norm,
                          zero_centered_gamma=ln, epsilon=1e-5,
                          quantizer_set=q)

    oj, vjp = jax.vjp(fj, xj, kj, gmj, bj, jset)
    dxj, dkj, dgj, dbj, jnew = vjp(gj)
    ot = layernorm_dense(xt, kt, gmt, beta=bt if ln else None,
                         norm_type=norm, zero_centered_gamma=ln,
                         epsilon=1e-5, quantizer_set=tset)
    ot.backward(gt)
    _close(ot, oj, OUT_RTOL)
    _close(kt.grad, dkj, GRAD_RTOL)
    _close(xt.grad, dxj, GRAD_RTOL)
    _close(gmt.grad, dgj, GRAD_RTOL)
    if ln:
        _close(bt.grad, dbj, GRAD_RTOL)
    # The normalized x may round one bf16 ulp apart, and so may its amax.
    _check_state(jnew, tset, rtol=2 ** -7)


@pytest.mark.parametrize("recipe", RECIPES)
def test_layernorm_mlp_fwd_bwd(recipe):
    rng = np.random.default_rng(4)
    h, ffn = 64, 96
    xj, xt = _pair(rng.standard_normal((2, 16, h)))
    gmj, gmt = _pair(1 + 0.1 * rng.standard_normal(h), jnp.float32)
    w1j, w1t = _pair(rng.standard_normal((h, 2, ffn)) / 8)
    w2j, w2t = _pair(rng.standard_normal((ffn, h)) / 10)
    gj, gt = _pair(rng.standard_normal((2, 16, h)), grad=False)
    (j1, t1), (j2, t2) = _qsets(recipe, 5), _qsets(recipe, 6)

    def fj(x, gm, w1, w2, q1, q2):
        return j_ln_mlp(x, gm, None, w1, w2, norm_type="rmsnorm",
                        activation_type="swiglu", quantizer_sets=(q1, q2))

    oj, vjp = jax.vjp(fj, xj, gmj, w1j, w2j, j1, j2)
    dxj, dgj, dw1j, dw2j, jn1, jn2 = vjp(gj)
    ot = layernorm_mlp(xt, gmt, w1t, w2t, activation_type="swiglu",
                       quantizer_sets=(t1, t2))
    ot.backward(gt)
    _close(ot, oj, GRAD_RTOL)
    for got, ref in ((xt.grad, dxj), (gmt.grad, dgj), (w1t.grad, dw1j),
                     (w2t.grad, dw2j)):
        _close(got, ref, GRAD_RTOL)
    # GEMM1's input and GEMM2's input and gradient are computed values
    # (bf16, possibly one ulp apart): their amaxes and scales may differ
    # by that much.
    _check_state(jn1, t1, rtol=2 ** -7)
    _check_state(jn2, t2, rtol=2 ** -7)


def test_forward_without_backward_keeps_the_state():
    """A forward under no_grad (the reference's primal) leaves the delayed
    state as it was; a backward writes it once."""
    rng = np.random.default_rng(7)
    _, xt = _pair(rng.standard_normal((16, 32)))
    _, kt = _pair(rng.standard_normal((32, 16)) / 4)
    _, tset = _qsets("delayed", 8)
    before = [t.clone() for q in (tset.x, tset.kernel, tset.dgrad)
              for t in (q.scale, q.amax_history)]
    with torch.no_grad():
        dense(xt, kt, quantizer_set=tset)
    after = [t for q in (tset.x, tset.kernel, tset.dgrad)
             for t in (q.scale, q.amax_history)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    dense(xt, kt, quantizer_set=tset).sum().backward()
    # The reference's roll: this step's amax moves to the end, slot 0 is
    # cleared, the rest shift down by one.
    hist = tset.x.amax_history
    assert float(hist[-1]) == float(xt.float().abs().max())
    assert float(hist[0]) == 0.0 and float(hist[1]) == float(before[1][2])


def _layer_call(layer: str, recipe: str):
    """A call of one layer on seeded inputs that require gradients, and
    those inputs' kernels."""
    rng = np.random.default_rng(9)
    _, xt = _pair(rng.standard_normal((2, 8, 32)))
    _, k1 = _pair(rng.standard_normal((32, 2, 48)) / 6)
    _, k2 = _pair(rng.standard_normal((48, 32)) / 7)
    _, gm = _pair(1 + 0.1 * rng.standard_normal(32), jnp.float32)
    (_, q1), (_, q2) = _qsets(recipe, 10), _qsets(recipe, 11)
    calls = {
        "dense": lambda: dense(xt, k2.t(), quantizer_set=q1),
        "layernorm_dense": lambda: layernorm_dense(
            xt, k2.t(), gm, quantizer_set=q1),
        "layernorm_mlp": lambda: layernorm_mlp(
            xt, gm, k1, k2, quantizer_sets=(q1, q2)),
    }
    return calls[layer], (k1, k2)


LAYERS = ["dense", "layernorm_dense", "layernorm_mlp"]


@pytest.mark.parametrize("layer", LAYERS)
def test_in_place_update_before_backward_raises(layer):
    """The residuals are saved through save_for_backward: updating a
    kernel in place between the forward and the backward that reads it
    raises, as for any autograd op."""
    call, kernels = _layer_call(layer, "bf16")
    out = call()
    with torch.no_grad():
        kernels[1].sub_(0.01)
    with pytest.raises(RuntimeError, match="inplace"):
        out.sum().backward()


@pytest.mark.parametrize("layer", LAYERS)
def test_forward_without_autograd_is_the_same_forward(layer):
    """Under no_grad a layer runs its forward without an autograd node,
    and returns the same bytes as the recorded forward."""
    call, _ = _layer_call(layer, "delayed")
    recorded = call()
    with torch.no_grad():
        plain = call()
    assert recorded.grad_fn is not None and plain.grad_fn is None
    assert torch.equal(recorded, plain)
