"""The port's dense, layernorm_dense and layernorm_mlp under
MXFP8BlockScaling against the JAX package's layers: forward and backward
against ``jax.vjp`` of the reference's ``custom_vjp`` (its training
branch: both orientations of x, the kernel and the gradient), and the
forward without a gradient (``torch.no_grad``) against the reference's
primal (its ``inference=True`` branch), with the JAX side's fused
kernels on (Pallas in interpret mode) and off. M = 256 and H = 128, so
the fused norm + quantize path runs where the reference takes it.

Every tensor quantized here has its block exponents inside -12..12,
where XLA's CPU ``exp2`` is exact (``test_torch_mxfp8_kernels.py``), so
the payloads are the same bytes on both sides."""
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
from transformerengine_tpu_torch import MXFP8BlockScaling
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory

torch.set_num_threads(2)

B, S, H, FFN, N = 2, 128, 128, 256, 192


def _pair(x: np.ndarray, dtype=jnp.bfloat16, grad=True):
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return xj, xt.requires_grad_(grad)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, rtol, what=""):
    """Every element within ``rtol`` of the largest |ref|."""
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


def _sets(n: int = 1):
    return ([JFactory.create_set(te.MXFP8BlockScaling()) for _ in range(n)],
            [QuantizerFactory.create_set(MXFP8BlockScaling())
             for _ in range(n)])


def _fused(monkeypatch, on: bool):
    for name in ("TE_TPU_FUSED_QUANTIZE", "TE_TPU_FUSED_LN_QUANTIZE"):
        monkeypatch.setenv(name, "1" if on else "0")


# Tolerance, relative to the largest element. The payloads and scales are
# the same bytes on both sides and every dequantized product is exact in
# f32; only the order of the f32 sums differs, so a bf16 result may round
# one ulp (2^-8 of its value) apart, which the chained GEMMs of the MLP
# and the norm backwards pass on. Two such ulps of the largest element;
# the readings are below 1.9e-5 (the MLP's dw1), no bf16 value apart.
RTOL = 2 ** -7


def _inputs(seed, k=H, n=N):
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((B, S, k)))
    kern = _pair(rng.standard_normal((k, n)) / 8)
    g = _pair(rng.standard_normal((B, S, n)), grad=False)
    return rng, x, kern, g


@pytest.mark.parametrize("fused", [True, False])
def test_dense_fwd_bwd(fused, monkeypatch):
    _fused(monkeypatch, fused)
    _, (xj, xt), (kj, kt), (gj, gt) = _inputs(0)
    (js,), (ts,) = _sets()
    oj, vjp = jax.vjp(lambda x, k: j_dense(x, k, quantizer_set=js), xj, kj)
    dxj, dkj = vjp(gj)
    ot = dense(xt, kt, quantizer_set=ts)
    ot.backward(gt)
    assert ot.dtype == torch.bfloat16 and ot.shape == (B, S, N)
    _close(ot, oj, RTOL, "out")
    _close(xt.grad, dxj, RTOL, "dx")
    _close(kt.grad, dkj, RTOL, "dkernel")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_layernorm_dense_fwd_bwd(norm, fused, monkeypatch):
    _fused(monkeypatch, fused)
    rng, (xj, xt), (kj, kt), (gj, gt) = _inputs(2)
    gmj, gmt = _pair(rng.standard_normal(H) * 0.1, jnp.float32)
    bj, bt = _pair(rng.standard_normal(H) * 0.1, jnp.float32)
    ln = norm == "layernorm"
    (js,), (ts,) = _sets()
    # Zero-centered gamma with LayerNorm, plain gamma with RMSNorm.

    def fj(x, k, gm, b):
        return j_ln_dense(x, k, gm + (0 if ln else 1), b if ln else None,
                          norm_type=norm, zero_centered_gamma=ln,
                          epsilon=1e-5, quantizer_set=js)

    oj, vjp = jax.vjp(fj, xj, kj, gmj, bj)
    dxj, dkj, dgj, dbj = vjp(gj)
    with torch.no_grad():
        gm_in = gmt + (0 if ln else 1)
    gm_in.requires_grad_(True)
    ot = layernorm_dense(xt, kt, gm_in, beta=bt if ln else None,
                         norm_type=norm, zero_centered_gamma=ln,
                         epsilon=1e-5, quantizer_set=ts)
    ot.backward(gt)
    _close(ot, oj, RTOL, "out")
    _close(kt.grad, dkj, RTOL, "dkernel")
    _close(xt.grad, dxj, RTOL, "dx")
    _close(gm_in.grad, dgj, RTOL, "dgamma")
    if ln:
        _close(bt.grad, dbj, RTOL, "dbeta")


def _mlp_inputs(seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((B, S, H))),
            _pair(1 + 0.1 * rng.standard_normal(H), jnp.float32),
            _pair(rng.standard_normal((H, 2, FFN)) / 8),
            _pair(rng.standard_normal((FFN, H)) / 10),
            _pair(rng.standard_normal((B, S, H)), grad=False))


@pytest.mark.parametrize("fused", [True, False])
def test_layernorm_mlp_fwd_bwd(fused, monkeypatch):
    _fused(monkeypatch, fused)
    (xj, xt), (gmj, gmt), (w1j, w1t), (w2j, w2t), (gj, gt) = _mlp_inputs(4)
    js, ts = _sets(2)

    def fj(x, gm, w1, w2):
        return j_ln_mlp(x, gm, None, w1, w2, norm_type="rmsnorm",
                        activation_type="swiglu", quantizer_sets=tuple(js))

    oj, vjp = jax.vjp(fj, xj, gmj, w1j, w2j)
    grads_j = vjp(gj)
    ot = layernorm_mlp(xt, gmt, w1t, w2t, activation_type="swiglu",
                       quantizer_sets=tuple(ts))
    ot.backward(gt)
    _close(ot, oj, RTOL, "out")
    for name, got, ref in zip(("dx", "dgamma", "dw1", "dw2"),
                              (xt.grad, gmt.grad, w1t.grad, w2t.grad),
                              grads_j):
        _close(got, ref, RTOL, name)


LAYERS = ["dense", "layernorm_dense", "layernorm_mlp"]


def _calls(layer):
    """(JAX call, port call) of ``layer`` on seeded inputs, for the
    forward without a gradient."""
    (xj, xt), (gmj, gmt), (w1j, w1t), (w2j, w2t), _ = _mlp_inputs(6)
    js, ts = _sets(2)
    if layer == "dense":
        return (lambda: j_dense(xj, w2j.T, quantizer_set=js[0]),
                lambda: dense(xt, w2t.t(), quantizer_set=ts[0]))
    if layer == "layernorm_dense":
        return (lambda: j_ln_dense(xj, w2j.T, gmj, norm_type="rmsnorm",
                                   quantizer_set=js[0]),
                lambda: layernorm_dense(xt, w2t.t(), gmt,
                                        quantizer_set=ts[0]))
    return (lambda: j_ln_mlp(xj, gmj, None, w1j, w2j, norm_type="rmsnorm",
                             activation_type="swiglu",
                             quantizer_sets=tuple(js)),
            lambda: layernorm_mlp(xt, gmt, w1t, w2t, activation_type="swiglu",
                                  quantizer_sets=tuple(ts)))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("layer", LAYERS)
def test_forward_without_grad_matches_primal(layer, fused, monkeypatch):
    """Under no_grad each layer takes the reference primal's
    single-orientation branch and gives its output."""
    _fused(monkeypatch, fused)
    call_j, call_t = _calls(layer)
    oj = call_j()
    with torch.no_grad():
        ot = call_t()
    assert ot.grad_fn is None
    _close(ot, oj, RTOL)


# Quantize calls per layer call: (2x, 1x rowwise, 1x colwise, fused norm
# 2x, fused norm rowwise-only). Training: x, the kernel and the gradient
# in both orientations per GEMM, x from the fused norm in the norm layers.
# Without a gradient: x rowwise and the kernel colwise per GEMM, the
# layernorm_dense norm unfused (the reference excludes its primal from the
# fused path) and the MLP's fused norm rowwise-only.
_EXPECT = {
    ("dense", True): (3, 0, 0, 0, 0),
    ("layernorm_dense", True): (2, 0, 0, 1, 0),
    ("layernorm_mlp", True): (5, 0, 0, 1, 0),
    ("dense", False): (0, 1, 1, 0, 0),
    ("layernorm_dense", False): (0, 1, 1, 0, 0),
    ("layernorm_mlp", False): (0, 1, 2, 0, 1),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layer", LAYERS)
def test_branches_quantize_what_the_reference_does(layer, train,
                                                   monkeypatch):
    """The quantize calls each branch makes, counted on the plain
    versions (the same calls launch the kernels on the card)."""
    counts = []

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            counts.append(key(*args, **kwargs))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(qk, "mxfp8_quantize_2x_plain", counted(
        qk.mxfp8_quantize_2x_plain, lambda *a, **k: 0))
    monkeypatch.setattr(qk, "mxfp8_quantize_1x_plain", counted(
        qk.mxfp8_quantize_1x_plain, lambda *a, colwise, **k: 2 if colwise
        else 1))
    monkeypatch.setattr(qk, "mxfp8_norm_quantize_2x_plain", counted(
        qk.mxfp8_norm_quantize_2x_plain,
        lambda *a, rowwise_only=False, **k: 4 if rowwise_only else 3))
    _, call_t = _calls(layer)
    if train:
        call_t().float().sum().backward()
    else:
        with torch.no_grad():
            call_t()
    got = tuple(counts.count(i) for i in range(5))
    assert got == _EXPECT[layer, train], got
