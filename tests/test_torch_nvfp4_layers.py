"""The port's dense, layernorm_dense and layernorm_mlp under
NVFP4BlockScaling against the JAX package's layers: forward and backward
against ``jax.vjp`` of the reference's ``custom_vjp`` (its training
branch: both orientations of x, the kernel and the gradient, the colwise
usages of x and the gradient rotated by the RHT; no fused norm, since
NVFP4's quantizer has none), and the forward without a gradient
(``torch.no_grad``) against the reference's primal (x rowwise and the
kernel colwise through ``qmath``); and ``q_dot`` of two NVFP4 operands,
whose two second-level scales multiply the f32 product. The JAX side
runs with its fused kernels off, its default on the CPU:
``test_torch_nvfp4_kernels.py`` holds its fused (Pallas, interpret
mode) and unfused quantizes equal byte for byte, and its primal has no
fused NVFP4 kernel to switch."""
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
from transformerengine_tpu.ops.gemm import q_dot as j_q_dot
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
from transformerengine_tpu.quantize.quantizer import (
    QuantizeLayout as JLayout)
from transformerengine_tpu_torch import NVFP4BlockScaling
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.ops import gemm
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import QuantizeLayout

torch.set_num_threads(2)

B, S, H, FFN, N = 2, 32, 128, 256, 192


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
    return ([JFactory.create_set(te.NVFP4BlockScaling()) for _ in range(n)],
            [QuantizerFactory.create_set(NVFP4BlockScaling())
             for _ in range(n)])


def _unfused(monkeypatch):
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", "0")


# Tolerance, relative to the largest element. Every quantized operand is
# the same bytes on both sides (the RHT's sums included:
# test_torch_nvfp4_kernels.py), each dequantized block product is exact
# in bf16, and the tensor scales multiply the f32 result on both sides;
# only the order of the GEMMs' f32 sums differs, so a bf16 result may
# round one ulp (2^-8 of its value) apart. In the MLP that ulp can move
# the activation across an e2m1 rounding boundary, one code of one
# element. Two ulps of the largest element, as the MXFP8 layers are held;
# every output and gradient read 0 but dgamma (2.2e-7).
RTOL = 2 ** -7


def _inputs(seed, k=H, n=N):
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((B, S, k)))
    kern = _pair(rng.standard_normal((k, n)) / 8)
    g = _pair(rng.standard_normal((B, S, n)), grad=False)
    return rng, x, kern, g


def test_dense_fwd_bwd(monkeypatch):
    _unfused(monkeypatch)
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


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_layernorm_dense_fwd_bwd(norm, monkeypatch):
    _unfused(monkeypatch)
    rng, (xj, xt), (kj, kt), (gj, gt) = _inputs(2)
    gmj, gmt = _pair(rng.standard_normal(H) * 0.1, jnp.float32)
    bj, bt = _pair(rng.standard_normal(H) * 0.1, jnp.float32)
    ln = norm == "layernorm"
    (js,), (ts,) = _sets()

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


def test_layernorm_mlp_fwd_bwd(monkeypatch):
    _unfused(monkeypatch)
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


@pytest.mark.parametrize("layer", LAYERS)
def test_forward_without_grad_matches_primal(layer, monkeypatch):
    """Under no_grad each layer takes the reference primal's
    single-orientation branch and gives its output."""
    _unfused(monkeypatch)
    call_j, call_t = _calls(layer)
    oj = call_j()
    with torch.no_grad():
        ot = call_t()
    assert ot.grad_fn is None
    _close(ot, oj, RTOL)


# Calls per layer call: (nvfp4_amax_2x, nvfp4_quantize_2x, qmath's
# one-orientation nvfp4_quantize). Training: x, the kernel and the
# gradient in both orientations per GEMM, each an amax pass and a
# quantize pass (no fused norm). Without a gradient: x rowwise and the
# kernel colwise per GEMM, plain.
_EXPECT = {
    ("dense", True): (3, 3, 0),
    ("layernorm_dense", True): (3, 3, 0),
    ("layernorm_mlp", True): (6, 6, 0),
    ("dense", False): (0, 0, 2),
    ("layernorm_dense", False): (0, 0, 2),
    ("layernorm_mlp", False): (0, 0, 4),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layer", LAYERS)
def test_branches_quantize_what_the_reference_does(layer, train,
                                                   monkeypatch):
    """The quantize calls each branch makes, counted on the plain
    versions (the same calls launch the kernels on the card)."""
    counts = []

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            counts.append(key)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counted(qk, "nvfp4_amax_2x_plain", 0)
    counted(qk, "nvfp4_quantize_2x_plain", 1)
    counted(qmath, "nvfp4_quantize", 2)
    _, call_t = _calls(layer)
    if train:
        call_t().float().sum().backward()
    else:
        with torch.no_grad():
            call_t()
    got = tuple(counts.count(i) for i in range(3))
    assert got == _EXPECT[layer, train], got


def test_q_dot_applies_both_tensor_scales():
    """``q_dot`` of a rowwise NVFP4 x and a colwise NVFP4 kernel (the
    weight role: no RHT) against
    the reference's: the bf16 block products and then both operands'
    tensor scales on the f32 result (sums in another order: 1e-6 of the
    largest element). Without the tensor scales the product is off by
    their product, far from x . kernel."""
    rng = np.random.default_rng(8)
    xj, xt = _pair(rng.standard_normal((64, 256)) * 3, grad=False)
    kj, kt = _pair(rng.standard_normal((256, 128)) / 8, grad=False)
    jq = JFactory.create(te.NVFP4BlockScaling(), "kernel")
    tq = QuantizerFactory.create(NVFP4BlockScaling(), "kernel")
    qx_t = tq.quantize(xt, layout=QuantizeLayout.ROWWISE)
    qk_t = tq.quantize(kt, layout=QuantizeLayout.COLWISE)
    qx_j = jq.quantize(xj, layout=JLayout.ROWWISE)
    qk_j = jq.quantize(kj, layout=JLayout.COLWISE)
    ref = j_q_dot(qx_j, qk_j, 1, 1)
    got = gemm.q_dot(qx_t, qk_t, 1, 1)
    assert got.dtype == torch.float32
    _close(got, ref, 1e-6)
    exact = xt.float() @ kt.float()
    err = float((got - exact).abs().max() / exact.abs().max())
    assert err < 0.2, err
    ts = float(qx_t.tensor_scale_inv) * float(qk_t.tensor_scale_inv)
    assert ts < 1e-4
    bare = gemm.q_dot(
        qx_t.__class__(**{**vars(qx_t), "tensor_scale_inv": None}),
        qk_t.__class__(**{**vars(qk_t), "tensor_scale_inv": None}), 1, 1)
    np.testing.assert_allclose(_np(bare) * ts, _np(got), rtol=1e-5,
                               atol=1e-6 * np.abs(_np(got)).max())
