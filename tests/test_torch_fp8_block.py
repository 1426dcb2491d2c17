"""FP8 block scaling (``Float8BlockScaling``) in the port against the JAX
package: ``qmath.block_quantize`` in 1D (1 x 128) and 2D (128 x 128)
blocks, power-of-two scales and not, bitwise where XLA's CPU ``exp2`` is
exact (exponents -12..12) and against an exact numpy rule everywhere
(tiny, zero, subnormal and infinite amaxes, ragged blocks); the factory's
mode per role; the f32 dequantize; and ``dense``, ``layernorm_dense``,
``layernorm_mlp`` and ``grouped_dense`` forward and backward against the
reference's ``custom_vjp`` and primal, with every MXFP8, NVFP4 and
per-tensor quantize kernel patched to raise: FP8 block scaling is plain
PyTorch in the port, as plain XLA in the reference, and must reach none
of them."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.dense import dense as j_dense
from transformerengine_tpu.grouped_dense import grouped_dense as j_grouped
from transformerengine_tpu.layernorm_dense import (
    layernorm_dense as j_ln_dense)
from transformerengine_tpu.layernorm_mlp import layernorm_mlp as j_ln_mlp
from transformerengine_tpu.quantize import qmath as j_qmath
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
from transformerengine_tpu.quantize.tensor import (
    make_scaled_tensor as j_scaled)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import Float8BlockScaling
from transformerengine_tpu_torch.dense import dense
from transformerengine_tpu_torch.grouped_dense import grouped_dense
from transformerengine_tpu_torch.layernorm_dense import layernorm_dense
from transformerengine_tpu_torch.layernorm_mlp import layernorm_mlp
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode
from transformerengine_tpu_torch.quantize.tensor import ScaledTensor1x

torch.set_num_threads(2)

E4M3 = torch.float8_e4m3fn
# The quantize kernels FP8 block scaling must never reach.
KERNELS = ("cast_transpose", "norm_cast_transpose", "mxfp8_quantize_1x",
           "mxfp8_quantize_2x", "mxfp8_norm_quantize_2x",
           "mxfp8_qdq_2x_grouped", "nvfp4_amax_2x", "nvfp4_quantize_2x")


@pytest.fixture
def no_kernels(monkeypatch):
    """Every quantize kernel wrapper raises if called."""
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} reached under FP8 block scaling")
        return call
    for name in KERNELS:
        monkeypatch.setattr(qk, name, refuse(name))


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy() \
            if t.dtype == E4M3 else t.numpy()
    return np.asarray(t).view(np.uint8) if t.dtype == jnp.float8_e4m3fn \
        else np.asarray(t)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _np_block_quantize(x: np.ndarray, br: int, bc: int, pow2: bool):
    """The exact rule: per-block amax (zero padding), scale = 448 /
    max(amax, 2^-126) in f32 (under ``pow2`` the largest power of two at
    or below max(it, 2^-126), by frexp, inf past 2^127), 1 where the amax
    is 0 or the scale not finite; payload = e4m3(clip(x * scale,
    +-448))."""
    x = x.astype(np.float32)
    r, c = x.shape
    gr, gc = -(-r // br), -(-c // bc)
    xp = np.zeros((gr * br, gc * bc), np.float32)
    xp[:r, :c] = np.abs(x)
    amax = xp.reshape(gr, br, gc, bc).max(axis=(1, 3))
    with np.errstate(over="ignore", divide="ignore"):
        quot = np.float32(448.0) / np.maximum(amax, np.float32(2.0 ** -126))
        if pow2:
            _, e = np.frexp(np.maximum(quot, np.float32(2.0 ** -126)))
            scale = np.where(e - 1 > 127, np.float32(np.inf),
                             np.ldexp(np.float32(1), e - 1).astype(
                                 np.float32))
            scale = np.where(np.isinf(quot), np.float32(np.inf), scale)
        else:
            scale = quot
    scale = np.where((amax > 0) & np.isfinite(scale), scale,
                     np.float32(1)).astype(np.float32)
    full = np.repeat(np.repeat(scale, br, 0), bc, 1)[:r, :c]
    with np.errstate(invalid="ignore", over="ignore"):
        y = np.clip(x * full, -448, 448)
    data = y.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    with np.errstate(divide="ignore"):
        return data, (np.float32(1) / scale).astype(np.float32), scale


def _in_exp2_range(x: np.ndarray, br: int, bc: int) -> bool:
    _, _, scale = _np_block_quantize(x, br, bc, True)
    e = np.log2(scale)
    return bool(np.all((e >= -12) & (e <= 12)))


# (rows, cols) with a ragged last block both ways.
SHAPE = (200, 300)


def _inputs(seed: int, dtype=np.float32):
    """Blocks of very different magnitudes (amax 0.1 to 300), inside the
    exp2 range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE) * np.exp(rng.uniform(-2, 4, (SHAPE[0], 1)))
    return x.astype(np.float32)


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("pow2", [True, False])
def test_block_quantize_bitwise_against_reference(dims, pow2):
    br, bc = (1, 128) if dims == 1 else (128, 128)
    x = _inputs(dims + 2 * pow2)
    assert _in_exp2_range(x, br, bc)
    dj, sj = j_qmath.block_quantize(jnp.asarray(x), jnp.float8_e4m3fn, br,
                                    bc, pow2)
    dt, st = qmath.block_quantize(torch.from_numpy(x), E4M3, br, bc, pow2)
    np.testing.assert_array_equal(_bytes(dt), _bytes(dj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dn, sn, _ = _np_block_quantize(x, br, bc, pow2)
    np.testing.assert_array_equal(_bytes(dt), dn)
    np.testing.assert_array_equal(st.numpy(), sn)
    if pow2:
        m, _ = np.frexp(st.numpy())
        assert np.all(m == 0.5)


def _hard_input() -> np.ndarray:
    """Rows of 1 x 128 blocks whose amaxes run from 1e-36 to 3e38, so the
    power-of-two exponents leave -12..12 (XLA's CPU exp2 is inexact
    there), a zero block, a block of subnormals and one holding inf."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((96, 256)).astype(np.float32)
    x *= np.float32(10.0) ** np.linspace(-36, 37, 96, dtype=np.float32)[
        :, None]
    x[3, :128] = 0.0
    x[5, :128] = rng.standard_normal(128).astype(np.float32) * 1e-40
    x[7, 5] = np.inf
    return x


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("pow2", [True, False])
def test_block_quantize_is_exact_where_xla_is_not(dims, pow2):
    br, bc = (1, 128) if dims == 1 else (128, 128)
    x = _hard_input()
    dn, sn, scale = _np_block_quantize(x, br, bc, pow2)
    dt, st = qmath.block_quantize(torch.from_numpy(x), E4M3, br, bc, pow2)
    np.testing.assert_array_equal(_bytes(dt), dn)
    np.testing.assert_array_equal(st.numpy(), sn)
    if dims == 1:
        e = np.log2(scale[scale > 0])
        assert e.max() > 12 and e.min() < -12


def _edge_block(case: str) -> np.ndarray:
    x = np.linspace(-2, 2, 128, dtype=np.float32)[None, :].copy()
    if case == "zero":
        x[:] = 0.0
    elif case == "tiny":
        x *= np.float32(5e-31)
    elif case == "subnormal":
        x *= np.float32(5e-41)
    else:
        x[0, 7] = np.inf
    return x


@pytest.mark.parametrize("case", ["zero", "tiny", "subnormal", "inf"])
def test_block_quantize_edge_blocks(case):
    """The reference's rule at its edges, one block each: a zero block
    takes scale 1 (payload zeros); a tiny amax (1e-30) a power of two far
    above 2^12; a block of subnormals (amax below 2^-126) scale 1, as its
    quotient overflows; a block holding inf the scale 2^-126, its inf
    clipped to 448 and its finite elements to zero."""
    x = _edge_block(case)
    dt, st = qmath.block_quantize(torch.from_numpy(x), E4M3, 1, 128)
    dn, sn, scale = _np_block_quantize(x, 1, 128, True)
    np.testing.assert_array_equal(_bytes(dt), dn)
    np.testing.assert_array_equal(st.numpy(), sn)
    data = dt.float().numpy()
    want = {"zero": 1.0, "subnormal": 1.0, "inf": 2.0 ** -126,
            "tiny": 2.0 ** int(np.floor(np.log2(448 / 1e-30)))}[case]
    assert scale[0, 0] == want
    if case in ("zero", "subnormal"):
        assert not data.any()
    if case == "inf":
        assert data[0, 7] == 448 and np.count_nonzero(data) == 1
    if case == "tiny":
        assert 224 < np.abs(data).max() <= 448
    if case == "zero":
        dj, sj = j_qmath.block_quantize(jnp.asarray(x), jnp.float8_e4m3fn,
                                        1, 128, True)
        np.testing.assert_array_equal(_bytes(dt), _bytes(dj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kw", [{}, dict(w_block_scaling_dim=1),
                                dict(x_block_scaling_dim=2,
                                     grad_block_scaling_dim=2,
                                     force_pow_2_scales=False)])
def test_factory_modes_per_role(kw):
    for role in ("x", "kernel", "dgrad"):
        t = QuantizerFactory.create(Float8BlockScaling(**kw), role)
        j = JFactory.create(te.Float8BlockScaling(**kw), role)
        assert t.scaling_mode.name == j.scaling_mode.name
        assert t.scaling_mode.value == j.scaling_mode.value
        assert t.pow2_scales == j.pow2_scales
        assert t.q_dtype == E4M3 and j.q_dtype == jnp.float8_e4m3fn
        assert t.scaling_mode.block_shape == j.scaling_mode.block_shape
    qs = QuantizerFactory.create_set(Float8BlockScaling())
    assert qs.kernel.scaling_mode is ScalingMode.BLOCK_SCALING_2D
    assert qs.x.scaling_mode is ScalingMode.BLOCK_SCALING_1D
    assert qs.x.scaling_mode.is_block_scaling
    assert not qs.x.scaling_mode.is_tensor_scaling
    with pytest.raises(ValueError, match="block_scaling_dim"):
        Float8BlockScaling(x_block_scaling_dim=3)


@pytest.mark.parametrize("dims", [1, 2])
def test_dequantize_multiplies_in_f32(dims):
    """A non-power-of-two f32 scale times an e4m3 value is not a bf16
    value: both sides multiply in f32 and round once to bf16."""
    br, bc = (1, 128) if dims == 1 else (128, 128)
    x = _inputs(11)
    mode = (ScalingMode.BLOCK_SCALING_1D if dims == 1
            else ScalingMode.BLOCK_SCALING_2D)
    dt, st = qmath.block_quantize(torch.from_numpy(x), E4M3, br, bc, False)
    dj, sj = j_qmath.block_quantize(jnp.asarray(x), jnp.float8_e4m3fn, br,
                                    bc, False)
    from transformerengine_tpu.quantize.scaling_modes import (
        ScalingMode as JMode)
    got = ScaledTensor1x(dt, st, None, torch.bfloat16,
                         scaling_mode=mode).dequantize()
    ref = j_scaled(dj, sj, scaling_mode=JMode[mode.name],
                   dq_dtype=jnp.bfloat16).dequantize()
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    exact = (dt.float() * st.repeat_interleave(br, 0)[:SHAPE[0]]
             .repeat_interleave(bc, 1)[:, :SHAPE[1]]).to(torch.bfloat16)
    assert torch.equal(got, exact)
    by_bf16 = dt.to(torch.bfloat16) * st.repeat_interleave(br, 0)[
        :SHAPE[0]].repeat_interleave(bc, 1)[:, :SHAPE[1]].to(torch.bfloat16)
    assert not torch.equal(got, by_bf16)


# Layers: M = 256, H = 256, FFN = 512, so every 128 x 128 weight tile and
# 1 x 128 block is whole, plus a ragged N for dense.
B, S, H, FFN, N = 2, 128, 256, 512, 320
# Tolerance, relative to the largest element: payloads and scales are the
# same bytes on both sides (every block's exponent inside -12..12) and
# every dequantized operand the same bf16 values; only the f32 sums'
# order differs, so a bf16 result may round one ulp apart, which chained
# GEMMs and the norm backward pass on. Two ulps of the largest element.
RTOL = 2 ** -7


def _pair(x: np.ndarray, dtype=jnp.bfloat16, grad=True):
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return xj, xt.requires_grad_(grad)


def _close(got, ref, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def _sets(n: int = 1, **kw):
    return ([JFactory.create_set(te.Float8BlockScaling(**kw))
             for _ in range(n)],
            [QuantizerFactory.create_set(Float8BlockScaling(**kw))
             for _ in range(n)])


@pytest.mark.parametrize("pow2", [True, False])
def test_dense_fwd_bwd(pow2, no_kernels):
    rng = np.random.default_rng(20 + pow2)
    xj, xt = _pair(rng.standard_normal((B, S, H)))
    kj, kt = _pair(rng.standard_normal((H, N)) / 4)
    gj, gt = _pair(rng.standard_normal((B, S, N)), grad=False)
    (js,), (ts,) = _sets(force_pow_2_scales=pow2)
    oj, vjp = jax.vjp(lambda x, k: j_dense(x, k, quantizer_set=js), xj, kj)
    dxj, dkj = vjp(gj)
    ot = dense(xt, kt, quantizer_set=ts)
    ot.backward(gt)
    assert ot.dtype == torch.bfloat16 and ot.shape == (B, S, N)
    _close(ot, oj, "out")
    _close(xt.grad, dxj, "dx")
    _close(kt.grad, dkj, "dkernel")
    with torch.no_grad():
        primal = dense(xt, kt, quantizer_set=ts)
    _close(primal, j_dense(xj, kj, quantizer_set=js), "primal")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_layernorm_dense_fwd_bwd(norm, no_kernels):
    rng = np.random.default_rng(30)
    xj, xt = _pair(rng.standard_normal((B, S, H)) * 2 + 0.5)
    kj, kt = _pair(rng.standard_normal((H, N)) / 4)
    gmj, gmt = _pair(1 + 0.1 * rng.standard_normal(H), jnp.float32)
    bj, bt = _pair(rng.standard_normal(H) * 0.1, jnp.float32)
    gj, gt = _pair(rng.standard_normal((B, S, N)), grad=False)
    ln = norm == "layernorm"
    (js,), (ts,) = _sets()

    def fj(x, k, gm, b):
        return j_ln_dense(x, k, gm, b if ln else None, norm_type=norm,
                          epsilon=1e-5, quantizer_set=js)

    oj, vjp = jax.vjp(fj, xj, kj, gmj, bj)
    dxj, dkj, dgj, dbj = vjp(gj)
    ot = layernorm_dense(xt, kt, gmt, beta=bt if ln else None,
                         norm_type=norm, epsilon=1e-5, quantizer_set=ts)
    ot.backward(gt)
    _close(ot, oj, "out")
    _close(kt.grad, dkj, "dkernel")
    _close(xt.grad, dxj, "dx")
    _close(gmt.grad, dgj, "dgamma")
    if ln:
        _close(bt.grad, dbj, "dbeta")
    with torch.no_grad():
        primal = layernorm_dense(xt, kt, gmt, beta=bt if ln else None,
                                 norm_type=norm, epsilon=1e-5,
                                 quantizer_set=ts)
    _close(primal, fj(xj, kj, gmj, bj), "primal")


def test_layernorm_mlp_fwd_bwd(no_kernels):
    rng = np.random.default_rng(40)
    xj, xt = _pair(rng.standard_normal((B, S, H)))
    gmj, gmt = _pair(1 + 0.1 * rng.standard_normal(H), jnp.float32)
    k1j, k1t = _pair(rng.standard_normal((H, 2, FFN)) / 4)
    k2j, k2t = _pair(rng.standard_normal((FFN, H)) / 4)
    gj, gt = _pair(rng.standard_normal((B, S, H)) * 4, grad=False)
    js, ts = _sets(2)
    acts = ("silu", "linear")

    def fj(x, gm, k1, k2):
        return j_ln_mlp(x, gm, None, k1, k2, norm_type="rmsnorm",
                        activation_type=acts, quantizer_sets=tuple(js))

    oj, vjp = jax.vjp(fj, xj, gmj, k1j, k2j)
    dxj, dgj, dk1j, dk2j = vjp(gj)
    ot = layernorm_mlp(xt, gmt, k1t, k2t, norm_type="rmsnorm",
                       activation_type=acts, quantizer_sets=tuple(ts))
    ot.backward(gt)
    for got, ref, what in ((ot, oj, "out"), (xt.grad, dxj, "dx"),
                           (gmt.grad, dgj, "dgamma"), (k1t.grad, dk1j, "dk1"),
                           (k2t.grad, dk2j, "dk2")):
        _close(got, ref, what)
    with torch.no_grad():
        primal = layernorm_mlp(xt, gmt, k1t, k2t, norm_type="rmsnorm",
                               activation_type=acts,
                               quantizer_sets=tuple(ts))
    _close(primal, fj(xj, gmj, k1j, k2j), "primal")


def test_grouped_dense_fwd_bwd(no_kernels):
    """FP8 block scaling takes the plain quantize of the swapped kernel
    (2D tiles of the folded (E * M, K) view), never the MXFP8 grouped
    QDQ kernel."""
    rng = np.random.default_rng(50)
    sizes = [96, 160]
    xj, xt = _pair(rng.standard_normal((256, 128)))
    wj, wt = _pair(rng.standard_normal((2, 128, 192)) / 4)
    gj, gt = _pair(rng.standard_normal((256, 192)), grad=False)
    (js,), (ts,) = _sets()
    gs = jnp.asarray(sizes, jnp.int32)
    oj, vjp = jax.vjp(lambda x, w: j_grouped(x, w, gs, quantizer_set=js),
                      xj, wj)
    dxj, dwj = vjp(gj)
    ot = grouped_dense(xt, wt, sizes, quantizer_set=ts)
    ot.backward(gt)
    _close(ot, oj, "out")
    _close(xt.grad, dxj, "dx")
    _close(wt.grad, dwj, "dw")


def test_exports():
    assert tt.Float8BlockScaling().float8_block_scaling()
    assert tt.recipe.Float8BlockScaling is Float8BlockScaling
