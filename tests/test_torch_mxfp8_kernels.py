"""The plain versions of the port's MXFP8 kernels against the JAX
package: mxfp8_quantize_2x, mxfp8_quantize_1x and mxfp8_norm_quantize_2x
against their Pallas kernels (interpret mode on the CPU) and against
``qmath.mxfp8_quantize``, through the wrappers and through the quantizer
API, the JAX side run with its fused kernels on and off; payload and
scale bytes equal.

XLA's CPU ``exp2`` is exact for the integer exponents -12..12 but not for
most outside them (2^17, 2^-13, 2^127, ...), and XLA on the CPU flushes
subnormals, so the reference's payloads on the CPU move by one code where
a block's exponent lies outside that range, at ties of the fp8 rounding.
The port computes 2^-e exactly from its bits, as its kernels do. Inputs held against the JAX package keep every block's
exponent inside -12..12; the cases outside it (gradient-sized values,
blocks below the E8M0 clip, subnormals) are held against an exact numpy
version of the rule instead.

On CPU tensors each wrapper runs its plain version, which is what these
tests reach; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.ops.quantize_kernels import (
    mxfp8_norm_quantize_2x as j_norm_quantize,
    mxfp8_quantize_1x as j_quantize_1x, mxfp8_quantize_2x as j_quantize_2x)
from transformerengine_tpu.ops.normalization import (
    layernorm_fwd as j_layernorm_fwd, rmsnorm_fwd as j_rmsnorm_fwd)
from transformerengine_tpu.quantize import qmath as jqmath
from transformerengine_tpu.quantize.dtypes import (
    float8_e4m3 as j_e4m3, float8_e5m2 as j_e5m2)
from transformerengine_tpu.quantize.helper import QuantizerFactory as JFactory
from transformerengine_tpu.quantize.quantizer import (
    QuantizeLayout as JLayout)
from transformerengine_tpu.quantize.scaling_modes import (
    ScalingMode as JMode)
from transformerengine_tpu_torch import MXFP8BlockScaling, Recipe
from transformerengine_tpu_torch.ops.quantize_kernels import (
    mxfp8_norm_quantize_2x, mxfp8_quantize_1x, mxfp8_quantize_2x)
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch.quantize.dtypes import decode_e8m0
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    BlockScaleQuantizer, QuantizeLayout)
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode
from transformerengine_tpu_torch.quantize.tensor import (
    ScaledTensor2x, get_colwise, get_rowwise)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
_JQ = {"e4m3": j_e4m3, "e5m2": j_e5m2}
_TQ = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
_NQ = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _assert_bytes(got, ref, what=""):
    assert tuple(got.shape) == tuple(ref.shape), what
    np.testing.assert_array_equal(_bytes(got), _bytes(ref), err_msg=what)


def _np_mxfp8(x: np.ndarray, q: str):
    """The MXFP8 rule in exact numpy f32 arithmetic along the last axis:
    (payload bytes, scale bytes)."""
    r, c = x.shape
    gc = -(-c // 32)
    pad = np.zeros((r, gc * 32), np.float32)
    pad[:, :c] = np.abs(x)
    amax = pad.reshape(r, gc, 32).max(axis=-1)
    e = (np.maximum(amax, np.float32(2.0 ** -126)).view(np.int32) >> 23) \
        - 127 - 8
    e = np.where(amax > 0, np.clip(e, -127, 127), 0)
    mult = np.ldexp(np.float32(1.0), -e).astype(np.float32)
    y = x.astype(np.float32) * np.repeat(mult, 32, axis=1)[:, :c]
    qmax = 448.0 if q == "e4m3" else 57344.0
    data = np.clip(y, -qmax, qmax).astype(_NQ[q]).view(np.uint8)
    return data, (e + 127).astype(np.uint8)


def _input(shape, dtype, seed, mag=7.0):
    """Normal values whose block amaxes keep the exponents inside -12..12;
    the second half of the rows 2^10 larger (a colwise block that took a
    row's scale would fail), and one 32 x 32 block of zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * mag
    x[shape[0] // 2:] *= 2.0 ** 10
    x[:32, :32] = 0.0
    return _pair(x, dtype)


_QUANT_CASES = [((128, 256), "bf16", "e4m3"), ((256, 384), "f32", "e4m3"),
                ((256, 384), "bf16", "e5m2"), ((128, 256), "f32", "e5m2")]


@pytest.mark.parametrize("shape,dtype,q", _QUANT_CASES)
def test_quantize_2x_and_1x_match_pallas(shape, dtype, q):
    xj, xt = _input(shape, dtype, sum(shape))
    ref = j_quantize_2x(xj, _JQ[q], tile=(64, 128))
    got = mxfp8_quantize_2x(xt, _TQ[q])
    for name, a, r in zip(("row", "col", "srow", "scol"), got, ref):
        _assert_bytes(a, r, name)
    assert got[2].dtype == got[3].dtype == torch.uint8
    # The input is discriminating: the colwise payload is not the
    # transpose of the rowwise one.
    assert not np.array_equal(_bytes(got[1]), _bytes(got[0]).T)
    for colwise, (data, scale) in ((False, (ref[0], ref[2])),
                                   (True, (ref[1], ref[3]))):
        d, s = mxfp8_quantize_1x(xt, _TQ[q], colwise=colwise)
        dj, sj = j_quantize_1x(xj, _JQ[q], colwise=colwise, tile=(64, 128))
        for a, r1, r2 in ((d, data, dj), (s, scale, sj)):
            _assert_bytes(a, r1, f"1x colwise={colwise}")
            _assert_bytes(a, r2, f"1x colwise={colwise} (Pallas 1x)")


@pytest.mark.parametrize("shape", [(100, 37), (24, 40), (33, 97)])
def test_ragged_shapes_match_qmath_of_each_orientation(shape):
    """Shapes the reference's kernels do not take: the port's masked edges
    give ``qmath.mxfp8_quantize`` of each orientation, ceil(. / 32) scale
    columns and the last block's amax over the elements that exist."""
    xj, xt = _input(shape, "bf16", shape[0], mag=3.0)
    row, col, srow, scol = mxfp8_quantize_2x(xt)
    rj, srj = jqmath.mxfp8_quantize(xj, j_e4m3)
    cj, scj = jqmath.mxfp8_quantize(xj.T, j_e4m3)
    for name, a, r in (("row", row, rj), ("col", col, cj),
                       ("srow", srow, srj), ("scol", scol, scj)):
        _assert_bytes(a, r, name)
    assert srow.shape == (shape[0], -(-shape[1] // 32))
    assert scol.shape == (shape[1], -(-shape[0] // 32))
    for colwise, (d_ref, s_ref) in ((False, (row, srow)), (True, (col, scol))):
        d, s = mxfp8_quantize_1x(xt, colwise=colwise)
        _assert_bytes(d, d_ref)
        _assert_bytes(s, s_ref)


def _hard_input(dtype: str):
    """Blocks the reference cannot hold on the CPU: gradient-sized values
    (exponents near -25), blocks below the E8M0 clip (amax < 2^-118,
    exponent -127, multiplier 2^127) with subnormal elements, and large
    values whose exponents lie above 12."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((96, 100)).astype(np.float32)
    x[:32] *= 1e-5
    x[32:48] *= 2.0 ** -125            # below the clip, some subnormal
    x[48:64, :32] = rng.choice([0.0, 2.0 ** -130, -3 * 2.0 ** -133],
                               (16, 32))
    x[64:] *= 2.0 ** 30
    if dtype == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype,q", [("bf16", "e4m3"), ("f32", "e4m3"),
                                     ("f32", "e5m2")])
def test_quantize_is_exact_where_xla_is_not(dtype, q):
    """Both orientations against the exact numpy rule, and the subnormal
    elements of the clipped blocks quantized, not flushed to zero."""
    xt = _hard_input(dtype)
    row, col, srow, scol = mxfp8_quantize_2x(xt, _TQ[q])
    x = xt.float().numpy()
    for name, got, ref in (("row", (row, srow), _np_mxfp8(x, q)),
                           ("col", (col, scol), _np_mxfp8(x.T.copy(), q))):
        _assert_bytes(got[0], ref[0], name + " payload")
        _assert_bytes(got[1], ref[1], name + " scales")
    assert int(srow[32:64].min()) == 0          # exponent -127
    sub = row[48:64, :32].float()
    assert float(sub[xt[48:64, :32].float() != 0].abs().min()) > 0


# (dtype, norm, zero-centered gamma, beta, rowwise only, shape)
_NORM_CASES = [("bf16", "rmsnorm", False, False, False, (256, 384)),
               ("bf16", "layernorm", True, True, False, (128, 256)),
               ("f32", "layernorm", False, True, True, (256, 384)),
               ("bf16", "rmsnorm", True, False, True, (128, 256))]


@pytest.mark.parametrize("dtype,norm,zcg,with_beta,rowwise_only,shape",
                         _NORM_CASES)
def test_norm_quantize_matches_pallas(dtype, norm, zcg, with_beta,
                                      rowwise_only, shape):
    rng = np.random.default_rng(_NORM_CASES.index(
        (dtype, norm, zcg, with_beta, rowwise_only, shape)))
    m, h = shape
    xj, xt = _pair(rng.standard_normal((m, h)) * 2 + 0.5, dtype)
    gamma = (rng.standard_normal(h) * 0.2 + (0 if zcg else 1)).astype(
        np.float32)
    beta = (rng.standard_normal(h) * 0.1).astype(np.float32) \
        if with_beta else None
    kw = dict(norm=norm, zero_centered_gamma=zcg, epsilon=1e-5,
              rowwise_only=rowwise_only)
    outs_j = j_norm_quantize(
        xj, jnp.asarray(gamma), None if beta is None else jnp.asarray(beta),
        j_e4m3, **kw)
    outs_t = mxfp8_norm_quantize_2x(
        xt, torch.from_numpy(gamma),
        None if beta is None else torch.from_numpy(beta), **kw)
    assert len(outs_t) == len(outs_j) == (6 if norm == "layernorm" else 5)
    # The row sums run in other orders, which may move rsigma (and mu) by
    # an f32 ulp, as in test_norm_cast_transpose_matches_pallas (an f32
    # input's LayerNorm read two ulps there).
    rs_rtol = 4e-7 if dtype == "f32" else 2e-7
    np.testing.assert_allclose(outs_t[4].numpy(), np.asarray(outs_j[4]),
                               rtol=rs_rtol)
    if norm == "layernorm":
        np.testing.assert_allclose(outs_t[5].numpy(), np.asarray(outs_j[5]),
                                   rtol=rs_rtol, atol=1e-7)
    # Payloads and scales: equal (no reading had a byte apart).
    for name, a, r in zip(("row", "col", "srow", "scol"), outs_t[:4],
                          outs_j[:4]):
        if rowwise_only and name in ("col", "scol"):
            assert a is None and r is None
            continue
        _assert_bytes(a, r, name)


@pytest.mark.parametrize("fused", [True, False])
def test_quantizer_api_matches_jax(fused, monkeypatch):
    """The port's BlockScaleQuantizer in all three layouts against the
    reference's quantizer with its Pallas kernels on (interpret mode) and
    off (qmath)."""
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", "1" if fused else "0")
    xj, xt = _input((2, 64, 256), "bf16", 17)
    jq = JFactory.create(te.MXFP8BlockScaling(), "x")
    tq = QuantizerFactory.create(MXFP8BlockScaling(), "x")
    assert isinstance(tq, BlockScaleQuantizer)
    assert tq.scaling_mode is ScalingMode.MXFP8_1D_SCALING
    both_j, both_t = jq.quantize(xj), tq.quantize(xt)
    assert isinstance(both_t, ScaledTensor2x)
    pairs = [(get_rowwise(both_t), both_j.rowwise),
             (get_colwise(both_t), both_j.colwise)]
    for lj, lt in ((JLayout.ROWWISE, QuantizeLayout.ROWWISE),
                   (JLayout.COLWISE, QuantizeLayout.COLWISE)):
        pairs.append((tq.quantize(xt, layout=lt), jq.quantize(xj, layout=lj)))
    for t, j in pairs:
        assert t.layout == j.layout and t.amax is None
        _assert_bytes(t.data, j.data, t.layout)
        _assert_bytes(t.scale_inv, j.scale_inv, t.layout)
        assert t.data.shape == ((256, 2, 64) if t.layout == "T"
                                else (2, 64, 256))
        # Dequantized values: the payload times its power of two, exact in
        # bf16 on both sides.
        np.testing.assert_array_equal(
            t.dequantize().float().numpy(),
            np.asarray(j.dequantize(), np.float32))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_quantize_normed_matches_jax(norm, fused, monkeypatch):
    """``quantize_normed``: the reference's fused kernel (on) or, where it
    returns None (off), its norm followed by the 2x quantize; and the
    shape rule, M % 256 == 0 and H % 128 == 0."""
    monkeypatch.setenv("TE_TPU_FUSED_LN_QUANTIZE", "1" if fused else "0")
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", "1" if fused else "0")
    rng = np.random.default_rng(23)
    xj, xt = _pair(rng.standard_normal((256, 128)) * 1.5, "bf16")
    gamma = (rng.standard_normal(128) * 0.2 + 1).astype(np.float32)
    beta = (rng.standard_normal(128) * 0.1).astype(np.float32) \
        if norm == "layernorm" else None
    gj, gt = jnp.asarray(gamma), torch.from_numpy(gamma)
    bj = None if beta is None else jnp.asarray(beta)
    bt = None if beta is None else torch.from_numpy(beta)
    jq = JFactory.create(te.MXFP8BlockScaling(), "x")
    tq = QuantizerFactory.create(MXFP8BlockScaling(), "x")
    kw = dict(norm=norm, zero_centered_gamma=False, epsilon=1e-6)
    out_j = jq.quantize_normed(xj, gj, bj, **kw)
    if fused:
        assert out_j is not None
        both_j, mu_j, rs_j = out_j
    else:
        assert out_j is None
        if norm == "layernorm":
            normed, mu_j, rs_j = j_layernorm_fwd(xj, gj, bj, epsilon=1e-6)
        else:
            (normed, rs_j), mu_j = j_rmsnorm_fwd(xj, gj, epsilon=1e-6), None
        both_j = jq.quantize(normed)
    both_t, mu_t, rs_t = tq.quantize_normed(xt, gt, bt, **kw)
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j), rtol=2e-7)
    assert (mu_t is None) == (mu_j is None)
    for usage in ("rowwise", "colwise"):
        t, j = getattr(both_t, usage), getattr(both_j, usage)
        _assert_bytes(t.data, j.data, usage)
        _assert_bytes(t.scale_inv, j.scale_inv, usage)
    row_t, _, _ = tq.quantize_normed(xt, gt, bt, layout=QuantizeLayout.ROWWISE,
                                     **kw)
    _assert_bytes(row_t.data, both_j.rowwise.data)
    assert tq.quantize_normed(xt[:128], gt, bt, **kw) is None
    assert tq.quantize_normed(xt[:, :96], gt[:96],
                              None if bt is None else bt[:96], **kw) is None


def test_e8m0_decode_scaling_modes_and_recipe():
    e = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = np.ldexp(np.float32(1.0), np.arange(256) - 127).astype(np.float32)
    np.testing.assert_array_equal(decode_e8m0(e).numpy(), want)
    mode, jmode = ScalingMode.MXFP8_1D_SCALING, JMode.MXFP8_1D_SCALING
    assert not mode.is_tensor_scaling and mode.block_shape == (1, 32)
    for shape in ((4, 33), (3, 5, 64), (7,)):
        assert mode.scale_shape(shape) == jmode.scale_shape(shape)
    for m in (ScalingMode.DELAYED_TENSOR_SCALING,
              ScalingMode.CURRENT_TENSOR_SCALING):
        assert m.is_tensor_scaling and m.scale_shape((4, 33)) == (1,)
    recipe = MXFP8BlockScaling()
    ref = te.MXFP8BlockScaling()
    assert (recipe.margin, recipe.fp8_dpa, recipe.fp8_mha) == \
        (ref.margin, ref.fp8_dpa, ref.fp8_mha)
    assert recipe.fp8_format.name == ref.fp8_format.name == "E4M3"
    assert recipe.mxfp8() and not Recipe.mxfp8(object.__new__(Recipe))
    qset = QuantizerFactory.create_set(recipe)
    for role in ("x", "kernel", "dgrad"):
        q = getattr(qset, role)
        assert isinstance(q, BlockScaleQuantizer)
        assert q.q_dtype == torch.float8_e4m3fn
        assert q.q_layout is QuantizeLayout.ROWWISE_COLWISE
        assert q.update(torch.tensor(1.0)) is q


def test_qmath_matches_the_reference_rule():
    """qmath.mxfp8_quantize against the reference's, on a tensor whose
    block exponents span -12..12 and include zero blocks."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((64, 160)) * 2.0 ** rng.integers(-3, 14, (64, 1))
    x[5, 32:64] = 0.0
    xj, xt = _pair(x, "f32")
    for q in ("e4m3", "e5m2"):
        d, s = qmath.mxfp8_quantize(xt, _TQ[q])
        dj, sj = jqmath.mxfp8_quantize(xj, _JQ[q])
        _assert_bytes(d, dj, q)
        _assert_bytes(s, sj, q)
