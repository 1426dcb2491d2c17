"""The plain versions of the port's NVFP4 kernels against the JAX package:
nvfp4_amax_2x and nvfp4_quantize_2x against their Pallas kernels
(interpret mode on the CPU) and against ``qmath.nvfp4_quantize`` of each
orientation (the colwise one after the random Hadamard transform), with
and without the RHT; ``qmath.nvfp4_quantize`` in 2D blocks and with "four
over six"; ``NVFP4Quantizer.quantize`` through the API for the three
roles of ``NVFP4BlockScaling``, the JAX side with its fused kernels on
and off; payload, scale and tensor-scale bytes equal.

The RHT's f32 sums: the port sums each rotated value's 16 exact products
in one fixed order (``quantize/hadamard.py``), the order XLA's f32 dot
takes on the CPU, so the rotated values, and every code after them,
equal the reference's bit for bit here (no code differs).

On CPU tensors each wrapper runs its plain version, which is what these
tests reach; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.common.recipe import QParams as JQParams
from transformerengine_tpu.dense import all_tensor_scaling as j_all_tensor
from transformerengine_tpu.ops.quantize_kernels import (
    nvfp4_amax_2x as j_amax_2x, nvfp4_quantize_2x as j_quantize_2x,
    pick_tile)
from transformerengine_tpu.quantize import hadamard as jhadamard
from transformerengine_tpu.quantize import qmath as jqmath
from transformerengine_tpu.quantize.dtypes import FP4_GRID
from transformerengine_tpu.quantize.helper import QuantizerFactory as JFactory
from transformerengine_tpu.quantize.quantizer import (
    QuantizeLayout as JLayout)
from transformerengine_tpu.quantize.scaling_modes import (
    ScalingMode as JMode)
from transformerengine_tpu_torch import NVFP4BlockScaling, QParams, Recipe
from transformerengine_tpu_torch.dense import all_tensor_scaling
from transformerengine_tpu_torch.ops.quantize_kernels import (
    nvfp4_amax_2x, nvfp4_quantize_2x)
from transformerengine_tpu_torch.quantize import dtypes, hadamard, qmath
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    NVFP4Quantizer, QuantizeLayout)
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode
from transformerengine_tpu_torch.quantize.tensor import ScaledTensor2x

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
_MASK = 0xBEEF


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


def _input(shape, dtype, seed):
    """Normal values with: rows of three magnitudes (1e-3, 1, 1e3: the
    small rows' blocks fall to subnormal e4m3 scales, below 2^-6, under
    the tensor scale of the large ones), a 16 x 16 block of zeros, and
    blocks whose tiny negative values round to -0 (byte 0x80) beside a
    larger element."""
    rng = np.random.default_rng(seed)
    m, n = shape
    x = rng.standard_normal(shape) * 3.0
    x[: m // 4] *= 1e-3
    x[m // 2:] *= 1e3
    x[16:32, 16:32] = 0.0
    x[32:48:2, :] = -np.abs(x[32:48:2, :]) * 1e-4
    x[32:48:2, ::16] = 5.0
    return _pair(x, dtype)


_CASES = [((128, 256), "bf16", False), ((128, 256), "bf16", True),
          ((64, 128), "f32", True), ((256, 384), "f32", False),
          ((256, 384), "bf16", True)]


@pytest.mark.parametrize("shape,dtype,with_rht", _CASES)
def test_kernels_match_pallas_and_qmath(shape, dtype, with_rht):
    xj, xt = _input(shape, dtype, sum(shape) + with_rht)
    m, n = shape
    tile = (pick_tile(m, align=16), pick_tile(n, align=128))
    rht = jhadamard.rht_matrix_np(_MASK) if with_rht else None
    mask = _MASK if with_rht else None
    arow_j, acol_j = j_amax_2x(xj, rht, tile)
    arow, acol = nvfp4_amax_2x(xt, mask)
    assert float(arow) == float(arow_j) and float(acol) == float(acol_j)
    assert arow.dtype == acol.dtype == torch.float32
    ts_r, ts_c = qmath.nvfp4_tensor_scale(arow), qmath.nvfp4_tensor_scale(acol)
    denom = 6.0 * 448.0
    ts_rj = jnp.where(arow_j > 0, arow_j / denom, 1.0)
    ts_cj = jnp.where(acol_j > 0, acol_j / denom, 1.0)
    assert float(ts_r) == float(ts_rj) and float(ts_c) == float(ts_cj)
    got = nvfp4_quantize_2x(xt, ts_r, ts_c, mask)
    ref = j_quantize_2x(xj, ts_rj, ts_cj, rht, tile=tile)
    for name, a, r in zip(("row", "srow", "col", "scol"), got, ref):
        _assert_bytes(a, r, name)
    assert got[0].dtype == got[1].dtype == torch.float8_e4m3fn
    # Against qmath of each orientation, the colwise after the RHT.
    xtj = jhadamard.apply_rht(xj.T, _MASK) if with_rht else xj.T
    for (data, scale), v in (((got[0], got[1]), xj), ((got[2], got[3]), xtj)):
        rd, rs, rts, ra = jqmath.nvfp4_quantize(v)
        _assert_bytes(data, rd)
        _assert_bytes(scale, rs)
    # The input is discriminating: subnormal e4m3 scales, -0 codes, and
    # rows and columns of other magnitudes.
    assert (_bytes(got[1]) < 8).any() and (_bytes(got[1]) > 0).any()
    assert (_bytes(got[0]) == 0x80).any()


def test_rht_matches_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    for mask in (0, _MASK, 0x1234):
        np.testing.assert_array_equal(hadamard.rht_matrix_np(mask),
                                      jhadamard.rht_matrix_np(mask))
        np.testing.assert_array_equal(hadamard.rht_matrix(mask).numpy(),
                                      jhadamard.rht_matrix_np(mask))
        x = (rng.standard_normal((96, 256)) * rng.uniform(0.1, 100)
             ).astype(np.float32)
        ref = np.asarray(jhadamard.apply_rht(jnp.asarray(x), mask))
        got = hadamard.apply_rht(torch.from_numpy(x), mask)
        np.testing.assert_array_equal(got.numpy(), ref)
        inv = np.asarray(jhadamard.apply_rht_inverse(jnp.asarray(x), mask))
        np.testing.assert_array_equal(
            hadamard.apply_rht_inverse(torch.from_numpy(x), mask).numpy(), inv)
        # The normalized RHT is orthogonal: the inverse undoes it (f32).
        back = hadamard.apply_rht_inverse(got, mask).numpy()
        np.testing.assert_allclose(back, x, rtol=0,
                                   atol=1e-6 * np.abs(x).max())
    with pytest.raises(ValueError, match="multiple of 16"):
        hadamard.apply_rht(torch.zeros(4, 24))


@pytest.mark.parametrize("block_shape", [(1, 16), (16, 16)])
@pytest.mark.parametrize("four_over_six", [False, True])
@pytest.mark.parametrize("shape", [(64, 256), (48, 40)])
def test_qmath_matches_the_reference(block_shape, four_over_six, shape):
    """qmath.nvfp4_quantize in 1D and 2D blocks, with and without "four
    over six", on aligned and ragged shapes: payload, block-scale and
    tensor-scale bytes and the amax equal."""
    xj, xt = _input(shape, "f32", 7 + shape[1])
    d, s, ts, amax = qmath.nvfp4_quantize(
        xt, block_shape=block_shape, four_over_six=four_over_six)
    dj, sj, tsj, aj = jqmath.nvfp4_quantize(
        xj, block_shape=block_shape, four_over_six=four_over_six)
    _assert_bytes(d, dj, "data")
    _assert_bytes(s, sj, "scales")
    _assert_bytes(ts, tsj, "tensor scale")
    assert float(amax) == float(aj)
    br, bc = block_shape
    assert s.shape == (-(-shape[0] // br), -(-shape[1] // bc))
    if four_over_six:
        plain = qmath.nvfp4_quantize(xt, block_shape=block_shape)
        assert not np.array_equal(_bytes(s), _bytes(plain[1]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("role", ["x", "kernel", "dgrad"])
def test_quantizer_api_matches_jax(role, fused, monkeypatch):
    """The port's NVFP4Quantizer of each role of NVFP4BlockScaling() in
    all three layouts against the reference's quantizer with its Pallas
    kernels on (interpret mode) and off (qmath): payloads, block scales,
    tensor scales and amaxes equal, and the dequantized values."""
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", "1" if fused else "0")
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng.standard_normal((2, 64, 256)) * 2.0, "bf16")
    jq = JFactory.create(te.NVFP4BlockScaling(), role)
    tq = QuantizerFactory.create(NVFP4BlockScaling(), role)
    assert isinstance(tq, NVFP4Quantizer)
    assert (tq.with_rht, tq.stochastic_rounding, tq.four_over_six) == \
        (jq.with_rht, jq.stochastic_rounding, jq.four_over_six)
    assert tq.scaling_mode.name == jq.scaling_mode.name
    both_j, both_t = jq.quantize(xj), tq.quantize(xt)
    assert isinstance(both_t, ScaledTensor2x)
    pairs = [(both_t.rowwise, both_j.rowwise),
             (both_t.colwise, both_j.colwise)]
    for lj, lt in ((JLayout.ROWWISE, QuantizeLayout.ROWWISE),
                   (JLayout.COLWISE, QuantizeLayout.COLWISE)):
        pairs.append((tq.quantize(xt, layout=lt), jq.quantize(xj, layout=lj)))
    for t, j in pairs:
        assert t.layout == j.layout
        _assert_bytes(t.data, j.data, t.layout)
        _assert_bytes(t.scale_inv, j.scale_inv, t.layout)
        _assert_bytes(t.tensor_scale_inv, j.tensor_scale_inv, t.layout)
        assert float(t.amax) == float(j.amax)
        assert t.data.shape == ((256, 2, 64) if t.layout == "T"
                                else (2, 64, 256))
        np.testing.assert_array_equal(
            t.dequantize().float().numpy(),
            np.asarray(j.dequantize(), np.float32))


def test_zero_tensor_and_signed_zeros():
    """An all-zero tensor: amax 0, tensor scale 1, zero scales (inv 0) and
    zero codes in both orientations; -0 inputs and negative values that
    round to 0 give byte 0x80 on both sides."""
    zeros = torch.zeros((32, 64), dtype=torch.bfloat16)
    arow, acol = nvfp4_amax_2x(zeros, _MASK)
    assert float(arow) == float(acol) == 0.0
    ts = qmath.nvfp4_tensor_scale(arow)
    assert float(ts) == 1.0
    for part in nvfp4_quantize_2x(zeros, ts, ts, _MASK):
        assert not _bytes(part).any()
    x = np.zeros((16, 32), np.float32)
    x[:, :16] = -0.0
    x[:, 16] = 6.0
    x[:, 17:] = -1e-3
    xj, xt = _pair(x, "f32")
    row, srow, _, _ = nvfp4_quantize_2x(xt, qmath.nvfp4_tensor_scale(
        torch.tensor(6.0)), torch.tensor(1.0))
    assert (_bytes(row)[:, :16] == 0x80).all()
    assert (_bytes(row)[:, 17:] == 0x80).all()
    _assert_bytes(row, jqmath.nvfp4_quantize(xj)[0])


def test_shapes_the_kernels_do_not_take_fall_back_to_two_passes(monkeypatch):
    """(24, 40): no multiple of 16, so both packages quantize the two
    orientations with qmath (the kernel wrappers refuse the shape). (48,
    80): the port's kernel takes it where the reference's fused path does
    not (pick_tile(80, align=128)); the bytes are the same."""
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", "1")
    for shape, role in (((24, 40), "kernel"), ((48, 80), "x")):
        xj, xt = _input((max(shape[0], 48), shape[1]), "bf16", shape[0])
        xj, xt = xj[:shape[0]], xt[:shape[0]]
        tq = QuantizerFactory.create(NVFP4BlockScaling(), role)
        jq = JFactory.create(te.NVFP4BlockScaling(), role)
        assert (tq._fused_2x(xt) is None) == (shape[0] % 16 != 0)
        both_t, both_j = tq.quantize(xt), jq.quantize(xj)
        for usage in ("rowwise", "colwise"):
            t, j = getattr(both_t, usage), getattr(both_j, usage)
            _assert_bytes(t.data, j.data, f"{shape} {usage}")
            _assert_bytes(t.scale_inv, j.scale_inv, f"{shape} {usage}")
    with pytest.raises(ValueError, match="multiples of 16"):
        nvfp4_amax_2x(torch.zeros(24, 40))


def test_stochastic_rounding_neighbours_repeatability_and_bias():
    """Stochastic rounding (the gradient role with a generator): every
    code is one of the two grid neighbours of the scaled value; one seed
    gives the same bytes, fused or in two passes; over 256 seeds the mean
    of the codes lies within 6 standard deviations (gap / 2 / sqrt(256))
    of the scaled value for every element, and the mean over all of them
    within 5 / sqrt(count * 256) grid units of it (no draw deviates by
    more than 1: no gap exceeds 2)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.standard_normal((32, 64)) * 2.0
                          ).astype(np.float32))
    q = QuantizerFactory.create(NVFP4BlockScaling(), "dgrad")
    assert q.stochastic_rounding and q.with_rht
    near = q.quantize(x)
    g = torch.Generator().manual_seed(5)
    a = q.quantize(x, generator=g)
    b = q.quantize(x, generator=torch.Generator().manual_seed(5))
    assert not np.array_equal(_bytes(a.rowwise.data), _bytes(near.rowwise.data))
    for usage in ("rowwise", "colwise"):
        _assert_bytes(getattr(a, usage).data, getattr(b, usage).data)
        _assert_bytes(getattr(a, usage).scale_inv,
                      getattr(near, usage).scale_inv)
    seed = q._seed(torch.Generator().manual_seed(5))
    unfused = [q._quantize_2d(v, c, seed) for v, c in ((x, False),
                                                        (x.t(), True))]
    fused = q._fused_2x(x, seed)
    for (fd, fs, fts, fa), (ud, us, uts, ua) in zip(fused, unfused):
        _assert_bytes(fd, ud)
        _assert_bytes(fs, us)
        assert float(fts) == float(uts) and float(fa) == float(ua)

    # The scaled values y = x * inv of the rowwise usage.
    ts = qmath.nvfp4_tensor_scale(x.abs().amax())
    s_eff = near.rowwise.scale_inv.float() * ts
    y = x * torch.where(s_eff > 0, 1.0 / s_eff, 0.0).repeat_interleave(16, 1)
    y = torch.copysign(y.abs().clamp(max=6.0), y)
    grid = torch.tensor((0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0))
    lo_idx = (y.abs()[..., None] >= grid).sum(-1).clamp(1, 8) - 1
    lo = grid[lo_idx]
    up = grid[(lo_idx + 1).clamp(max=7)]
    runs = torch.stack([
        qmath.nvfp4_encode(x, ts, ubits=qmath.sr_bits(s, 0, x.shape))[0]
        .float() for s in range(256)])
    mag = runs.abs()
    assert bool(((mag == lo) | (mag == up)).all())
    assert bool((torch.sign(runs) * torch.sign(y) >= 0).all())
    mean = runs.mean(0)
    gap = (up - lo).clamp_min(1e-30)
    assert bool(((mean - y).abs() <= 6 * gap / 2 / 16 + 1e-6).all())
    assert float((mean - y).mean().abs()) <= 5 / np.sqrt(y.numel() * 256)


def test_scaling_modes_recipe_and_the_tensor_scaling_repair():
    """Every NVFP4 mode is block scaling (the port's is_tensor_scaling was
    "not MXFP8" before NVFP4, which would have sent NVFP4 down the
    one-orientation branch); a set of NVFP4 quantizers is not all tensor
    scaling; block and scale shapes and the e4m3 decode match the
    reference; the recipe's defaults and the factory's roles too."""
    for name in ("NVFP4_1D_SCALING", "NVFP4_2D_SCALING"):
        mode, jmode = ScalingMode[name], JMode[name]
        assert mode.is_nvfp4 and not mode.is_tensor_scaling
        assert mode.block_shape == jmode.block_shape
        for shape in ((4, 33), (3, 5, 64), (40, 48)):
            assert mode.scale_shape(shape) == jmode.scale_shape(shape)
    for mode in ScalingMode:
        assert mode.is_tensor_scaling == JMode[mode.name].is_tensor_scaling
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn)
    dec = ScalingMode.NVFP4_1D_SCALING.decode_scale_inv(codes)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(JMode.NVFP4_1D_SCALING.decode_scale_inv(
            jnp.asarray(codes.view(torch.uint8).numpy()).view(
                jnp.float8_e4m3fn)), np.float32))
    recipe, ref = NVFP4BlockScaling(), te.NVFP4BlockScaling()
    assert recipe.nvfp4() and not recipe.mxfp8()
    assert not Recipe.nvfp4(object.__new__(Recipe))
    knobs = ("random_hadamard_transform", "stochastic_rounding",
             "fp4_2d_quantization")
    for f in ("fp4_quant_fwd_inp", "fp4_quant_fwd_weight",
              "fp4_quant_bwd_grad"):
        assert getattr(recipe, f) == QParams(
            **{k: getattr(getattr(ref, f), k) for k in knobs})
    assert recipe.fp4_format.name == ref.fp4_format.name == "E2M1"
    assert recipe.nvfp4_4over6 == ref.nvfp4_4over6 == "none"
    qset = QuantizerFactory.create_set(recipe)
    jset = JFactory.create_set(ref)
    assert not all_tensor_scaling(qset) and not j_all_tensor(jset)
    for fos in ("none", "weights", "activations", "all"):
        for role in ("x", "kernel", "dgrad"):
            two_d = QParams(fp4_2d_quantization=True)
            t = QuantizerFactory.create(NVFP4BlockScaling(
                nvfp4_4over6=fos, fp4_quant_fwd_weight=two_d), role)
            j = JFactory.create(te.NVFP4BlockScaling(
                nvfp4_4over6=fos,
                fp4_quant_fwd_weight=JQParams(fp4_2d_quantization=True)),
                role)
            assert (t.scaling_mode.name, t.with_rht, t.stochastic_rounding,
                    t.four_over_six) == (j.scaling_mode.name, j.with_rht,
                                         j.stochastic_rounding,
                                         j.four_over_six)
            assert t.update(torch.tensor(1.0)) is t
    # The rounding tables, built on the device, are the reference's.
    assert tuple(qmath._fp4_bounds("cpu").tolist()) == tuple(
        jqmath._FP4_BOUNDS.tolist())
    assert tuple(qmath._fp4_grid("cpu").tolist()) == FP4_GRID == \
        dtypes.FP4_GRID
    assert qmath._FP4_TIE_UP == tuple(jqmath._FP4_TIE_UP.tolist())
    with pytest.raises(ValueError, match="nvfp4_4over6"):
        NVFP4BlockScaling(nvfp4_4over6="some")
    with pytest.raises(ValueError, match="NVFP4 scaling mode"):
        NVFP4Quantizer(torch.float4_e2m1fn_x2,
                       scaling_mode=ScalingMode.MXFP8_1D_SCALING)
