"""The plain version of the port's grouped MXFP8 QDQ kernel
(``mxfp8_qdq_2x_grouped``) against the JAX package: the Pallas kernel in
interpret mode at aligned shapes, the reference's chain (quantize the
(E, M, K) view rowwise, dequantize, transpose) at shapes the kernel does
not take, and an exact numpy version of the rule where the block
exponents leave -12..12. Both orientations' bf16 bytes must be equal.

XLA's CPU ``exp2`` is exact for the integer exponents -12..12 only, and
the Pallas kernel multiplies by ``exp2(-e)`` and ``exp2(e)``; inputs held
against the JAX package keep every block's exponent inside that range
(``test_torch_mxfp8_kernels.py`` has the same rule).

On CPU tensors the wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernel to the same plain version on the card."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.common.recipe import E4M3, E5M2
from transformerengine_tpu.grouped_dense import _q1x as j_q1x
from transformerengine_tpu.ops.quantize_kernels import (
    mxfp8_qdq_2x_grouped as j_qdq)
from transformerengine_tpu.quantize.dtypes import (
    float8_e4m3 as j_e4m3, float8_e5m2 as j_e5m2)
from transformerengine_tpu.quantize.helper import QuantizerFactory as JFactory
from transformerengine_tpu_torch.ops.quantize_kernels import (
    mxfp8_qdq_2x_grouped, mxfp8_qdq_2x_grouped_plain)

torch.set_num_threads(2)

_JQ = {"e4m3": j_e4m3, "e5m2": j_e5m2}
_TQ = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
_NQ = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _assert_bytes(got, ref, what=""):
    assert tuple(got.shape) == tuple(ref.shape), what
    np.testing.assert_array_equal(_bytes(got), _bytes(ref), err_msg=what)


def _input(shape, seed):
    """bf16 expert kernels whose block exponents stay inside -12..12: the
    second half of each expert's columns 2^8 larger (a block that took a
    neighbour's scale would be far off), an all-zero 32 x 32 block, signed
    zeros, and values that saturate (a block amax of 480 at exponent 0
    puts 480 and 464 above e4m3's 448)."""
    rng = np.random.default_rng(seed)
    e, k, m = shape
    x = rng.standard_normal(shape) * 3.0
    x[:, :, m // 2:] *= 2.0 ** 8
    x[0, :32, :32] = 0.0
    x[1, :32, 5] = -0.0
    x[1, :32, 6] = rng.choice([-0.0, 0.0, 1.5], 32)
    x[-1, :32, 7] = 1.0
    x[-1, :3, 7] = (480.0, 464.0, -480.0)
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)


def _exponents(x: np.ndarray) -> np.ndarray:
    """The block exponents of an (E, K, M) input, blocks along K."""
    e, k, m = x.shape
    amax = np.abs(x.astype(np.float32)).reshape(e, k // 32, 32, m).max(2)
    ex = (np.maximum(amax, np.float32(2.0 ** -126)).view(np.int32) >> 23) \
        - 127 - 8
    return np.where(amax > 0, np.clip(ex, -127, 127), 0)


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 96, 256), (2, 512, 512)])
@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
def test_plain_matches_pallas(shape, q):
    xj, xt = _input(shape, sum(shape))
    ex = _exponents(xt.float().numpy())
    assert -12 <= ex.min() and ex.max() <= 12
    assert ex.max() > 0 > ex.min()
    ref = j_qdq(xj, _JQ[q])
    got = mxfp8_qdq_2x_grouped(xt, _TQ[q])
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    _assert_bytes(got[0], ref[0], "nn")
    _assert_bytes(got[1], ref[1], "tn")
    # The values the kernel sees are discriminating: some saturate, some
    # change, and signed zeros keep their sign in both orientations.
    nn = got[0].float().numpy()
    x = xt.float().numpy()
    assert not np.array_equal(nn, x)
    if q == "e4m3":
        assert nn[-1, 0, 7] == 448.0 and nn[-1, 2, 7] == -448.0
    assert np.signbit(nn[1, :32, 5]).all()
    assert np.array_equal(np.signbit(nn[1, :32, 6]),
                          np.signbit(x[1, :32, 6]))
    np.testing.assert_array_equal(
        _bytes(got[1]), _bytes(got[0].transpose(1, 2)))


def _j_chain(xj, q):
    """The reference's own fallback (``grouped_dense._gd_fwd``): the
    (E, M, K) view quantized rowwise by its MXFP8 quantizer, dequantized
    to bf16, and transposed back."""
    fmt = E5M2 if q == "e5m2" else E4M3
    quantizer = JFactory.create(te.MXFP8BlockScaling(fp8_format=fmt),
                                "kernel")
    assert quantizer.q_dtype == _JQ[q]
    qt, _ = j_q1x(quantizer, jnp.swapaxes(xj, 1, 2))
    tn = qt.dequantize().astype(jnp.bfloat16)
    return jnp.swapaxes(tn, 1, 2), tn


@pytest.mark.parametrize("shape", [(2, 48, 96), (3, 64, 160)])
@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
def test_unaligned_shapes_take_the_chain(shape, q):
    """K % 32 or M % 128 not 0: the reference's kernel and the port's
    wrapper return None, and the plain version (the chain) equals the
    reference's chain, a ragged last block along K included."""
    xj, xt = _input(shape, 7 + sum(shape))
    assert j_qdq(xj, _JQ[q]) is None
    assert mxfp8_qdq_2x_grouped(xt, _TQ[q]) is None
    ref = _j_chain(xj, q)
    got = mxfp8_qdq_2x_grouped_plain(xt, _TQ[q])
    _assert_bytes(got[0], ref[0], "nn")
    _assert_bytes(got[1], ref[1], "tn")


def _np_qdq(x: np.ndarray, q: str) -> np.ndarray:
    """The rule in exact numpy f32 arithmetic: nn of an (E, K, M) input."""
    e, k, m = x.shape
    ex = _exponents(x)
    big = np.repeat(ex, 32, axis=1)
    y = x.astype(np.float32) * np.ldexp(np.float32(1.0), -big).astype(
        np.float32)
    qmax = 448.0 if q == "e4m3" else 57344.0
    codes = np.clip(y, -qmax, qmax).astype(_NQ[q]).astype(np.float32)
    deq = codes * np.ldexp(np.float32(1.0), big).astype(np.float32)
    return deq.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
def test_exact_where_xla_is_not(q):
    """Block exponents far outside -12..12 (gradient-sized and large
    values, blocks below the E8M0 clip whose dequantized values are
    bf16 subnormals or round to zero) against the exact numpy rule."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    x[0, :32] *= 1e-6
    x[0, 32:64] *= 2.0 ** -125
    x[0, 64:96, :64] = rng.choice([0.0, 2.0 ** -130, -3 * 2.0 ** -133],
                                   (32, 64))
    x[1] *= 2.0 ** 40
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ex = _exponents(xt.float().numpy())
    assert ex.min() == -127 and ex.max() > 12
    got = mxfp8_qdq_2x_grouped(xt, _TQ[q])
    ref = _np_qdq(xt.float().numpy(), q)
    _assert_bytes(got[0], ref, "nn")
    _assert_bytes(got[1], np.ascontiguousarray(ref.transpose(0, 2, 1)), "tn")
    sub = got[0][0, 64:96, :64].float()
    assert float(sub.abs().max()) > 0


def test_f32_input_and_bad_arguments():
    xj, xt = _input((2, 64, 128), 3)
    got = mxfp8_qdq_2x_grouped(xt.float())
    ref = j_qdq(xj.astype(jnp.float32), j_e4m3)
    _assert_bytes(got[0], ref[0], "nn")
    _assert_bytes(got[1], ref[1], "tn")
    with pytest.raises(ValueError, match="expected a non-empty"):
        mxfp8_qdq_2x_grouped(xt[0])
    with pytest.raises(TypeError, match="q_dtype"):
        mxfp8_qdq_2x_grouped(xt, torch.bfloat16)
