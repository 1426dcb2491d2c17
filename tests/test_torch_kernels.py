"""The plain versions of the port's three kernels against the JAX package's
Pallas kernels (run in interpret mode on the CPU) and, for decode
attention, also against the reference's default einsum form.

On CPU tensors each wrapper runs its plain version, which is what these
tests reach; the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.attention import (
    AttnMaskType as JMask, SequenceDescriptor as JDesc)
from transformerengine_tpu.ops.decode_attention import (
    decode_attention as j_decode_attention)
from transformerengine_tpu.ops.decode_matmul import (
    decode_tn_matvec as j_decode_tn_matvec)
from transformerengine_tpu.ops.flash_attention import (
    LOG2E as J_LOG2E, _flash_fwd as j_flash_fwd,
    flash_attention as j_flash_attention)
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor)
from transformerengine_tpu_torch.ops.decode_attention import decode_attention
from transformerengine_tpu_torch.ops.decode_matmul import decode_tn_matvec
from transformerengine_tpu_torch.ops.flash_attention import (
    LOG2E, NEG_INF, flash_attention, flash_fwd)

torch.set_num_threads(2)

_J = {"f32": jnp.float32, "bf16": jnp.bfloat16, "fp8": j_e4m3}
_T = {"f32": torch.float32, "bf16": torch.bfloat16,
      "fp8": torch.float8_e4m3fn}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (fp8 values move as their raw bytes)."""
    xj = jnp.asarray(x).astype(_J[dtype])
    if dtype == "fp8":
        raw = np.asarray(xj).view(np.uint8).copy()
        return xj, torch.from_numpy(raw).view(torch.float8_e4m3fn)
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_T[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("w_dtype", ["fp8", "bf16"])
def test_decode_tn_matvec_matches_pallas(w_dtype):
    rng = np.random.default_rng(0)
    m, k, n = 8, 1024, 2048
    xj, xt = _pair(rng.standard_normal((m, k)), "bf16")
    w = rng.standard_normal((n, k)).astype(np.float32)
    if w_dtype == "fp8":
        s_inv = np.array([np.abs(w).max() / 448.0], np.float32)
        wj, wt = _pair(w / s_inv, "fp8")
        sj, st = jnp.asarray(s_inv), torch.from_numpy(s_inv)
    else:
        wj, wt = _pair(w, "bf16")
        sj = st = None
    oj = j_decode_tn_matvec(xj, wj, sj, block_n=512)
    ot = decode_tn_matvec(xt, wt, st)
    assert ot.dtype == torch.float32 and ot.shape == (m, n)
    # bf16 x fp8/bf16 products are exact in f32 on both sides; only the
    # order of the f32 sums over K = 1024 differs.
    ref = _np(oj)
    np.testing.assert_allclose(_np(ot), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _flash_case(dtype: str, sq: int, skv: int, seed: int):
    rng = np.random.default_rng(seed)
    b, hq, hkv, d = 2, 4, 2, 32
    q = _pair(rng.standard_normal((b, sq, hq, d)), dtype)
    k = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    v = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    return q, k, v


# f32: both sides compute in f32 and differ only in summation order.
# bf16: O is rounded to bf16 (ulp 2^-8 at |O| ~ 1), and the softmax
# weights are rounded to bf16 against running maxima that differ between
# the blocked kernel and the one-shot plain version.
_FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mask", ["no_mask", "causal", "padding_causal",
                                  "causal_bottom_right"])
def test_flash_attention_matches_pallas(mask, dtype):
    sq, skv = (24, 48) if mask == "causal_bottom_right" else (48, 48)
    (qj, qt), (kj, kt), (vj, vt) = _flash_case(dtype, sq, skv, seed=1)
    lens = np.array([48, 29], np.int32)
    desc_j = desc_t = None
    if mask == "padding_causal":
        desc_j = JDesc.from_seqlens(jnp.asarray(lens))
        desc_t = SequenceDescriptor.from_seqlens(torch.from_numpy(lens))
    # Small blocks so that the Pallas kernel runs its online softmax over
    # several key blocks.
    oj = j_flash_attention(qj, kj, vj, desc_j, attn_mask_type=JMask(mask),
                           block_q=16, block_k=16)
    ot = flash_attention(qt, kt, vt, desc_t, attn_mask_type=AttnMaskType(mask))
    assert ot.dtype == _T[dtype] and ot.shape == qt.shape
    tol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    if mask == "padding_causal":
        # Query rows past a sequence's length see no key: O is exactly 0.
        assert float(ot[1, 29:].abs().max()) == 0.0
        assert float(np.abs(_np(oj)[1, 29:]).max()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_lse_and_masked_rows_match_pallas(dtype):
    """LSE of every row, including padded rows, which write O = 0 and
    LSE = -1e30 rather than NaN; and scale * log2(e) folded into q in q's
    dtype before the kernel."""
    b, s, d = 2, 48, 32
    (qj, qt), (kj, kt), (vj, vt) = _flash_case(dtype, s, s, seed=2)
    lens = np.array([48, 29], np.int32)
    seg = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    scale = d ** -0.5
    oj, lj = j_flash_fwd(
        qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
        vj.transpose(0, 2, 1, 3), jnp.asarray(seg), jnp.asarray(seg),
        jnp.zeros((1,), jnp.int32), scale=scale, causal=True,
        window=(-1, -1), offset=0, block_q=16, block_k=16)
    lt_lens = torch.from_numpy(lens)
    ot, lt = flash_fwd(qt, kt, vt, lt_lens, lt_lens, scale=scale, causal=True)
    assert lt.shape == (b, 4, s) and lt.dtype == torch.float32
    lj = _np(lj)
    assert np.all(lj[1, :, 29:] == NEG_INF)
    assert torch.all(lt[1, :, 29:] == NEG_INF)
    live = np.s_[:, :, :29]
    # LSE is f32 on both sides; bf16 inputs change only which q values
    # enter, and both sides fold the scale into q identically.
    np.testing.assert_allclose(lt.numpy()[live], lj[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(ot), _np(oj.transpose(0, 2, 1, 3)),
                               rtol=_FLASH_TOL[dtype], atol=_FLASH_TOL[dtype])
    assert LOG2E == J_LOG2E


def _decode_case(cache_dtype: str, per_slot: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    b, s_max, hq, hkv, d = 3, 128, 4, 2, 32
    q = _pair(rng.standard_normal((b, 1, hq, d)), "bf16")
    k = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32) * 2
    dq = (np.array([0.03, 0.05, 0.025], np.float32) if per_slot
          else np.array([0.04], np.float32))
    if cache_dtype == "fp8":
        # Saturated like the cache's own quantize.
        kc = _pair(np.clip(k / dq.reshape(-1, 1, 1, 1), -448, 448), "fp8")
        vc = _pair(np.clip(v / dq.reshape(-1, 1, 1, 1), -448, 448), "fp8")
    else:
        kc, vc = _pair(k, "bf16"), _pair(v, "bf16")
    lengths = np.array([100, 1, 77], np.int32)
    return q, kc, vc, lengths, dq


# Tolerances, relative to the largest output:
# - the einsum form ("xla") takes the same steps as the plain version
#   (bf16 operands, f32 scores, softmax weights rounded to bf16); only
#   summation order and the bf16 output's last bit differ;
# - the Pallas form dequantizes K and V to f32 and keeps the softmax
#   weights in f32, so the plain version's bf16 rounding of q and of the
#   weights (relative 2^-9 each) shows, averaged over the keys.
_DECODE_TOL = {"xla": 8e-3, "pallas": 2e-2}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cache_dtype", ["fp8", "bf16"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_both_forms(per_slot, cache_dtype, backend):
    (qj, qt), (kj, kt), (vj, vt), lengths, dq = _decode_case(cache_dtype,
                                                             per_slot)
    scale_j = jnp.asarray(dq) if cache_dtype == "fp8" else None
    scale_t = torch.from_numpy(dq) if cache_dtype == "fp8" else None
    oj = j_decode_attention(qj, kj, vj, jnp.asarray(lengths),
                            kv_scale=scale_j, backend=backend)
    ot = decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                          kv_scale=scale_t)
    assert ot.dtype == torch.bfloat16 and ot.shape == qt.shape
    ref = _np(oj)
    assert np.isfinite(ref).all() and torch.isfinite(ot.float()).all()
    np.testing.assert_allclose(_np(ot), ref, rtol=0,
                               atol=_DECODE_TOL[backend] * np.abs(ref).max())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_decode_attention_window_and_sink(backend):
    (qj, qt), (kj, kt), (vj, vt), lengths, dq = _decode_case("fp8", True)
    sink = np.linspace(-1.0, 2.0, 4).astype(np.float32)
    oj = j_decode_attention(qj, kj, vj, jnp.asarray(lengths),
                            kv_scale=jnp.asarray(dq), window_left=20,
                            softmax_sink=jnp.asarray(sink), backend=backend)
    ot = decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                          kv_scale=torch.from_numpy(dq), window_left=20,
                          softmax_sink=torch.from_numpy(sink))
    ref = _np(oj)
    assert np.isfinite(ref).all() and torch.isfinite(ot.float()).all()
    np.testing.assert_allclose(_np(ot), ref, rtol=0,
                               atol=_DECODE_TOL[backend] * np.abs(ref).max())
