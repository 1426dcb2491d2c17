"""The plain versions of the training slice's kernels against the JAX
package: the flash-attention backward against ``jax.vjp`` of the Pallas
flash attention (interpret mode on the CPU), cast_transpose and
norm_cast_transpose against their Pallas kernels, both through the
wrappers and through the quantizer API, and the delayed-scaling state
update against the reference's ``update``.

On CPU tensors each wrapper runs its plain version, which is what these
tests reach; the CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.attention import (
    AttnBackend as JBackend, AttnMaskType as JMask,
    SequenceDescriptor as JDesc, fused_attn as j_fused_attn)
from transformerengine_tpu.ops.flash_attention import (
    flash_attention as j_flash_attention)
from transformerengine_tpu.ops.quantize_kernels import (
    cast_transpose as j_cast_transpose,
    norm_cast_transpose as j_norm_cast_transpose)
from transformerengine_tpu.quantize.dtypes import (
    float8_e4m3 as j_e4m3, float8_e5m2 as j_e5m2)
from transformerengine_tpu.quantize.helper import (
    QuantizerFactory as JFactory)
from transformerengine_tpu.quantize.quantizer import (
    DelayedScaleQuantizer as JDelayed, QuantizerSet as JSet)
from transformerengine_tpu_torch import DelayedScaling
from transformerengine_tpu_torch.attention import (
    AttnBackend, AttnMaskType, SequenceDescriptor, fused_attn,
    get_attention_backend)
from transformerengine_tpu_torch.ops.flash_attention import flash_attention
from transformerengine_tpu_torch.ops.quantize_kernels import (
    cast_transpose, norm_cast_transpose)
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    DelayedScaleQuantizer, NoopQuantizer, QuantizeLayout, QuantizerSet)
from transformerengine_tpu_torch.quantize.tensor import (
    ScaledTensor2x, get_colwise, get_rowwise)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
_JQ = {"e4m3": j_e4m3, "e5m2": j_e5m2}
_TQ = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# Flash-attention backward
# ---------------------------------------------------------------------------

# (dtype, mask, GQA group): every mask in both dtypes, groups 1 and 4.
_BWD_CASES = [("f32", "no_mask", 4), ("f32", "causal", 1),
              ("f32", "padding_causal", 4), ("f32", "causal_bottom_right", 4),
              ("bf16", "no_mask", 1), ("bf16", "causal", 4),
              ("bf16", "padding_causal", 1),
              ("bf16", "causal_bottom_right", 1)]
# Relative to each gradient's largest |ref|. f32: both sides compute in
# f32 and differ in summation order (readings below 1e-6). bf16: ds and p
# are rounded to bf16 before their products on both sides, but from f32
# scores summed in other orders, so a few of them round one ulp (2^-8)
# apart, and the gradients themselves are rounded to bf16 (readings below
# 5.4e-3).
_BWD_RTOL = {"f32": 1e-5, "bf16": 2 ** -6}


@pytest.mark.parametrize("dtype,mask,group", _BWD_CASES)
def test_flash_bwd_matches_pallas_vjp(dtype, mask, group):
    """dQ, dK and dV of the port's flash attention (its plain backward on
    the CPU) against jax.vjp of the Pallas kernel, with S = 40, not a
    multiple of the 16-row blocks."""
    rng = np.random.default_rng(_BWD_CASES.index((dtype, mask, group)))
    b, hkv, d = 2, 2, 32
    hq = hkv * group
    sq, skv = (24, 40) if mask == "causal_bottom_right" else (40, 40)
    qj, qt = _pair(rng.standard_normal((b, sq, hq, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    doj, dot = _pair(rng.standard_normal((b, sq, hq, d)), dtype)
    lens = np.array([40, 23], np.int32)
    desc_j = desc_t = None
    if mask == "padding_causal":
        desc_j = JDesc.from_seqlens(jnp.asarray(lens))
        desc_t = SequenceDescriptor.from_seqlens(torch.from_numpy(lens))

    def fj(q, k, v):
        return j_flash_attention(q, k, v, desc_j, attn_mask_type=JMask(mask),
                                 block_q=16, block_k=16)

    oj, vjp = jax.vjp(fj, qj, kj, vj)
    grads_j = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    ot = flash_attention(qt, kt, vt, desc_t,
                         attn_mask_type=AttnMaskType(mask))
    ot.backward(dot)
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        assert got.dtype == _TD[dtype] and got.shape == ref.shape, name
        ref = _np(ref)
        np.testing.assert_allclose(
            _np(got), ref, rtol=0, atol=_BWD_RTOL[dtype] * np.abs(ref).max(),
            err_msg=f"d{name}")
    if mask == "padding_causal":
        # Padded query rows and padded keys get exact zeros.
        assert float(qt.grad[1, 23:].abs().max()) == 0.0
        assert float(kt.grad[1, 23:].abs().max()) == 0.0
        assert float(vt.grad[1, 23:].abs().max()) == 0.0
    if mask == "causal_bottom_right":
        # Every query sees keys: no row is fully masked, all get gradients.
        assert float(qt.grad.abs().amax(dim=(0, 2, 3)).min()) > 0


@pytest.mark.parametrize("backend", ["flash", "unfused"])
@pytest.mark.parametrize("mask", ["causal", "padding_causal"])
def test_fused_attn_backends_match_jax_unfused(mask, backend):
    """fused_attn forward and backward on both of the port's backends
    against the reference's unfused backend (plain XLA, differentiated by
    JAX), in bf16 with GQA."""
    rng = np.random.default_rng(30 + len(mask) + len(backend))
    b, s, hq, hkv, d = 2, 32, 4, 2, 32
    qj, qt = _pair(rng.standard_normal((b, s, hq, d)), "bf16")
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)), "bf16")
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)), "bf16")
    doj, dot = _pair(rng.standard_normal((b, s, hq, d)), "bf16")
    lens = np.array([32, 19], np.int32)
    desc_j = desc_t = None
    if mask == "padding_causal":
        desc_j = JDesc.from_seqlens(jnp.asarray(lens))
        desc_t = SequenceDescriptor.from_seqlens(torch.from_numpy(lens))
    oj, vjp = jax.vjp(lambda q, k, v: j_fused_attn(
        (q, k, v), sequence_descriptor=desc_j, attn_mask_type=JMask(mask),
        backend=JBackend.UNFUSED), qj, kj, vj)
    grads_j = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    ot = fused_attn((qt, kt, vt), desc_t, attn_mask_type=AttnMaskType(mask),
                    backend=AttnBackend(backend))
    ot.backward(dot)
    # bf16 O and gradients: one-ulp roundings (2^-8), and the flash path
    # rounds its softmax weights to bf16 where the unfused one keeps f32
    # (readings below 6.2e-3 of the largest value on the flash backend,
    # below 5e-4 on the unfused one).
    for name, got, ref in zip(("O", "dq", "dk", "dv"),
                              (ot, qt.grad, kt.grad, vt.grad),
                              (oj,) + tuple(grads_j)):
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=2 ** -6 * np.abs(ref).max(),
                                   err_msg=name)
    if mask == "padding_causal":
        assert float(ot.detach()[1, 19:].abs().max()) == 0.0
        assert float(qt.grad[1, 19:].abs().max()) == 0.0


def test_get_attention_backend(monkeypatch):
    monkeypatch.delenv("TE_TPU_ATTN_BACKEND", raising=False)
    assert get_attention_backend(head_dim=128) is AttnBackend.FLASH
    assert get_attention_backend(head_dim=40) is AttnBackend.UNFUSED
    assert get_attention_backend(head_dim=512) is AttnBackend.UNFUSED
    assert get_attention_backend(has_explicit_mask=True) is \
        AttnBackend.UNFUSED
    # The reference's override, both ways.
    monkeypatch.setenv("TE_TPU_ATTN_BACKEND", "unfused")
    assert get_attention_backend(head_dim=128) is AttnBackend.UNFUSED
    monkeypatch.setenv("TE_TPU_ATTN_BACKEND", "FLASH")
    assert get_attention_backend(has_explicit_mask=True) is AttnBackend.FLASH


# ---------------------------------------------------------------------------
# cast_transpose and norm_cast_transpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,x_dtype,q", [((64, 256), "bf16", "e4m3"),
                                             ((128, 128), "f32", "e5m2"),
                                             ((256, 384), "bf16", "e5m2")])
def test_cast_transpose_matches_pallas(shape, x_dtype, q):
    rng = np.random.default_rng(sum(shape))
    xj, xt = _pair(rng.standard_normal(shape) * 40, x_dtype)
    # A scale that saturates the largest values, so the clip shows.
    scale = np.array([7.25 if q == "e4m3" else 1500.0], np.float32)
    rj, cj, aj = j_cast_transpose(xj, jnp.asarray(scale), _JQ[q],
                                  tile=(64, 128))
    rt, ct, at = cast_transpose(xt, torch.from_numpy(scale), _TQ[q])
    assert rt.dtype == ct.dtype == _TQ[q]
    assert rt.shape == shape and ct.shape == shape[::-1]
    np.testing.assert_array_equal(_bytes(rt), _bytes(rj))
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    assert float(at[0]) == float(aj[0])


@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
def test_quantizer_2x_layout_matches_pallas(q):
    """The quantizer API's both-orientation quantize (its fused path under
    a delayed scale) against the Pallas cast_transpose, bit for bit."""
    rng = np.random.default_rng(9)
    xj, xt = _pair(rng.standard_normal((96, 160)) * 3, "bf16")
    role = "x" if q == "e4m3" else "dgrad"
    quant = QuantizerFactory.create(DelayedScaling(amax_history_len=4), role)
    assert quant.q_layout is QuantizeLayout.ROWWISE_COLWISE
    assert quant.q_dtype == _TQ[q]
    quant.scale.fill_(5.5)
    out = quant.quantize(xt)
    assert isinstance(out, ScaledTensor2x)
    rj, cj, aj = j_cast_transpose(xj, jnp.asarray([5.5], jnp.float32),
                                  _JQ[q], tile=(32, 32))
    np.testing.assert_array_equal(_bytes(get_rowwise(out).data), _bytes(rj))
    np.testing.assert_array_equal(_bytes(get_colwise(out).data), _bytes(cj))
    assert float(get_rowwise(out).amax) == float(aj[0])
    assert float(get_colwise(out).scale_inv[0]) == np.float32(1 / 5.5)


# (dtype, norm, zero-centered gamma, beta, fp8 dtype)
_NORM_CASES = [("bf16", "rmsnorm", False, False, "e4m3"),
               ("bf16", "layernorm", True, True, "e5m2"),
               ("f32", "layernorm", False, True, "e4m3"),
               ("bf16", "rmsnorm", True, False, "e5m2")]


@pytest.mark.parametrize("dtype,norm,zcg,with_beta,q", _NORM_CASES)
def test_norm_cast_transpose_matches_pallas(dtype, norm, zcg, with_beta, q):
    rng = np.random.default_rng(12)
    m, h = 256, 256
    xj, xt = _pair(rng.standard_normal((m, h)) * 2 + 0.5, dtype)
    gamma = (rng.standard_normal(h) * 0.2 + (0 if zcg else 1)).astype(
        np.float32)
    beta = (rng.standard_normal(h) * 0.1).astype(np.float32) \
        if with_beta else None
    scale = np.array([60.0 if q == "e4m3" else 9000.0], np.float32)
    outs_j = j_norm_cast_transpose(
        xj, jnp.asarray(gamma), None if beta is None else jnp.asarray(beta),
        jnp.asarray(scale), _JQ[q], norm=norm, zero_centered_gamma=zcg,
        epsilon=1e-5)
    outs_t = norm_cast_transpose(
        xt, torch.from_numpy(gamma),
        None if beta is None else torch.from_numpy(beta),
        torch.from_numpy(scale), _TQ[q], norm=norm, zero_centered_gamma=zcg,
        epsilon=1e-5)
    assert len(outs_t) == len(outs_j) == (5 if norm == "layernorm" else 4)
    # Both sides take the same f32 steps; the row sums of the statistics
    # run in other orders, which may move rsigma (and mu) by an f32 ulp,
    # as the JAX package's own kernel test allows against its chain (rtol
    # 2e-7). An f32 input's LayerNorm sums values with all 24 bits set,
    # and there rsigma moved by two ulps (2.3e-7) in the readings.
    rs_rtol = 4e-7 if dtype == "f32" else 2e-7
    np.testing.assert_allclose(_np(outs_t[3]), _np(outs_j[3]), rtol=rs_rtol)
    if norm == "layernorm":
        np.testing.assert_allclose(_np(outs_t[4]), _np(outs_j[4]),
                                   rtol=rs_rtol, atol=1e-7)
    # Payloads: equal (the readings have no byte apart); an rsigma one ulp
    # apart could move a value across a rounding boundary of the input
    # dtype, which would show as one fp8 step.
    for got, ref in ((outs_t[0], outs_j[0]), (outs_t[1], outs_j[1])):
        np.testing.assert_array_equal(_bytes(got), _bytes(ref))
    # The amax of the normalized values: exact once they are rounded to
    # bf16; f32 values carry rsigma's ulps.
    np.testing.assert_allclose(_np(outs_t[2]), _np(outs_j[2]),
                               rtol=rs_rtol if dtype == "f32" else 0)


def test_quantize_normed_is_the_unfused_chain():
    """``DelayedScaleQuantizer.quantize_normed`` gives the bytes of the
    norm followed by the quantizer's 2x quantize, and None where the fused
    kernel's shape rule fails."""
    from transformerengine_tpu_torch.ops.normalization import rmsnorm_fwd
    rng = np.random.default_rng(13)
    _, xt = _pair(rng.standard_normal((256, 128)), "bf16")
    gamma = torch.from_numpy((rng.standard_normal(128) * 0.3 + 1).astype(
        np.float32))
    quant = QuantizerFactory.create(DelayedScaling(), "x")
    quant.scale.fill_(100.0)
    fused, mu, rsigma = quant.quantize_normed(
        xt, gamma, None, norm="rmsnorm", zero_centered_gamma=False,
        epsilon=1e-6)
    normed, rs_ref = rmsnorm_fwd(xt, gamma, epsilon=1e-6)
    chain = quant.quantize(normed)
    assert mu is None and torch.equal(rsigma, rs_ref)
    for get in (get_rowwise, get_colwise):
        assert torch.equal(get(fused).data.view(torch.uint8),
                           get(chain).data.view(torch.uint8))
        assert torch.equal(get(fused).scale_inv, get(chain).scale_inv)
    assert float(get_rowwise(fused).amax) == float(get_rowwise(chain).amax)
    row, _, _ = quant.quantize_normed(
        xt, gamma, None, norm="rmsnorm", zero_centered_gamma=False,
        epsilon=1e-6, layout=QuantizeLayout.ROWWISE)
    assert torch.equal(row.data.view(torch.uint8),
                       get_rowwise(chain).data.view(torch.uint8))
    assert quant.quantize_normed(xt[:128], gamma, None, norm="rmsnorm",
                                 zero_centered_gamma=False,
                                 epsilon=1e-6) is None


# ---------------------------------------------------------------------------
# The delayed-scaling state update
# ---------------------------------------------------------------------------

def _delayed_pair(q: str, algo: str, margin: float, rng):
    hist = np.zeros(16, np.float32)
    hist[1:9] = rng.uniform(0.01, 300.0, 8).astype(np.float32)
    scale = np.array([rng.uniform(0.1, 10.0)], np.float32)
    jq = dataclasses.replace(
        JFactory.create_set(te.DelayedScaling()).x, q_dtype=_JQ[q],
        scale=jnp.asarray(scale), amax_history=jnp.asarray(hist),
        margin=margin, amax_compute_algo=algo)
    assert isinstance(jq, JDelayed)
    tq = DelayedScaleQuantizer(_TQ[q], scale=torch.from_numpy(scale.copy()),
                               amax_history=torch.from_numpy(hist.copy()),
                               margin=margin, amax_compute_algo=algo)
    return jq, tq


def _assert_same_state(tq, jq):
    np.testing.assert_array_equal(tq.amax_history.numpy(),
                                  np.asarray(jq.amax_history))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("algo", ["max", "most_recent"])
@pytest.mark.parametrize("margin", [0.0, 1.5])
@pytest.mark.parametrize("q", ["e4m3", "e5m2"])
@pytest.mark.parametrize("amax", [0.0, 3.3, 1234.5])
def test_delayed_update_bit_exact(algo, margin, q, amax):
    """Slot 0 takes this step's amax, the history reduces by ``max`` or
    ``most_recent``, the scale takes the margin, and the history rolls;
    an amax of 0 under ``most_recent`` keeps the scale at 1."""
    rng = np.random.default_rng(int(amax * 10) + int(margin * 2))
    jq, tq = _delayed_pair(q, algo, margin, rng)
    jn = jq.update(jnp.float32(amax))
    tn = tq.update(torch.tensor(amax, dtype=torch.float32))
    _assert_same_state(tn, jn)
    assert (tn.margin, tn.amax_compute_algo) == (margin, algo)
    # update returns a new quantizer; the old one's tensors stay as they
    # were until write_back copies the new state into them.
    assert not torch.equal(tq.amax_history, tn.amax_history)
    tq.write_back(tn)
    _assert_same_state(tq, jn)


def test_quantizer_set_update_bit_exact():
    rng = np.random.default_rng(21)
    pairs = {role: _delayed_pair(q, "max", 0.0, rng)
             for role, q in (("x", "e4m3"), ("kernel", "e4m3"),
                             ("dgrad", "e5m2"))}
    jset = JSet(**{r: p[0] for r, p in pairs.items()})
    tset = QuantizerSet(**{r: p[1] for r, p in pairs.items()})
    amaxes = {"x": 2.5, "kernel": 0.125, "dgrad": 7e-4}
    jnew = jset.update(JSet(**{r: jnp.float32(a)
                               for r, a in amaxes.items()}))
    tnew = tset.update(QuantizerSet(**{r: torch.tensor(a)
                                       for r, a in amaxes.items()}))
    for role in amaxes:
        _assert_same_state(getattr(tnew, role), getattr(jnew, role))
    tset.write_back(tnew)
    for role in amaxes:
        _assert_same_state(getattr(tset, role), getattr(jnew, role))


def test_factory_state_follows_the_recipe():
    recipe = DelayedScaling(margin=1.0, amax_history_len=16,
                            amax_compute_algo="most_recent")
    qset = QuantizerFactory.create_set(recipe)
    assert qset.x.q_dtype == qset.kernel.q_dtype == torch.float8_e4m3fn
    assert qset.dgrad.q_dtype == torch.float8_e5m2
    for q in (qset.x, qset.kernel, qset.dgrad):
        assert q.amax_history.shape == (16,) and float(q.scale[0]) == 1.0
        assert (q.margin, q.amax_compute_algo) == (1.0, "most_recent")
    # Each quantizer owns its state.
    qset.x.scale.fill_(2.0)
    assert float(qset.kernel.scale[0]) == 1.0
    assert dataclasses.replace(qset.x).scale is qset.x.scale


def test_noop_quantizer_passes_through():
    x = torch.randn(4, 8)
    noop = NoopQuantizer(torch.float8_e4m3fn)
    assert noop.quantize(x) is x
    assert noop.quantize(x, layout=QuantizeLayout.ROWWISE_COLWISE) is x
    assert noop.update(torch.tensor(3.0)) is noop
