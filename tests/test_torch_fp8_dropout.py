"""Dropout on FP8 Q/K/V in the port's flash attention, against the JAX
package on the CPU: ``flash_attention(qkv_quantizers=...)`` and
``flash_attention(mha_proj=...)`` at rate 0.1 against the reference's
``jax.vjp`` on the same seed words (O or the projected output, dQ, dK,
dV, dW, dsink and the updated delayed state), across causal,
padding-causal with fully masked rows, GQA and a window with a sink; the
keep bits that the FP8 branch's autograd functions hand the kernels equal
the reference's ``_dropout_keep`` over its own tiles, in the forward and
the backward; another seed word moves O beyond the tolerance.

Inputs are seeded numpy arrays rounded to bf16 on both sides. On CPU
tensors each wrapper runs its plain version; ``chip_smoke.py`` holds the
CUDA kernels against the same plain versions on the card (rows 2fd, 2od,
4fd and 4od)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dropout_kernels import SEED, _reference_keep
from test_torch_fp8_attention import (
    BLOCK, DW_RTOL, RTOL, STATE_RTOL, _close, _descs, _fwd_case,
    _j_current, _mha_quantizers, _pair, _t_current)
from transformerengine_tpu.attention import SoftmaxType as JSoftmax
from transformerengine_tpu.ops.flash_attention import (
    flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import SoftmaxType
from transformerengine_tpu_torch.ops import flash_attention as fa
from transformerengine_tpu_torch.ops.flash_attention import (
    dropout_keep, flash_attention)

torch.set_num_threads(2)

RATE = 0.1


def _drop_kw(seed=SEED):
    """The reference's and the port's dropout arguments on ``seed``."""
    return (dict(dropout_probability=RATE, dropout_seed=jnp.asarray(seed)),
            dict(dropout_probability=RATE,
                 dropout_seed=torch.from_numpy(seed)))


def _stype(sink):
    return (None, None) if sink is None else (JSoftmax.LEARNABLE,
                                               SoftmaxType.LEARNABLE)


def _dpa(c, seed=SEED):
    """(port O and gradients, reference O and gradients) of
    ``flash_attention(qkv_quantizers=...)`` with dropout, the reference
    on SEED and the port on ``seed``."""
    desc_j, desc_t, mj, mt = _descs(c["lens"])
    sink = c["sink"]
    sj, st = _stype(sink)
    offj = jnp.zeros(1) if sink is None else jnp.asarray(sink)
    dj, dt = _drop_kw()[0], _drop_kw(seed)[1]

    def fj(q, k, v, off):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=mj, window_size=c["window"],
            qkv_quantizers=tuple(_j_current() for _ in range(3)),
            softmax_type=sj, softmax_offset=None if sink is None else off,
            block_q=BLOCK, block_k=BLOCK, **dj)

    oj, vjp = jax.vjp(fj, c["q"][0], c["k"][0], c["v"][0], offj)
    doj, dot = _pair(c["rng"].standard_normal(c["q"][1].shape))
    grads_j = vjp(doj)
    qt, kt, vt = (c[n][1].detach().clone().requires_grad_(True)
                  for n in "qkv")
    offt = None if sink is None else torch.from_numpy(
        sink).requires_grad_(True)
    ot = flash_attention(qt, kt, vt, desc_t, attn_mask_type=mt,
                         window_size=c["window"],
                         qkv_quantizers=[_t_current() for _ in range(3)],
                         softmax_type=st, softmax_offset=offt,
                         block_q=BLOCK, block_k=BLOCK, **dt)
    ot.backward(dot)
    got = [ot, qt.grad, kt.grad, vt.grad]
    ref = [oj, *grads_j[:3]]
    if sink is not None:
        got.append(offt.grad)
        ref.append(grads_j[3])
    return got, ref


@pytest.mark.parametrize("name", ["causal", "window_sink_fp8_o",
                                  "padding_fp8_o"])
def test_fp8_dpa_dropout_matches_reference_vjp(name):
    """``flash_attention(qkv_quantizers=...)`` at rate 0.1: O, dQ, dK, dV
    (and dsink) against the reference's ``jax.vjp`` on the same seed
    words, and the same forward without a gradient."""
    c = _fwd_case(name)
    got, ref = _dpa(c)
    for gname, a, r in zip(("O", "dQ", "dK", "dV", "dsink"), got, ref):
        assert a is not None and tuple(a.shape) == tuple(r.shape), gname
        _close(gname, a, r)
    if c["lens"] is not None:
        short = c["lens"][1]
        assert float(got[0].detach()[1, short:].abs().max()) == 0.0
    _, desc_t, _, mt = _descs(c["lens"])
    with torch.no_grad():
        o2 = flash_attention(c["q"][1], c["k"][1], c["v"][1], desc_t,
                             attn_mask_type=mt, window_size=c["window"],
                             qkv_quantizers=[_t_current() for _ in range(3)],
                             softmax_type=_stype(c["sink"])[1],
                             softmax_offset=None if c["sink"] is None
                             else torch.from_numpy(c["sink"]),
                             block_q=BLOCK, block_k=BLOCK, **_drop_kw()[1])
    assert o2.grad_fn is None and torch.equal(o2, got[0].detach())


def test_another_seed_word_moves_the_fp8_output():
    """The test has teeth: the port on a seed whose second word is off by
    one misses the reference's O by far more than the tolerance."""
    c = _fwd_case("causal")
    other = SEED.copy()
    other[1] += 1
    got, ref = _dpa(c, other)
    r = np.asarray(ref[0], np.float32)
    assert np.abs(got[0].detach().float().numpy() - r).max() > \
        8 * RTOL * np.abs(r).max()


@pytest.mark.parametrize("recipe,name", [("delayed", "causal"),
                                         ("current", "window_sink_fp8_o"),
                                         ("current", "gqa4_d128")])
def test_fp8_mha_dropout_matches_reference_vjp(recipe, name):
    """``flash_attention(mha_proj=...)`` at rate 0.1: the projected
    output, dQ, dK, dV, dW (and dsink) against the reference's
    ``jax.vjp`` on the same seed words, and under delayed scaling the
    updated o, w, g and do state, after a warm-up step."""
    c = _fwd_case(name)
    desc_j, desc_t, mj, mt = _descs(c["lens"])
    rng = c["rng"]
    hq, d = c["q"][1].shape[2], c["d"]
    n = 96
    wj, wt = _pair(rng.standard_normal((hq * d, n)) / np.sqrt(hq * d))
    gj, gt = _pair(rng.standard_normal((2, 48, n)))
    sink = c["sink"]
    sj, st = _stype(sink)
    offj = jnp.zeros(1) if sink is None else jnp.asarray(sink)
    dj, dt = _drop_kw()

    def run_j(state):
        jq, _ = _mha_quantizers(recipe, state)

        def fj(q, k, v, w, off, quantizers):
            return j_flash_attention(
                q, k, v, desc_j, attn_mask_type=mj,
                window_size=c["window"], mha_proj=(w, quantizers),
                softmax_type=sj,
                softmax_offset=None if sink is None else off,
                block_q=BLOCK, block_k=BLOCK, **dj)
        out, vjp = jax.vjp(fj, c["q"][0], c["k"][0], c["v"][0], wj, offj, jq)
        return out, vjp(gj)

    state = [(np.ones(1, np.float32), np.zeros(8, np.float32))] * 4
    if recipe == "delayed":
        upd = run_j(state)[1][5]
        state = [(np.asarray(z.scale, np.float32),
                  np.asarray(z.amax_history, np.float32)) for z in upd[3:]]
    out_j, grads_j = run_j(state)
    _, tq = _mha_quantizers(recipe, state)
    qt, kt, vt = (c[x][1].detach().clone().requires_grad_(True)
                  for x in "qkv")
    wt.requires_grad_(True)
    offt = None if sink is None else torch.from_numpy(
        sink).requires_grad_(True)
    out_t = flash_attention(qt, kt, vt, desc_t, attn_mask_type=mt,
                            window_size=c["window"], mha_proj=(wt, tq),
                            softmax_type=st, softmax_offset=offt,
                            block_q=BLOCK, block_k=BLOCK, **dt)
    out_t.backward(gt)
    _close("out", out_t, out_j)
    for gname, a, r in zip(("dQ", "dK", "dV", "dW"),
                           (qt.grad, kt.grad, vt.grad, wt.grad), grads_j):
        assert a.dtype == torch.bfloat16, gname
        _close(gname, a, r, DW_RTOL if gname == "dW" else RTOL)
    if sink is not None:
        _close("dsink", offt.grad, grads_j[4])
    if recipe == "delayed":
        for role, zt, zj in zip("owgd", tq[3:], grads_j[5][3:]):
            np.testing.assert_allclose(
                zt.scale.numpy(), np.asarray(zj.scale), rtol=STATE_RTOL,
                err_msg=f"{role} scale")
            np.testing.assert_allclose(
                zt.amax_history.numpy(), np.asarray(zj.amax_history),
                rtol=STATE_RTOL, err_msg=f"{role} history")


@pytest.mark.parametrize("how", ["qkv_quantizers", "mha_proj"])
def test_fp8_keep_bits_are_the_references(how, monkeypatch):
    """The FP8 branch's forward and backward hand the kernels the
    reference's seed words, rate and tiles: the mask they derive
    (``dropout_keep``) equals the reference's ``_dropout_keep`` assembled
    over its own tiles, bit for bit, at a GQA group of 4 with padded
    lengths."""
    c = _fwd_case("gqa4_d128")
    seen = []
    real_fwd, real_bwd = fa.flash_fwd, fa.flash_bwd

    def record(real):
        def call(q, k, *args, **kw):
            seen.append((q.shape, k.shape, kw["dropout_seed"],
                         kw["dropout_probability"], kw["block_q"],
                         kw["block_k"], kw.get("scale_invs") is not None))
            return real(q, k, *args, **kw)
        return call

    monkeypatch.setattr(fa, "flash_fwd", record(real_fwd))
    monkeypatch.setattr(fa, "flash_bwd", record(real_bwd))
    qt, kt, vt = (c[x][1].detach().clone().requires_grad_(True)
                  for x in "qkv")
    kw = dict(block_q=BLOCK, block_k=BLOCK, **_drop_kw()[1])
    if how == "mha_proj":
        hq, d = qt.shape[2], qt.shape[3]
        w = torch.zeros((hq * d, 8), dtype=torch.bfloat16,
                        requires_grad=True)
        out = flash_attention(qt, kt, vt, mha_proj=(w, [_t_current()] * 7),
                              **kw)
    else:
        out = flash_attention(qt, kt, vt,
                              qkv_quantizers=[_t_current()] * 3, **kw)
    out.float().sum().backward()
    assert len(seen) == 2
    for qs, ks, seed, rate, bq, bk, fp8 in seen:
        assert fp8 and rate == RATE and (bq, bk) == (BLOCK, BLOCK)
        b, sq, hq = qs[:3]
        skv, hkv = ks[1], ks[2]
        got = dropout_keep(seed, b, hq, hkv, sq, skv, rate, bq, bk)
        ref = _reference_keep(SEED, b, hq, hkv, sq, skv, RATE, BLOCK, BLOCK)
        assert np.array_equal(got.numpy(), ref)
