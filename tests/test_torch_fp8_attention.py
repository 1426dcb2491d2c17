"""FP8 flash attention of the port (the ``fp8_dpa`` and ``fp8_mha``
branches) against the JAX package, on the CPU: the plain forward and
backward with FP8 Q/K/V payloads against the Pallas kernels in interpret
mode (``_flash_fwd`` with ``scale_invs``, ``out_dtype`` and
``out_scale``; ``_flash_bwd`` with ``scale_invs``, ``o_scale_inv`` and
``do_scale_inv``), across causal, padding-causal with fully masked rows,
GQA groups of 2, 4 and 8, D 64 and 128, a window with a sink and an O
scale that saturates; then ``flash_attention(qkv_quantizers=...)`` and
``flash_attention(mha_proj=...)`` against the reference's ``jax.vjp``: O,
the projected output, dQ, dK, dV, dW, dsink and the updated delayed
quantizer state.

Inputs are seeded numpy arrays rounded to bf16 on both sides. On CPU
tensors each wrapper runs its plain version; ``chip_smoke.py`` holds the
CUDA kernels against the same plain versions on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.attention import (
    AttnMaskType as JMask, SequenceDescriptor as JDesc,
    SoftmaxType as JSoftmax)
from transformerengine_tpu.ops.flash_attention import (
    _flash_bwd as j_flash_bwd, _flash_fwd as j_flash_fwd,
    flash_attention as j_flash_attention)
from transformerengine_tpu.quantize.quantizer import (
    CurrentScaleQuantizer as JCurrent, DelayedScaleQuantizer as JDelayed,
    QuantizeLayout as JLayout)
from transformerengine_tpu.quantize.scaling_modes import ScalingMode as JMode
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor, SoftmaxType)
from transformerengine_tpu_torch.ops.flash_attention import (
    flash_attention, flash_bwd, flash_fwd)
from transformerengine_tpu_torch.quantize.quantizer import (
    BlockScaleQuantizer, CurrentScaleQuantizer, DelayedScaleQuantizer,
    QuantizeLayout)

torch.set_num_threads(2)

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_JDT = {E4M3: jnp.float8_e4m3fn, E5M2: jnp.float8_e5m2}
BLOCK = 16      # the reference's blocks: S = 48 spans three of them

# Relative to each output's largest |ref|. O and the gradients are bf16
# on both sides, and p and ds round to bf16 from f32 scores summed in
# other orders (every product is exact in f32), so a few of them land
# one bf16 ulp (2^-8) apart: readings O 3.3e-3, dQ 6.7e-3, dK 5.1e-3, dV
# 0, dsink 1.7e-3, the projected output 5.9e-3, as the bf16 flash tests
# hold them.
RTOL = 2 ** -6
# dW contracts the fp8 O payload, where those differences move about 3 %
# of the codes by one e4m3 step (1/8 of the value at most): reading
# 1.14e-2.
DW_RTOL = 2 ** -5
# LSE is an f32 sum in another order: readings below 1e-6.
LSE_ATOL = 1e-5
# The O amax is the largest |O| in f32 before the cast, which moves as O
# does (p rounded to bf16 at other running maxima): reading 5.9e-4.
AMAX_RTOL = RTOL
# The delayed state after a step: the amaxes of O (f32, moving as in the
# forward, 5.9e-4 there) and of dO (a bf16 rounding of an f32 product
# summed in another order, one bf16 ulp); readings below 1e-7.
STATE_RTOL = 2 ** -7


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _pair(x: np.ndarray, grad: bool = False):
    """x rounded to bf16: (JAX array, torch tensor)."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)
    return xj, xt.requires_grad_(grad)


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


def _j_current(dtype=E4M3):
    return JCurrent(q_dtype=jnp.dtype(_JDT[dtype]),
                    scaling_mode=JMode.CURRENT_TENSOR_SCALING,
                    q_layout=JLayout.ROWWISE)


def _t_current(dtype=E4M3):
    return CurrentScaleQuantizer(dtype, QuantizeLayout.ROWWISE)


def _close(name, got, ref, rtol=RTOL):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=rtol * np.abs(ref).max(), err_msg=name)


def _fp8_close(name, got, ref) -> None:
    """fp8 payloads whose values differ by at most one e4m3 step at the
    reference's value plus the bf16 tolerance of O: the f32 O before the
    cast differs as a bf16 O does (RTOL of the largest), and a value at a
    rounding tie of the cast moves by one code."""
    g, r = _np(got), _np(ref)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -6))) - 3)
    tol = step + RTOL * np.abs(r).max()
    assert bool((np.abs(g - r) <= tol).all()), (name, np.abs(g - r).max())
    # Readings: 3.2 % of the codes differ.
    assert (_bytes(got) != _bytes(ref)).mean() < 0.1, name


# (mask, GQA group, D, window, sink, O: bf16 or an fp8 out_scale, lengths)
_FWD_CASES = {
    "causal": ("causal", 2, 64, None, None, "bf16", None),
    "padding_fp8_o": ("padding_causal", 2, 64, None, None, 64.0, (48, 21)),
    "gqa4_d128": ("causal", 4, 128, None, None, "bf16", None),
    "window_sink_fp8_o": ("padding_causal", 2, 64, (12, 0), "learnable",
                          64.0, (48, 30)),
    "gqa8_off_by_one": ("causal", 8, 64, (20, 0), "off_by_one", "bf16",
                        None),
    "saturating_o": ("no_mask", 2, 64, None, None, 640.0, None),
}


def _fwd_case(name):
    mask, group, d, window, sink, out, lens = _FWD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b, s, hkv = 2, 48, 1 if group == 8 else 2
    hq = hkv * group
    q, k, v = (_pair(rng.standard_normal((b, s, h, d)))
               for h in (hq, hkv, hkv))
    sink_v = {None: None, "off_by_one": np.zeros(hq, np.float32),
              "learnable": rng.standard_normal(hq).astype(np.float32)}[sink]
    return dict(mask=mask, d=d, window=window, sink=sink_v, out=out,
                lens=lens, q=q, k=k, v=v, rng=rng)


def _quantized(c):
    """Q, K and V quantized by current scaling on both sides (payload
    bytes held equal): ((J payloads), (torch payloads), J scale_invs,
    torch scale_invs)."""
    jq = [_j_current().quantize(c[n][0], layout=JLayout.ROWWISE)
          for n in "qkv"]
    tq = [_t_current().quantize(c[n][1], layout=QuantizeLayout.ROWWISE)
          for n in "qkv"]
    for n, a, r in zip("qkv", tq, jq):
        np.testing.assert_array_equal(_bytes(a.data), _bytes(r.data),
                                      err_msg=f"{n} payload")
        assert float(a.scale_inv) == float(np.asarray(r.scale_inv)[0])
    jsinv = jnp.stack([x.scale_inv.reshape(()) for x in jq])
    tsinv = torch.cat([x.scale_inv.reshape(1) for x in tq])
    return [x.data for x in jq], [x.data for x in tq], jsinv, tsinv


def _masks(c):
    """(reference qseg, kseg or None, port lengths or None, causal,
    window)."""
    lens = c["lens"]
    s = c["q"][1].shape[1]
    if lens is None:
        return None, None, None, c["mask"] != "no_mask", c["window"]
    seg = (np.arange(s)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    t = torch.tensor(lens, dtype=torch.int32)
    return jnp.asarray(seg), jnp.asarray(seg), t, True, c["window"]


def _j_fwd(c, jp, jsinv, out_scale=None, out_dtype=jnp.bfloat16):
    qseg, kseg, _, causal, window = _masks(c)
    d = c["d"]
    return j_flash_fwd(
        *(_bhsd(x) for x in jp), qseg, kseg, jnp.zeros((1,), jnp.int32),
        scale=d ** -0.5, causal=causal, window=window or (-1, -1), offset=0,
        block_q=BLOCK, block_k=BLOCK, static_pos=True, scale_invs=jsinv,
        out_dtype=out_dtype, out_scale=out_scale,
        softmax_sink=None if c["sink"] is None else jnp.asarray(c["sink"]))


def _t_fwd(c, tp, tsinv, out_scale=None, out_dtype=torch.bfloat16):
    _, _, lens, causal, window = _masks(c)
    return flash_fwd(
        *tp, lens, lens, scale=c["d"] ** -0.5, causal=causal,
        window=window, scale_invs=tsinv, out_dtype=out_dtype,
        out_scale=out_scale,
        softmax_sink=None if c["sink"] is None else torch.from_numpy(
            c["sink"]))


@pytest.mark.parametrize("name", list(_FWD_CASES))
def test_fp8_fwd_matches_pallas(name):
    """O (bf16, or the fp8 epilogue's payload and its amax) and LSE of
    the plain FP8 forward against the Pallas forward in interpret mode
    on the same payloads."""
    c = _fwd_case(name)
    jp, tp, jsinv, tsinv = _quantized(c)
    if c["out"] == "bf16":
        oj, lj = _j_fwd(c, jp, jsinv)
        ot, lt = _t_fwd(c, tp, tsinv)
        assert ot.dtype == torch.bfloat16
        _close("O", ot, _bhsd(oj))
    else:
        oscale = np.array([c["out"]], np.float32)
        oj, lj, aj = _j_fwd(c, jp, jsinv, jnp.asarray(oscale),
                            jnp.float8_e4m3fn)
        ot, lt, at = _t_fwd(c, tp, tsinv, torch.from_numpy(oscale), E4M3)
        assert ot.dtype == E4M3 and at.shape == ()
        _fp8_close("O payload", ot, _bhsd(oj))
        np.testing.assert_allclose(float(at), float(aj), rtol=AMAX_RTOL)
        saturated = float(np.abs(_np(ot)).max()) == 448.0
        assert saturated == (name == "saturating_o"), name
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=LSE_ATOL)
    if c["lens"] is not None:
        # Fully masked rows write O = 0 (and so add nothing to the amax)
        # and LSE = the sink, or -1e30 without one.
        short = c["lens"][1]
        assert float(np.abs(_np(ot)[1, short:]).max()) == 0.0


_BWD_CASES = {
    "dpa_causal": ("causal", False),
    "dpa_window_sink": ("window_sink_fp8_o", False),
    "mha_padding": ("padding_fp8_o", True),
    "mha_gqa4_d128": ("gqa4_d128", True),
    "mha_window_sink": ("window_sink_fp8_o", True),
}


@pytest.mark.parametrize("name", list(_BWD_CASES))
def test_fp8_bwd_matches_pallas(name):
    """dQ, dK and dV of the plain FP8 backward against the Pallas
    backward in interpret mode, from the same payloads, O and LSE: bf16
    dO (fp8_dpa), or fp8 O and e5m2 dO payloads (fp8_mha)."""
    fwd_name, mha = _BWD_CASES[name]
    c = _fwd_case(fwd_name)
    jp, tp, jsinv, tsinv = _quantized(c)
    qseg, kseg, lens, causal, window = _masks(c)
    do = c["rng"].standard_normal(c["q"][1].shape)
    doj, dot = _pair(do)
    kw_j, kw_t = {}, {}
    if mha:
        oscale = np.array([64.0], np.float32)
        oj, lj, _ = _j_fwd(c, jp, jsinv, jnp.asarray(oscale),
                           jnp.float8_e4m3fn)
        so_inv = 1.0 / oscale
        qdo_j = _j_current(E5M2).quantize(doj, layout=JLayout.ROWWISE)
        qdo_t = _t_current(E5M2).quantize(dot, layout=QuantizeLayout.ROWWISE)
        np.testing.assert_array_equal(_bytes(qdo_t.data), _bytes(qdo_j.data))
        doj, dot = qdo_j.data, qdo_t.data
        kw_j = dict(o_scale_inv=jnp.asarray(so_inv),
                    do_scale_inv=qdo_j.scale_inv, grad_dtype=jnp.bfloat16)
        kw_t = dict(o_scale_inv=torch.from_numpy(so_inv),
                    do_scale_inv=qdo_t.scale_inv, grad_dtype=torch.bfloat16)
    else:
        oj, lj = _j_fwd(c, jp, jsinv)
        kw_j = dict(grad_dtype=jnp.bfloat16)
    if mha:
        ot = torch.from_numpy(_bytes(_bhsd(oj)).copy()).view(E4M3)
    else:
        ot = torch.tensor(_np(_bhsd(oj))).to(torch.bfloat16)
    lt = torch.from_numpy(_np(lj).copy())
    d = c["d"]
    gj = j_flash_bwd(
        *(_bhsd(x) for x in jp), oj, lj, _bhsd(doj), qseg, kseg,
        jnp.zeros((1,), jnp.int32), scale=d ** -0.5, causal=causal,
        window=window or (-1, -1), offset=0, block_q=BLOCK, block_k=BLOCK,
        static_pos=True, scale_invs=jsinv, **kw_j)
    gt = flash_bwd(*tp, ot, lt, dot, lens, lens, scale=d ** -0.5,
                   causal=causal, window=window, scale_invs=tsinv,
                   softmax_sink=None if c["sink"] is None
                   else torch.from_numpy(c["sink"]), **kw_t)
    for gname, a, r in zip(("dQ", "dK", "dV"), gt, gj[:3]):
        assert a.dtype == torch.bfloat16, gname
        _close(gname, a, _bhsd(r))


def _descs(lens):
    if lens is None:
        return None, None, JMask.CAUSAL, AttnMaskType.CAUSAL
    arr = np.asarray(lens, np.int32)
    return (JDesc.from_seqlens(jnp.asarray(arr)),
            SequenceDescriptor.from_seqlens(torch.from_numpy(arr)),
            JMask.PADDING_CAUSAL, AttnMaskType.PADDING_CAUSAL)


@pytest.mark.parametrize("name", ["causal", "window_sink_fp8_o"])
def test_fp8_dpa_matches_reference_vjp(name):
    """``flash_attention(qkv_quantizers=...)``: O and dQ, dK, dV (and the
    learnable sink's gradient) against the reference's ``jax.vjp``."""
    c = _fwd_case(name)
    desc_j, desc_t, mj, mt = _descs(c["lens"])
    sink = c["sink"]
    stype_j = None if sink is None else JSoftmax.LEARNABLE
    stype_t = None if sink is None else SoftmaxType.LEARNABLE
    offj = jnp.zeros(1) if sink is None else jnp.asarray(sink)

    def fj(q, k, v, off):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=mj, window_size=c["window"],
            qkv_quantizers=tuple(_j_current() for _ in range(3)),
            softmax_type=stype_j,
            softmax_offset=None if sink is None else off,
            block_q=BLOCK, block_k=BLOCK)

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
                         softmax_type=stype_t, softmax_offset=offt)
    ot.backward(dot)
    _close("O", ot, oj)
    for gname, a, r in zip(("dQ", "dK", "dV"), (qt.grad, kt.grad, vt.grad),
                           grads_j):
        assert a.dtype == torch.bfloat16
        _close(gname, a, r)
    if sink is not None:
        _close("dsink", offt.grad, grads_j[3])
    # Without a gradient the same forward runs, with no autograd node.
    with torch.no_grad():
        o2 = flash_attention(qt, kt, vt, desc_t, attn_mask_type=mt,
                             window_size=c["window"],
                             qkv_quantizers=[_t_current() for _ in range(3)],
                             softmax_type=stype_t, softmax_offset=offt)
    assert o2.grad_fn is None and torch.equal(o2, ot.detach())


_HIST = 8
# HYBRID: the forward's O and W in e4m3, the gradients g and dO in e5m2.
_MHA_DTYPES = (E4M3, E4M3, E5M2, E5M2)


def _mha_quantizers(recipe, state):
    """(J 7-tuple, torch 7-tuple) of (q, k, v, o, w, g, do) quantizers:
    current-scaling e4m3 Q/K/V and, for o, w, g, do, current scaling or
    delayed scaling from ``state`` ((scale, history) numpy pairs)."""
    jq = [_j_current() for _ in range(3)]
    tq = [_t_current() for _ in range(3)]
    for i, dt in enumerate(_MHA_DTYPES):
        if recipe == "current":
            jq.append(_j_current(dt))
            tq.append(_t_current(dt))
            continue
        scale, hist = state[i]
        jq.append(JDelayed(q_dtype=jnp.dtype(_JDT[dt]),
                           scaling_mode=JMode.DELAYED_TENSOR_SCALING,
                           q_layout=JLayout.ROWWISE,
                           scale=jnp.asarray(scale),
                           amax_history=jnp.asarray(hist)))
        tq.append(DelayedScaleQuantizer(
            dt, QuantizeLayout.ROWWISE, scale=torch.from_numpy(scale.copy()),
            amax_history=torch.from_numpy(hist.copy())))
    return tuple(jq), tuple(tq)


@pytest.mark.parametrize("recipe,name", [("delayed", "causal"),
                                         ("delayed", "window_sink_fp8_o"),
                                         ("current", "gqa4_d128")])
def test_fp8_mha_matches_reference_vjp(recipe, name):
    """``flash_attention(mha_proj=...)``: the projected output, dQ, dK,
    dV, dW (and dsink) against the reference's ``jax.vjp``, and under
    delayed scaling the updated state of the o, w, g and do quantizers
    (the reference's cotangent of the quantizers; the port's tensors
    after the backward), after a warm-up step that sets the scales from
    real amaxes."""
    c = _fwd_case(name)
    desc_j, desc_t, mj, mt = _descs(c["lens"])
    rng = c["rng"]
    hq, d = c["q"][1].shape[2], c["d"]
    n = 96
    wj, wt = _pair(rng.standard_normal((hq * d, n)) / np.sqrt(hq * d))
    gj, gt = _pair(rng.standard_normal((2, 48, n)))
    sink = c["sink"]
    stype = None if sink is None else (JSoftmax.LEARNABLE,
                                       SoftmaxType.LEARNABLE)
    offj = jnp.zeros(1) if sink is None else jnp.asarray(sink)

    def run_j(state):
        jq, _ = _mha_quantizers(recipe, state)

        def fj(q, k, v, w, off, quantizers):
            return j_flash_attention(
                q, k, v, desc_j, attn_mask_type=mj,
                window_size=c["window"], mha_proj=(w, quantizers),
                softmax_type=stype and stype[0],
                softmax_offset=None if sink is None else off,
                block_q=BLOCK, block_k=BLOCK)
        out, vjp = jax.vjp(fj, c["q"][0], c["k"][0], c["v"][0], wj, offj, jq)
        return out, vjp(gj)

    state = [(np.ones(1, np.float32), np.zeros(_HIST, np.float32))] * 4
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
                            softmax_type=stype and stype[1],
                            softmax_offset=offt)
    assert out_t.shape == (2, 48, n) and out_t.dtype == torch.bfloat16
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
            # This step's amax is in the history's last slot, and the
            # scale moved off the warm-up's.
            assert float(zt.amax_history[-1]) > 0, role
    # Without a gradient: the same output, and the state is left alone.
    before = [z.scale.clone() for z in tq[3:] if hasattr(z, "scale")]
    with torch.no_grad():
        out2 = flash_attention(qt, kt, vt, desc_t, attn_mask_type=mt,
                               window_size=c["window"], mha_proj=(wt, tq),
                               softmax_type=stype and stype[1],
                               softmax_offset=offt)
    assert out2.grad_fn is None and out2.shape == out_t.shape
    after = [z.scale for z in tq[3:] if hasattr(z, "scale")]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_fp8_arguments():
    """What the FP8 branch refuses: a block-scaled quantizer, e5m2 Q/K/V
    payloads, an fp8 O without its scale, an O scale without FP8 Q/K/V
    and fp8 O and dO payloads without FP8 Q/K/V; ``mha_proj`` takes
    seven quantizers."""
    q = torch.zeros((1, 16, 2, 32), dtype=torch.bfloat16)
    k = v = torch.zeros((1, 16, 1, 32), dtype=torch.bfloat16)
    blocks = [BlockScaleQuantizer(E4M3)] * 3
    with pytest.raises(ValueError, match="per-tensor"):
        flash_attention(q, k, v, qkv_quantizers=blocks)
    with pytest.raises(TypeError, match="e4m3"):
        flash_attention(q, k, v,
                        qkv_quantizers=[_t_current(E5M2)] * 3)
    q8, k8 = q.to(E4M3), k.to(E4M3)
    one = torch.ones(3)
    with pytest.raises(ValueError, match="out_scale"):
        flash_fwd(q8, k8, k8, scale=1.0, causal=True, scale_invs=one,
                  out_dtype=E4M3)
    with pytest.raises(ValueError, match="epilogue"):
        flash_fwd(q, k, v, scale=1.0, causal=True, out_scale=one[:1])
    o, lse = flash_fwd(q, k, v, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="payloads"):
        flash_bwd(q, k, v, o, lse, q, scale=1.0, causal=True,
                  do_scale_inv=one[:1])
    with pytest.raises(ValueError, match="seven|quantizers"):
        flash_attention(q, k, v, mha_proj=(torch.zeros(64, 8), [None] * 4))


def test_recipes_carry_the_attention_flags():
    """The per-tensor recipes take the reference's fp8_dpa and fp8_mha
    fields, off by default."""
    from transformerengine_tpu import common as jcommon
    from transformerengine_tpu_torch import (
        DelayedScaling, Float8CurrentScaling, MXFP8BlockScaling)
    for ours, ref in ((DelayedScaling, jcommon.recipe.DelayedScaling),
                      (Float8CurrentScaling,
                       jcommon.recipe.Float8CurrentScaling),
                      (MXFP8BlockScaling, jcommon.recipe.MXFP8BlockScaling)):
        fields = {f.name: f.default for f in dataclasses.fields(ours)}
        ref_fields = {f.name: f.default for f in dataclasses.fields(ref)}
        for flag in ("fp8_dpa", "fp8_mha"):
            assert fields[flag] is False and ref_fields[flag] is False
        assert ours(fp8_dpa=True, fp8_mha=True).fp8_mha
