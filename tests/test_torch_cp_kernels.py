"""The flash kernels' runtime positions (the branch context parallelism
runs): ``flash_fwd`` and ``flash_bwd`` (their plain versions on the CPU)
with ``q_position_offset`` as an int or a one-element int32 tensor and
per-call window sides as ints or tensors, against the reference's
``_flash_fwd`` and ``_flash_bwd`` in interpret mode called with a ``jnp``
qoff and traced window bounds (``_win_dynamic`` true): positive offsets
(every key visible, a ring step on an earlier chunk), negative ones with
rows masked whole at the edges of the port's 64-row tiles and the
reference's 64-row blocks, a whole step masked (O = 0, LSE = -1e30, zero
gradients), the striped ring's strict causal rule with a live -1 left
bound, a two-sided band of negative left bound, segment ids, ALiBi, a
bias and FP8 payloads with an offset; then ``flash_attention`` with a
tensor offset and window against the reference's ``flash_attention``
and its ``jax.vjp``, the offset vector a row of a (cp, 3) table passes as
it lies, and the activity of a window side apart from its value.

On CPU tensors each wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.attention import AttnMaskType as JMask
from transformerengine_tpu.flex_attention import (
    alibi_arith_mod as j_alibi_arith_mod)
from transformerengine_tpu.ops.flash_attention import (
    _flash_bwd as j_flash_bwd, _flash_fwd as j_flash_fwd,
    flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import AttnMaskType
from transformerengine_tpu_torch.flex_attention import AlibiMod
from transformerengine_tpu_torch.ops import flash_attention as fa
from transformerengine_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_bwd, flash_fwd)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCK = 64
# Relative to each output's largest |ref|: f32 differs in summation order
# alone; bf16 O and gradients round to bf16 from f32 scores summed in other
# orders, a few one ulp (2^-8) apart, as the other flash tests hold them.
# FP8: the same payloads on both sides, every product exact in f32, p and
# ds rounded to bf16 after sums in other orders.
_RTOL = {"f32": 1e-5, "bf16": 2 ** -6, "fp8": 2 ** -6}
LSE_ATOL = 1e-5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


def _int(v):
    """A one-element int32 tensor (the runtime form of a position)."""
    return torch.tensor([v], dtype=torch.int32)


# name: (dtype, causal, qoff, window, form, term, segments). ``qoff`` and
# the window are the positions, a window side None where it is inactive
# and an int (any sign) where it is active; ``form`` says how the port
# takes them: "tensor" (a one-element int32 tensor each, an inactive side
# -1) or "int" (the static offset and window, active sides >= 0). The
# reference takes qoff as a jnp array and, with "tensor", the active sides
# as traced bounds. S = 128, two tiles of 64 on both sides.
_NONE = (None, None)
_CASES = {
    "f32_causal_earlier_chunk": ("f32", True, 128, _NONE, "tensor", None,
                                 False),
    "f32_causal_neg63": ("f32", True, -63, _NONE, "tensor", None, False),
    "f32_causal_neg64": ("f32", True, -64, _NONE, "tensor", None, False),
    "bf16_causal_neg65": ("bf16", True, -65, _NONE, "tensor", None, False),
    "f32_causal_all_masked": ("f32", True, -128, _NONE, "tensor", None,
                              False),
    "f32_striped_strict_live_minus1": ("f32", True, -1, (-1, None),
                                       "tensor", None, False),
    "bf16_striped_window2": ("bf16", True, 0, (2, 1), "tensor", None,
                             False),
    "f32_band_negative_left": ("f32", False, 0, (-1, 3), "tensor", None,
                               False),
    "bf16_int_offset_window": ("bf16", True, 40, (8, 0), "int", None,
                               False),
    "bf16_segments_qoff": ("bf16", True, 64, _NONE, "tensor", None, True),
    "f32_alibi_qoff": ("f32", True, 96, _NONE, "tensor", "alibi", False),
    "bf16_bias_qoff": ("bf16", True, -32, _NONE, "tensor", "bias", False),
    "fp8_qoff": ("fp8", True, 128, _NONE, "tensor", None, False),
    "fp8_window_live_minus1": ("fp8", True, -1, (-1, 0), "tensor", None,
                               False),
}
B, S, HQ, HKV, D = 1, 128, 4, 2, 32


def _case(name):
    dtype, causal, qoff, window, form, term, segs = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 700)
    t = {n: rng.standard_normal(shape).astype(np.float32)
         for n, shape in (("q", (B, S, HQ, D)), ("k", (B, S, HKV, D)),
                          ("v", (B, S, HKV, D)), ("do", (B, S, HQ, D)))}
    c = dict(dtype=dtype, causal=causal, qoff=qoff, window=window,
             form=form, term=term, scale=D ** -0.5)
    if dtype == "fp8":
        # Payloads and their dequant scales, the same bytes on both sides.
        c["scale_invs"] = np.array([0.02, 0.03, 0.025], np.float32)
        for n in ("q", "k", "v"):
            c[n] = torch.from_numpy(t[n] * 40).to(torch.float8_e4m3fn)
            c[n + "_j"] = jnp.asarray(c[n].float().numpy()).astype(
                jnp.float8_e4m3fn)
        c["do"] = torch.from_numpy(t["do"]).to(torch.bfloat16)
        c["do_j"] = jnp.asarray(c["do"].float().numpy()).astype(
            jnp.bfloat16)
    else:
        for n in ("q", "k", "v", "do"):
            c[n + "_j"] = jnp.asarray(t[n]).astype(_JD[dtype])
            c[n] = torch.tensor(np.asarray(c[n + "_j"], np.float32)).to(
                _TD[dtype])
    c["qseg"] = c["kseg"] = None
    if segs:
        ids = np.repeat(np.array([[1, 2, 3, 0]], np.int32), S // 4, axis=1)
        c["qseg"] = ids
        c["kseg"] = np.roll(ids, 7, axis=1)
    c["bias"] = None
    if term == "bias":
        c["bias"] = rng.standard_normal((1, HQ, S, S)).astype(np.float32)
    return c


def _port_positions(c):
    """The port's q_position_offset and window, in the case's form."""
    if c["form"] == "int":
        return c["qoff"], tuple(-1 if w is None else w for w in c["window"])
    return _int(c["qoff"]), tuple(-1 if w is None else _int(w)
                                  for w in c["window"])


def _ref_window(c):
    """The reference's window: traced bounds for the active sides (its
    ``_win_dynamic``) in the tensor form, -1 for an inactive one."""
    if c["form"] == "int":
        return tuple(-1 if w is None else w for w in c["window"])
    return tuple(-1 if w is None else jnp.asarray(w, jnp.int32)
                 for w in c["window"])


def _ref_kw(c):
    kw = dict(scale=c["scale"], causal=c["causal"], window=_ref_window(c),
              offset=0, block_q=BLOCK, block_k=BLOCK)
    if c["dtype"] == "fp8":
        kw["scale_invs"] = jnp.asarray(c["scale_invs"])
    if c["term"] == "alibi":
        kw["score_mod"] = j_alibi_arith_mod(HQ)
    return kw


def _port_kw(c):
    qoff, window = _port_positions(c)
    kw = dict(scale=c["scale"], causal=c["causal"], window=window,
              q_position_offset=qoff)
    if c["dtype"] == "fp8":
        kw["scale_invs"] = torch.from_numpy(c["scale_invs"])
    if c["term"] == "alibi":
        kw["score_mod"] = AlibiMod(HQ)
    if c["bias"] is not None:
        kw["bias"] = torch.from_numpy(c["bias"])
    if c["qseg"] is not None:
        kw["q_segment_ids"] = torch.from_numpy(c["qseg"])
        kw["kv_segment_ids"] = torch.from_numpy(c["kseg"])
    return kw


def _ref_segs(c):
    if c["qseg"] is None:
        return None, None
    return jnp.asarray(c["qseg"]), jnp.asarray(c["kseg"])


def _check(name, got, ref, rtol):
    ref = _np(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=rtol * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_positions_match_reference_flash(name):
    """O and LSE of ``flash_fwd``, then dQ, dK, dV (and dbias) of
    ``flash_bwd`` from the reference's O and LSE, against ``_flash_fwd``
    and ``_flash_bwd`` with the same positions."""
    c = _case(name)
    qj, kj, vj = (_bhsd(c[n + "_j"]) for n in ("q", "k", "v"))
    qseg_j, kseg_j = _ref_segs(c)
    bias_j = jnp.asarray(c["bias"]) if c["bias"] is not None else None
    qoff_j = jnp.asarray([c["qoff"]], jnp.int32)
    fwd_kw = _ref_kw(c)
    if c["dtype"] == "fp8":
        fwd_kw["out_dtype"] = jnp.bfloat16
    oj, lj = j_flash_fwd(qj, kj, vj, qseg_j, kseg_j, qoff_j, bias_j,
                         **fwd_kw)
    kw = _port_kw(c)
    if c["dtype"] == "fp8":
        kw["out_dtype"] = torch.bfloat16
    ot, lt = flash_fwd(c["q"], c["k"], c["v"], **kw)
    rtol = _RTOL[c["dtype"]]
    _check(f"{name} O", ot, _bhsd(oj), rtol)
    lj = _np(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=LSE_ATOL)
    # Rows that see no key: O = 0 and LSE = -1e30 on both sides.
    dead = lj <= NEG_INF / 2
    assert bool((lt.numpy()[dead] == NEG_INF).all())
    assert bool((ot.float().numpy().transpose(0, 2, 1, 3)[dead] == 0).all())
    if name == "f32_causal_all_masked":
        assert bool(dead.all())

    bwd_kw = _ref_kw(c)
    if c["dtype"] == "fp8":
        bwd_kw["grad_dtype"] = jnp.bfloat16
    grads_j = j_flash_bwd(qj, kj, vj, oj, lj, _bhsd(c["do_j"]), qseg_j,
                          kseg_j, qoff_j, bias_j, **bwd_kw)
    o_ref = torch.tensor(_np(_bhsd(oj))).to(ot.dtype)
    kw = _port_kw(c)
    if c["dtype"] == "fp8":
        kw["grad_dtype"] = torch.bfloat16
    grads_t = flash_bwd(c["q"], c["k"], c["v"], o_ref,
                        torch.from_numpy(lj.copy()), c["do"], **kw)
    for gname, got, ref in zip(("dQ", "dK", "dV"), grads_t, grads_j):
        _check(f"{name} {gname}", got, _bhsd(ref), rtol)
        if name == "f32_causal_all_masked":
            assert bool((got == 0).all())
    if c["bias"] is not None:
        _check(f"{name} dbias", grads_t[3], grads_j[3], rtol)


def test_live_minus1_is_not_an_inactive_side():
    """The striped ring's strict causal step (qoff -1) with the left bound
    -1 live: no key is visible (kj >= i and kj <= i - 1). Read as
    inactive, the same -1 would show every earlier key, and an offset one
    tile off moves the visible set."""
    c = _case("f32_striped_strict_live_minus1")
    kw = _port_kw(c)
    o, lse = flash_fwd(c["q"], c["k"], c["v"], **kw)
    assert bool((lse == NEG_INF).all()) and bool((o == 0).all())
    inactive = dict(kw, window=(-1, kw["window"][1]))
    _, lse_wrong = flash_fwd(c["q"], c["k"], c["v"], **inactive)
    assert bool((lse_wrong[..., 1:] > NEG_INF / 2).all())
    c = _case("f32_causal_neg63")
    kw = _port_kw(c)
    _, lse = flash_fwd(c["q"], c["k"], c["v"], **kw)
    shifted = dict(kw, q_position_offset=_int(-63 + 64))
    _, lse_shift = flash_fwd(c["q"], c["k"], c["v"], **shifted)
    assert int((lse > NEG_INF / 2).sum()) < int((lse_shift > NEG_INF / 2)
                                                 .sum())


def test_int_and_tensor_offsets_agree():
    """An int offset joins the static offset; the same value as a tensor
    is read at run time: the plain versions give the same bits, and the
    int form adds to a bottom-right offset as the reference's ``off =
    offset + qoff`` does."""
    c = _case("bf16_causal_neg65")
    q, k, v = c["q"], c["k"], c["v"]
    kw = dict(scale=c["scale"], causal=True)
    a = flash_fwd(q, k, v, q_position_offset=-65, **kw)
    b = flash_fwd(q, k, v, q_position_offset=_int(-65), **kw)
    d = flash_fwd(q, k, v, offset=-60, q_position_offset=_int(-5), **kw)
    for x, y in ((a, b), (a, d)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_table_row_passes_without_a_copy():
    """A row of a (cp, 3) int32 table, given as its offset and window
    views, reaches the kernels as one new vector of its values (stacked
    on the tensors' device); other forms are assembled the same way, an
    inactive side a placeholder, an active int side its own value."""
    table = torch.tensor([[5, 3, 0], [-7, -1, 2]], dtype=torch.int32)
    row = table[1]
    static, pos = fa._runtime_positions(
        0, (row[1:2], row[2:3]), row[0:1])
    assert static == (0, 0, 0)
    assert pos.dtype == torch.int32 and pos.tolist() == [-7, -1, 2]
    static, pos = fa._runtime_positions(4, (row[1:2], -1), row[0:1])
    assert static == (4, 0, -1) and pos.tolist() == [-7, -1, 0]
    static, pos = fa._runtime_positions(0, (9, -1), _int(3))
    assert static == (0, 9, -1) and pos.tolist() == [3, 9, 0]
    # An active int side beside a row: its value, not the row's, reaches
    # the kernels.
    static, pos = fa._runtime_positions(0, (5, -1), row[0:1])
    assert static == (0, 5, -1) and pos.tolist() == [-7, 5, 0]
    static, pos = fa._runtime_positions(2, (9, -1), 3)
    assert static == (5, 9, -1) and pos is None
    assert fa._win_active((torch.tensor([-1]), -1)) == (True, False)
    assert fa._branch(False, False, (torch.tensor([-1]), -1), None, False,
                      qoff=True) == "_sw_qoff"
    assert fa._branch(True, False, (-1, -1), None, True,
                      qoff=True) == "_fp8_seg_qoff"


@pytest.mark.parametrize("form", ["int", "tensor"])
def test_flash_attention_offset_matches_reference_vjp(form):
    """``flash_attention`` with ``q_position_offset`` (and in tensor form a
    runtime window side of value 5) against the reference's
    ``flash_attention`` with the same offset and its ``jax.vjp``."""
    rng = np.random.default_rng(31)
    b, sq, skv, hq, hkv, d = 1, 64, 96, 4, 2, 32
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                        (b, sq, hq, d))]
    qj, kj, vj, doj = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    qt, kt, vt, dot = (torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (qj, kj, vj, doj))
    qoff = 20

    def fj(q, k, v):
        return j_flash_attention(
            q, k, v, attn_mask_type=JMask.CAUSAL,
            window_size=(5, -1) if form == "tensor" else None,
            q_position_offset=qoff, block_q=32, block_k=32)

    oj, vjp = jax.vjp(fj, qj, kj, vj)
    gj = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    window = (_int(5), -1) if form == "tensor" else None
    ot = flash_attention(
        qt, kt, vt, attn_mask_type=AttnMaskType.CAUSAL, window_size=window,
        q_position_offset=_int(qoff) if form == "tensor" else qoff)
    ot.backward(dot)
    _check("O", ot, oj, 2 ** -6)
    for gname, got, ref in zip(("dQ", "dK", "dV"),
                               (qt.grad, kt.grad, vt.grad), gj):
        _check(gname, got, ref, 2 ** -6)
