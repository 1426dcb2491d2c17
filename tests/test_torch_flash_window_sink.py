"""The sliding window and the softmax sink of the port's flash attention
against the JAX package: the plain forward (O and LSE) and backward (dQ,
dK, dV and the sink's gradient) against the Pallas flash attention in
interpret mode and its ``jax.vjp``, across left, right and two-sided
bands, the off-by-one and learnable sinks, padding-causal with a sink,
the bottom-right offset and a GQA group of 8 at D = 64; the unfused
backend's band and sink against the reference's; and the wrapper's
arguments.

On CPU tensors each wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.attention import (
    AttnBackend as JBackend, AttnMaskType as JMask,
    SequenceDescriptor as JDesc, SoftmaxType as JSoftmax,
    fused_attn as j_fused_attn)
from transformerengine_tpu.ops.flash_attention import (
    _flash_fwd as j_flash_fwd, flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import (
    AttnBackend, AttnMaskType, AttnSoftmaxType, SequenceDescriptor,
    SoftmaxType, fused_attn, make_attention_mask)
from transformerengine_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_fwd)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


# (dtype, mask, window, sink, GQA group, head dim): every band shape and
# sink type, in both dtypes, the sink with padded rows, the band with the
# bottom-right offset, and GPT-OSS's group of 8 at D = 64.
_CASES = [
    ("f32", "causal", (8, 0), None, 2, 32),
    ("bf16", "no_mask", (-1, 5), None, 2, 32),
    ("f32", "no_mask", (6, 4), "off_by_one", 2, 32),
    ("bf16", "causal", (12, 0), "learnable", 2, 32),
    ("f32", "padding_causal", (10, 0), "learnable", 2, 32),
    ("bf16", "causal_bottom_right", (8, 0), "learnable", 2, 32),
    ("bf16", "padding_causal", (16, 0), "learnable", 8, 64),
]
# Relative to each output's largest |ref|. f32: both sides compute in f32
# and differ in summation order (readings below 6e-7). bf16: O and the
# gradients are rounded to bf16, and p and ds round to bf16 from f32
# scores summed in other orders, a few of them one ulp (2^-8) apart
# (readings below 4.9e-3; dsink below 1.1e-3), as the unbanded
# backward's test holds them.
_RTOL = {"f32": 1e-5, "bf16": 2 ** -6}
_LENS = np.array([40, 23], np.int32)


def _case(idx):
    dtype, mask, window, sink, group, d = _CASES[idx]
    rng = np.random.default_rng(100 + idx)
    b, hkv = 2, 2 if group == 2 else 1
    hq = hkv * group
    sq, skv = (24, 40) if mask == "causal_bottom_right" else (40, 40)
    q = _pair(rng.standard_normal((b, sq, hq, d)), dtype)
    k = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    v = _pair(rng.standard_normal((b, skv, hkv, d)), dtype)
    do = _pair(rng.standard_normal((b, sq, hq, d)), dtype)
    offset = rng.standard_normal(hq).astype(np.float32) * 2
    return dtype, mask, window, sink, (q, k, v, do), offset


def _descs(mask):
    if mask != "padding_causal":
        return None, None
    return (JDesc.from_seqlens(jnp.asarray(_LENS)),
            SequenceDescriptor.from_seqlens(torch.from_numpy(_LENS)))


@pytest.mark.parametrize("idx", range(len(_CASES)))
def test_flash_window_sink_matches_pallas_vjp(idx):
    """O, dQ, dK, dV and dsink of the port's flash attention (its plain
    versions on the CPU) against the Pallas kernel in interpret mode and
    its jax.vjp, with S = 40 over 16-row blocks."""
    dtype, mask, window, sink, tensors, offset = _case(idx)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = tensors
    desc_j, desc_t = _descs(mask)
    stype = sink and SoftmaxType(sink)
    jtype = sink and JSoftmax(sink)
    offj = jnp.asarray(offset)
    offt = torch.from_numpy(offset).requires_grad_(sink == "learnable")

    def fj(q, k, v, off):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask(mask), window_size=window,
            softmax_type=jtype, softmax_offset=off, block_q=16, block_k=16)

    oj, vjp = jax.vjp(fj, qj, kj, vj, offj)
    grads_j = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    ot = flash_attention(qt, kt, vt, desc_t,
                         attn_mask_type=AttnMaskType(mask),
                         window_size=window, softmax_type=stype,
                         softmax_offset=offt)
    ot.backward(dot)
    tol = _RTOL[dtype]
    got = {"O": ot, "dq": qt.grad, "dk": kt.grad, "dv": vt.grad}
    ref = {"O": oj, "dq": grads_j[0], "dk": grads_j[1], "dv": grads_j[2]}
    if sink == "learnable":
        got["dsink"], ref["dsink"] = offt.grad, grads_j[3]
    for name in got:
        assert got[name] is not None and got[name].shape == ref[name].shape
        r = _np(ref[name])
        np.testing.assert_allclose(_np(got[name]), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)
    if sink == "learnable":
        # The sink's gradient takes part: no head's is zero.
        assert float(offt.grad.abs().min()) > 0
    if mask == "padding_causal":
        # Padded query rows write O = 0 and get zero dQ; padded keys get
        # zero dK and dV.
        for t in (ot.detach(), qt.grad, kt.grad, vt.grad):
            assert float(t[1, 23:].abs().max()) == 0.0


@pytest.mark.parametrize("idx", [2, 4, 5])
def test_flash_window_sink_lse_matches_pallas(idx):
    """LSE of every row, padded rows included: a row with no visible key
    writes LSE = sink under a sink (-1e30 without one)."""
    dtype, mask, window, sink, tensors, offset = _case(idx)
    (qj, qt), (kj, kt), (vj, vt), _ = tensors
    b, sq, hq, d = qt.shape
    skv = kt.shape[1]
    lens = _LENS if mask == "padding_causal" else np.array([sq, sq])
    qseg = (np.arange(sq)[None] < lens[:, None]).astype(np.int32)
    kseg = (np.arange(skv)[None] < np.minimum(lens, skv)[:, None]).astype(
        np.int32)
    sink_v = offset if sink == "learnable" else np.zeros(hq, np.float32)
    off = skv - sq if mask == "causal_bottom_right" else 0
    scale = d ** -0.5
    _, lj = j_flash_fwd(
        qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
        vj.transpose(0, 2, 1, 3), jnp.asarray(qseg), jnp.asarray(kseg),
        jnp.zeros((1,), jnp.int32), scale=scale, causal=mask != "no_mask",
        window=window, offset=off, block_q=16, block_k=16,
        softmax_sink=jnp.asarray(sink_v))
    lt_lens = torch.from_numpy(lens.astype(np.int32))
    _, lt = flash_fwd(qt, kt, vt, lt_lens, lt_lens.clamp(max=skv),
                      scale=scale, causal=mask != "no_mask", offset=off,
                      window=window, softmax_sink=torch.from_numpy(sink_v))
    lj = _np(lj)[..., 0] if _np(lj).ndim == 4 else _np(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=1e-5)
    if mask == "padding_causal":
        # sink * log2(e) * ln(2): the sink within an f32 ulp or two.
        np.testing.assert_allclose(
            lt.numpy()[1, :, 23:],
            np.broadcast_to(sink_v[:, None], (hq, sq - 23)), rtol=3e-7)


def test_row_without_keys_writes_zero_and_sink_lse():
    """With the bottom-right offset and Sq > Skv the first rows see no
    key: O = 0 and LSE = -1e30 without a sink, LSE = sink with one, and
    those rows take no share of dsink."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 32)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(
        np.float32))
    sink = torch.tensor([0.5, -1.0])
    o, lse = flash_fwd(q, k, v, scale=0.2, causal=True, offset=-4,
                       window=(2, 0))
    assert float(o[0, :4].abs().max()) == 0.0
    assert bool((lse[0, :, :4] == NEG_INF).all())
    o, lse = flash_fwd(q, k, v, scale=0.2, causal=True, offset=-4,
                       window=(2, 0), softmax_sink=sink)
    assert float(o[0, :4].abs().max()) == 0.0
    torch.testing.assert_close(lse[0, :, :4], sink[:, None].expand(2, 4))


@pytest.mark.parametrize("window,sink", [((6, 0), None),
                                         ((5, 3), "off_by_one"),
                                         ((-1, -1), "learnable"),
                                         ((9, 0), "learnable")])
def test_unfused_window_sink_matches_reference(window, sink):
    """The unfused backend's band and sink column, forward and backward
    (autograd), against the reference's unfused backend differentiated
    by JAX, and the band mask itself against the reference's."""
    rng = np.random.default_rng(40 + window[0])
    b, s, hq, hkv, d = 2, 24, 4, 2, 32
    qj, qt = _pair(rng.standard_normal((b, s, hq, d)), "f32")
    kj, kt = _pair(rng.standard_normal((b, s, hkv, d)), "f32")
    vj, vt = _pair(rng.standard_normal((b, s, hkv, d)), "f32")
    doj, dot = _pair(rng.standard_normal((b, s, hq, d)), "f32")
    offset = rng.standard_normal(hq).astype(np.float32)
    lens = np.array([24, 15], np.int32)
    desc_j = JDesc.from_seqlens(jnp.asarray(lens))
    desc_t = SequenceDescriptor.from_seqlens(torch.from_numpy(lens))
    jtype = JSoftmax(sink) if sink else JSoftmax.VANILLA
    ttype = SoftmaxType(sink) if sink else SoftmaxType.VANILLA
    win = None if window == (-1, -1) else window

    def fj(q, k, v, off):
        return j_fused_attn(
            (q, k, v), sequence_descriptor=desc_j,
            attn_mask_type=JMask.PADDING_CAUSAL, window_size=win,
            softmax_type=jtype, softmax_offset=off, backend=JBackend.UNFUSED)

    oj, vjp = jax.vjp(fj, qj, kj, vj, jnp.asarray(offset))
    grads_j = vjp(doj)
    offt = torch.from_numpy(offset).requires_grad_(True)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    ot = fused_attn((qt, kt, vt), desc_t,
                    attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                    window_size=win, softmax_type=ttype, softmax_offset=offt,
                    backend=AttnBackend.UNFUSED)
    ot.backward(dot)
    # f32 on both sides; summation order alone differs (readings below
    # 1e-6 of the largest value).
    pairs = [("O", ot, oj), ("dq", qt.grad, grads_j[0]),
             ("dk", kt.grad, grads_j[1]), ("dv", vt.grad, grads_j[2])]
    if sink == "learnable":
        pairs.append(("dsink", offt.grad, grads_j[3]))
    for name, got, ref in pairs:
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    from transformerengine_tpu.attention import (
        make_attention_mask as j_make_attention_mask)
    mj = j_make_attention_mask(desc_j, JMask.PADDING_CAUSAL, s, s, b, win)
    mt = make_attention_mask(desc_t, AttnMaskType.PADDING_CAUSAL, s, s, b,
                             win)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_wrapper_arguments():
    """The window, the sink types, the q-position offset and a runtime
    window side are taken; score mods other than ALiBi and the soft cap,
    a window side or offset that is not an integer, and a learnable sink
    without its logits still raise; a bias is taken at its (B or 1, Hq,
    Sq, Skv) shape only."""
    q = torch.zeros((1, 8, 2, 32))
    k = v = torch.zeros((1, 8, 1, 32))
    flash_attention(q, k, v, attn_mask_type=AttnMaskType.CAUSAL,
                    window_size=(4, 0), softmax_type=SoftmaxType.OFF_BY_ONE)
    flash_attention(q, k, v, window_size=(2, 2),
                    softmax_type=SoftmaxType.LEARNABLE,
                    softmax_offset=torch.zeros(2))
    assert AttnSoftmaxType is SoftmaxType
    flash_attention(q, k, v, q_position_offset=3)
    flash_attention(q, k, v, q_position_offset=torch.tensor([3]))
    with pytest.raises(NotImplementedError, match="not ported"):
        flash_attention(q, k, v, score_mod=abs)
    # Dropout and the reference's tile sizes are taken; a rate needs a
    # seed, as in the reference.
    flash_attention(q, k, v, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_probability=0.1)
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, k, v, bias=q)
    flash_attention(q, k, v, window_size=(torch.tensor(4), 0))
    with pytest.raises(TypeError, match="window side"):
        flash_attention(q, k, v, window_size=(4.0, 0))
    with pytest.raises(ValueError, match="softmax_offset"):
        flash_attention(q, k, v, softmax_type=SoftmaxType.LEARNABLE)
    with pytest.raises(TypeError, match="unexpected"):
        flash_attention(q, k, v, window=(4, 0))
