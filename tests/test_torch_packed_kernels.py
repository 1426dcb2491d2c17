"""Segment ids (packed documents) in the port's flash attention and masks,
against the JAX package on the CPU: the plain forward and backward (O,
LSE, dQ, dK, dV and dsink) and the autograd functions against the Pallas
flash attention in interpret mode with
``SequenceDescriptor.from_segment_ids_and_pos`` and its ``jax.vjp``,
across f32 and bf16, contiguous and non-contiguous ids, an all-zero row,
no causal rule, the bottom-right offset, a window with a learnable sink,
the off-by-one sink, GQA groups of 4 and 8 and D 64, 128 and 256; the FP8
branches (``qkv_quantizers`` and ``mha_proj``) with ids; the wrapper's
rules (ids before lengths, ids checked); ``make_attention_mask`` with
ids and positions element for element, ``make_swa_mask``, and
``fused_attn`` / ``fused_attn_thd`` in each THD layout on both backends.

On CPU tensors each wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fp8_attention import (
    _j_current, _mha_quantizers, _t_current)
from transformerengine_tpu.attention import (
    AttnBackend as JBackend, AttnMaskType as JMask, QKVLayout as JLayout,
    SequenceDescriptor as JDesc, SoftmaxType as JSoftmax,
    fused_attn as j_fused_attn, make_attention_mask as j_make_mask,
    make_swa_mask as j_make_swa_mask)
from transformerengine_tpu.ops.flash_attention import (
    _flash_fwd as j_flash_fwd, flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import (
    AttnBackend, AttnMaskType, QKVFormat, QKVLayout, SequenceDescriptor,
    SoftmaxType, fused_attn, fused_attn_thd, get_attention_backend,
    make_attention_mask, make_swa_mask)
from transformerengine_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_bwd, flash_fwd)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCK = 16
# Relative to each output's largest |ref|, as the unpacked flash tests
# hold them: f32 differs in summation order alone (readings below 1e-6);
# bf16 O and gradients round to bf16, and p and ds round to bf16 from f32
# scores summed in other orders, a few of them one ulp (2^-8) apart.
_RTOL = {"f32": 1e-5, "bf16": 2 ** -6}
# LSE is f32 on both sides, summed in other orders.
LSE_ATOL = 1e-5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _ids(rng, b: int, s: int, kind: str) -> np.ndarray:
    """(B, S) int32 ids: "packed" (contiguous documents, then padding),
    "gaps" (drawn from 0-3 per token: documents that reappear after
    others, zeros among them) or "zero_row" (packed, row 1 all 0)."""
    if kind == "gaps":
        return rng.integers(0, 4, (b, s)).astype(np.int32)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s - 4), 2, replace=False))
        bounds = [0, *cuts, s - 4]
        for i in range(3):
            out[r, bounds[i]:bounds[i + 1]] = i + 1
    if kind == "zero_row":
        out[1] = 0
    return out


def _positions(ids: np.ndarray) -> np.ndarray:
    """Each token's position within its run of equal ids (0 on padding),
    what the packer emits."""
    pos = np.zeros_like(ids)
    for r in range(ids.shape[0]):
        for j in range(1, ids.shape[1]):
            if ids[r, j] != 0 and ids[r, j] == ids[r, j - 1]:
                pos[r, j] = pos[r, j - 1] + 1
    return pos


# (dtype, mask, Sq, Skv, GQA group, D, window, sink, ids)
_CASES = {
    "f32_packed": ("f32", "padding_causal", 48, 48, 2, 32, None, None,
                   "packed"),
    "bf16_gaps": ("bf16", "padding_causal", 48, 48, 2, 32, None, None,
                  "gaps"),
    "zero_row_gqa8_d128": ("bf16", "padding_causal", 48, 48, 8, 128, None,
                           None, "zero_row"),
    "window_sink": ("bf16", "padding_causal", 48, 48, 2, 64, (10, 0),
                    "learnable", "packed"),
    "gqa4_off_by_one": ("bf16", "padding_causal", 48, 48, 4, 64, None,
                        "off_by_one", "gaps"),
    "no_causal_d256": ("f32", "padding", 32, 32, 2, 256, None, None,
                       "gaps"),
    "bottom_right": ("bf16", "padding_causal_bottom_right", 32, 48, 2, 32,
                     None, "learnable", "packed"),
}


def _case(name):
    dtype, mask, sq, skv, group, d, window, sink, kind = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 200)
    b, hkv = 2, 2 if group == 2 else 1
    hq = hkv * group
    kv_ids = _ids(rng, b, skv, kind)
    # The bottom-right offset: the queries are the last Sq tokens.
    q_ids = np.ascontiguousarray(kv_ids[:, skv - sq:])
    tensors = [_pair(rng.standard_normal(shape), dtype) for shape in
               ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                (b, sq, hq, d))]
    offset = (rng.standard_normal(hq) * 2).astype(np.float32)
    return dict(dtype=dtype, mask=mask, window=window, sink=sink,
                q_ids=q_ids, kv_ids=kv_ids, tensors=tensors, offset=offset,
                scale=d ** -0.5)


def _descs(c):
    qi, ki = c["q_ids"], c["kv_ids"]
    return (JDesc.from_segment_ids_and_pos(jnp.asarray(qi), jnp.asarray(ki)),
            SequenceDescriptor.from_segment_ids_and_pos(
                torch.from_numpy(qi), torch.from_numpy(ki)))


@pytest.mark.parametrize("name", list(_CASES))
def test_packed_flash_matches_pallas_vjp(name):
    """O, dQ, dK, dV and dsink of ``flash_attention`` with a segment
    descriptor against the Pallas kernel in interpret mode and its
    jax.vjp; queries with id 0 write O = 0 and get dQ = 0, keys with id
    0 get dK = dV = 0."""
    c = _case(name)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = c["tensors"]
    desc_j, desc_t = _descs(c)
    sink = c["sink"]
    offj = jnp.asarray(c["offset"])
    offt = torch.from_numpy(c["offset"]).requires_grad_(sink == "learnable")

    def fj(q, k, v, off):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask(c["mask"]),
            window_size=c["window"], softmax_type=sink and JSoftmax(sink),
            softmax_offset=off, block_q=BLOCK, block_k=BLOCK)

    oj, vjp = jax.vjp(fj, qj, kj, vj, offj)
    grads_j = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    ot = flash_attention(qt, kt, vt, desc_t,
                         attn_mask_type=AttnMaskType(c["mask"]),
                         window_size=c["window"],
                         softmax_type=sink and SoftmaxType(sink),
                         softmax_offset=offt)
    ot.backward(dot)
    got = {"O": ot, "dq": qt.grad, "dk": kt.grad, "dv": vt.grad}
    ref = {"O": oj, "dq": grads_j[0], "dk": grads_j[1], "dv": grads_j[2]}
    if sink == "learnable":
        got["dsink"], ref["dsink"] = offt.grad, grads_j[3]
    tol = _RTOL[c["dtype"]]
    for key in got:
        assert got[key] is not None and got[key].shape == ref[key].shape
        r = _np(ref[key])
        np.testing.assert_allclose(_np(got[key]), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=key)
    qzero = torch.from_numpy(c["q_ids"] == 0)
    kzero = torch.from_numpy(c["kv_ids"] == 0)
    assert bool(qzero.any()) and bool(kzero.any())
    for t, zero in ((ot.detach(), qzero), (qt.grad, qzero), (kt.grad, kzero),
                    (vt.grad, kzero)):
        assert float(t[zero].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["f32_packed", "window_sink", "bottom_right",
                                  "no_causal_d256"])
def test_packed_flash_lse_matches_pallas(name):
    """LSE of every row: -1e30 for a query with id 0, the sink with
    one."""
    c = _case(name)
    (qj, qt), (kj, kt), (vj, vt), _ = c["tensors"]
    hq = qt.shape[2]
    mask = AttnMaskType(c["mask"])
    off = kt.shape[1] - qt.shape[1] if mask.is_bottom_right else 0
    sink = c["sink"]
    sink_v = c["offset"] if sink else None
    _, lj = j_flash_fwd(
        qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
        vj.transpose(0, 2, 1, 3), jnp.asarray(c["q_ids"]),
        jnp.asarray(c["kv_ids"]), jnp.zeros((1,), jnp.int32),
        scale=c["scale"], causal=mask.is_causal,
        window=c["window"] or (-1, -1), offset=off, block_q=BLOCK,
        block_k=BLOCK,
        softmax_sink=None if sink is None else jnp.asarray(sink_v))
    _, lt = flash_fwd(qt, kt, vt, scale=c["scale"], causal=mask.is_causal,
                      offset=off, window=c["window"],
                      softmax_sink=(None if sink is None
                                    else torch.from_numpy(sink_v)),
                      q_segment_ids=torch.from_numpy(c["q_ids"]),
                      kv_segment_ids=torch.from_numpy(c["kv_ids"]))
    lj = _np(lj)[..., 0] if _np(lj).ndim == 4 else _np(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=LSE_ATOL)
    zero = c["q_ids"] == 0
    rows = lt.numpy().transpose(0, 2, 1)[zero]
    if sink is None:
        assert bool((rows == NEG_INF).all())
    else:
        np.testing.assert_allclose(
            rows, np.broadcast_to(sink_v, rows.shape), rtol=3e-7)


def test_ids_are_an_equality_rule():
    """A document that reappears after another's tokens attends across
    the gap: the ids [1 1 2 2 1 1] give the last two queries the keys 0,
    1, 4 and 5, and relabelling the ids leaves O unchanged."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 16)).astype(
        np.float32)) for _ in range(3))
    ids = torch.tensor([[1, 1, 2, 2, 1, 1]])
    o, _ = flash_fwd(q, k, v, scale=0.25, causal=True, q_segment_ids=ids,
                     kv_segment_ids=ids)
    keep = [0, 1, 4, 5]
    o_sub, _ = flash_fwd(q[:, keep], k[:, keep], v[:, keep], scale=0.25,
                         causal=True)
    torch.testing.assert_close(o[:, [4, 5]], o_sub[:, [2, 3]], rtol=0,
                               atol=1e-6)
    relabelled = torch.tensor([[7, 7, 3, 3, 7, 7]])
    o2, _ = flash_fwd(q, k, v, scale=0.25, causal=True,
                      q_segment_ids=relabelled, kv_segment_ids=relabelled)
    assert torch.equal(o, o2)


def test_bwd_plain_with_ids_matches_autograd_of_unfused():
    """flash_bwd with ids against autograd through the unfused backend
    (f32): the backward's mask is the forward's."""
    c = _case("f32_packed")
    (_, q), (_, k), (_, v), (_, do) = c["tensors"]
    ids = dict(q_segment_ids=torch.from_numpy(c["q_ids"]),
               kv_segment_ids=torch.from_numpy(c["kv_ids"]))
    o, lse = flash_fwd(q, k, v, scale=c["scale"], causal=True, **ids)
    got = flash_bwd(q, k, v, o, lse, do, scale=c["scale"], causal=True, **ids)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _, desc = _descs(c)
    out = fused_attn(leaves, desc, attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                     backend=AttnBackend.UNFUSED)
    out.backward(do)
    for a, leaf in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=1e-5 * float(leaf.grad.abs().max()))


def _fp8_case(kind: str):
    rng = np.random.default_rng(300 if kind == "gaps" else 301)
    b, s, hq, hkv, d = 2, 48, 4, 2, 64
    tensors = [_pair(rng.standard_normal(shape), "bf16") for shape in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    ids = _ids(rng, b, s, kind)
    return rng, tensors, ids


@pytest.mark.parametrize("kind,window,sink", [("gaps", None, False),
                                              ("packed", (12, 0), True)])
def test_packed_fp8_dpa_matches_reference_vjp(kind, window, sink):
    """``flash_attention(qkv_quantizers=...)`` with ids: O, dQ, dK, dV
    (and dsink) against the reference's jax.vjp."""
    rng, ((qj, qt), (kj, kt), (vj, vt)), ids = _fp8_case(kind)
    desc_j = JDesc.from_segment_ids_and_pos(jnp.asarray(ids))
    desc_t = SequenceDescriptor.from_segment_ids_and_pos(
        torch.from_numpy(ids))
    off = (rng.standard_normal(qt.shape[2]) * 2).astype(np.float32)

    def fj(q, k, v, o):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask.PADDING_CAUSAL,
            window_size=window,
            qkv_quantizers=tuple(_j_current() for _ in range(3)),
            softmax_type=JSoftmax.LEARNABLE if sink else None,
            softmax_offset=o if sink else None, block_q=BLOCK,
            block_k=BLOCK)

    oj, vjp = jax.vjp(fj, qj, kj, vj, jnp.asarray(off))
    doj, dot = _pair(rng.standard_normal(qt.shape), "bf16")
    grads_j = vjp(doj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    offt = torch.from_numpy(off).requires_grad_(True) if sink else None
    ot = flash_attention(*leaves, desc_t,
                         attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                         window_size=window,
                         qkv_quantizers=[_t_current() for _ in range(3)],
                         softmax_type=SoftmaxType.LEARNABLE if sink else None,
                         softmax_offset=offt)
    ot.backward(dot)
    pairs = [("O", ot, oj)] + [(n, leaf.grad, g) for n, leaf, g in
                               zip(("dQ", "dK", "dV"), leaves, grads_j)]
    if sink:
        pairs.append(("dsink", offt.grad, grads_j[3]))
    for name, a, r in pairs:
        r = _np(r)
        np.testing.assert_allclose(_np(a), r, rtol=0,
                                   atol=_RTOL["bf16"] * np.abs(r).max(),
                                   err_msg=name)
    assert float(ot.detach()[torch.from_numpy(ids == 0)].abs().max()) == 0.0


@pytest.mark.parametrize("recipe", ["delayed", "current"])
def test_packed_fp8_mha_matches_reference_vjp(recipe):
    """``flash_attention(mha_proj=...)`` with ids: the projected output,
    dQ, dK, dV and dW against the reference's jax.vjp, after a warm-up
    step under delayed scaling, as the FP8-attention tests hold them."""
    rng, ((qj, qt), (kj, kt), (vj, vt)), ids = _fp8_case("packed")
    desc_j = JDesc.from_segment_ids_and_pos(jnp.asarray(ids))
    desc_t = SequenceDescriptor.from_segment_ids_and_pos(
        torch.from_numpy(ids))
    hq, d, n = qt.shape[2], qt.shape[3], 96
    wj, wt = _pair(rng.standard_normal((hq * d, n)) / np.sqrt(hq * d), "bf16")
    gj, gt = _pair(rng.standard_normal((2, 48, n)), "bf16")

    def run_j(state):
        jq, _ = _mha_quantizers(recipe, state)

        def fj(q, k, v, w, quantizers):
            return j_flash_attention(
                q, k, v, desc_j, attn_mask_type=JMask.PADDING_CAUSAL,
                mha_proj=(w, quantizers), block_q=BLOCK, block_k=BLOCK)
        out, vjp = jax.vjp(fj, qj, kj, vj, wj, jq)
        return out, vjp(gj)

    state = [(np.ones(1, np.float32), np.zeros(8, np.float32))] * 4
    if recipe == "delayed":
        upd = run_j(state)[1][4]
        state = [(np.asarray(z.scale, np.float32),
                  np.asarray(z.amax_history, np.float32)) for z in upd[3:]]
    out_j, grads_j = run_j(state)
    _, tq = _mha_quantizers(recipe, state)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt, wt)]
    out_t = flash_attention(*leaves[:3], desc_t,
                            attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                            mha_proj=(leaves[3], tq))
    out_t.backward(gt)
    # dW contracts the fp8 O payload, whose codes move by a step where
    # the f32 O sums in another order (the FP8-attention tests' DW_RTOL).
    for name, a, r, tol in zip(
            ("out", "dQ", "dK", "dV", "dW"),
            (out_t, *(leaf.grad for leaf in leaves)),
            (out_j, *grads_j[:4]), (2 ** -6,) * 4 + (2 ** -5,)):
        r = _np(r)
        np.testing.assert_allclose(_np(a), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)


def test_wrapper_takes_ids_before_lengths_and_checks_them():
    """A descriptor with ids and lengths masks by the ids (as the
    reference's wrapper); flash_fwd takes ids or lengths, both sides' ids
    or neither, and ids of the inputs' (B, S)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(
        np.float32)) for _ in range(3))
    ids = torch.from_numpy(_ids(rng, 2, 32, "gaps"))
    lens = torch.tensor([32, 5], dtype=torch.int32)
    both = SequenceDescriptor(q_seqlens=lens, kv_seqlens=lens,
                              q_segment_ids=ids, kv_segment_ids=ids)
    o = flash_attention(q, k, v, both,
                        attn_mask_type=AttnMaskType.PADDING_CAUSAL)
    o_ids, _ = flash_fwd(q, k, v, scale=0.25, causal=True,
                         q_segment_ids=ids, kv_segment_ids=ids)
    assert torch.equal(o, o_ids)
    with pytest.raises(ValueError, match="not both"):
        flash_fwd(q, k, v, lens, lens, scale=0.25, causal=True,
                  q_segment_ids=ids, kv_segment_ids=ids)
    with pytest.raises(ValueError, match="or neither"):
        flash_fwd(q, k, v, scale=0.25, causal=True, q_segment_ids=ids)
    with pytest.raises(ValueError, match="segment ids must be"):
        flash_fwd(q, k, v, scale=0.25, causal=True,
                  q_segment_ids=ids[:, :16], kv_segment_ids=ids)
    assert get_attention_backend(head_dim=16) is AttnBackend.FLASH


@pytest.mark.parametrize("mask,positions,window", [
    ("padding_causal", False, None), ("padding_causal", True, None),
    ("padding_causal_bottom_right", False, None),
    ("padding_causal_bottom_right", True, (3, 0)),
    ("padding", True, (4, 2)), ("no_mask", False, (5, -1))])
def test_make_attention_mask_with_ids_matches_reference(mask, positions,
                                                        window):
    """The unfused backend's mask from ids and, where given, positions,
    element for element against the reference's (causal and window on
    the positions, the bottom-right offset only without them)."""
    rng = np.random.default_rng(21)
    kv_ids = _ids(rng, 2, 24, "gaps")
    q_ids = kv_ids[:, 8:] if "bottom_right" in mask else kv_ids
    kw_j, kw_t = {}, {}
    if positions:
        kw_j = dict(q_segment_pos=jnp.asarray(_positions(q_ids)),
                    kv_segment_pos=jnp.asarray(_positions(kv_ids)))
        kw_t = dict(q_segment_pos=torch.from_numpy(_positions(q_ids)),
                    kv_segment_pos=torch.from_numpy(_positions(kv_ids)))
    desc_j = JDesc.from_segment_ids_and_pos(jnp.asarray(q_ids),
                                            jnp.asarray(kv_ids), **kw_j)
    desc_t = SequenceDescriptor.from_segment_ids_and_pos(
        torch.from_numpy(q_ids), torch.from_numpy(kv_ids), **kw_t)
    sq, skv = q_ids.shape[1], kv_ids.shape[1]
    mj = np.asarray(j_make_mask(desc_j, JMask(mask), sq, skv, 2, window))
    mt = make_attention_mask(desc_t, AttnMaskType(mask), sq, skv, 2, window)
    assert mt.dtype == torch.bool and mt.shape == (2, 1, sq, skv)
    np.testing.assert_array_equal(mt.numpy(), mj)


def test_make_swa_mask_matches_reference():
    rng = np.random.default_rng(22)
    pos = _positions(_ids(rng, 2, 20, "packed"))
    for window in (None, (3, 0), (2, 5), (-1, 4)):
        mj = np.asarray(j_make_swa_mask(jnp.asarray(pos), jnp.asarray(pos),
                                        window))
        mt = make_swa_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                           window)
        np.testing.assert_array_equal(mt.numpy(), mj)


def _layout_inputs(layout, q, k, v):
    if layout.is_qkvpacked:
        return (np.stack([q, k, v], axis=2),)
    if layout.is_kvpacked:
        return (q, np.stack([k, v], axis=2))
    return (q, k, v)


@pytest.mark.parametrize("backend", ["flash", "unfused"])
@pytest.mark.parametrize("layout", ["t3hd", "thd_t2hd", "thd_thd_thd"])
def test_fused_attn_thd_matches_reference(layout, backend):
    """``fused_attn_thd`` (and ``fused_attn`` with the same layout) on a
    packed batch with ids and positions, against the reference's
    ``fused_attn`` with the same layout and backend (f32)."""
    rng = np.random.default_rng(23)
    b, s, h, d = 2, 48, 2, 32
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ids = _ids(rng, b, s, "packed")
    pos = _positions(ids)
    lay_j, lay_t = JLayout(layout), QKVLayout(layout)
    assert lay_t.get_qkv_format() is QKVFormat.THD
    inputs = _layout_inputs(lay_t, q, k, v)
    desc_j = JDesc.from_segment_ids_and_pos(
        jnp.asarray(ids), jnp.asarray(ids), jnp.asarray(pos),
        jnp.asarray(pos))
    desc_t = SequenceDescriptor.from_segment_ids_and_pos(
        torch.from_numpy(ids), torch.from_numpy(ids), torch.from_numpy(pos),
        torch.from_numpy(pos))
    oj = j_fused_attn(tuple(jnp.asarray(x) for x in inputs),
                      sequence_descriptor=desc_j,
                      attn_mask_type=JMask.PADDING_CAUSAL, qkv_layout=lay_j,
                      backend=JBackend(backend))
    tin = tuple(torch.from_numpy(x) for x in inputs)
    ot = fused_attn_thd(tin, desc_t, qkv_layout=lay_t,
                        attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                        backend=AttnBackend(backend))
    np.testing.assert_allclose(ot.numpy(), _np(oj), rtol=0,
                               atol=1e-5 * np.abs(_np(oj)).max())
    o2 = fused_attn(tin, desc_t, qkv_layout=lay_t,
                    attn_mask_type=AttnMaskType.PADDING_CAUSAL,
                    backend=AttnBackend(backend))
    assert torch.equal(ot, o2)


def test_fused_attn_thd_refuses_a_bshd_layout():
    x = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="THD layout"):
        fused_attn_thd((x, x, x), qkv_layout=QKVLayout.BSHD_BSHD_BSHD)
