"""Attention dropout in the port's flash attention, against the JAX
package on the CPU: the plain keep mask ``dropout_keep`` bit for bit
against the reference's ``_dropout_keep`` (its off-TPU hash), assembled
tile by tile over the reference's own tiles, across GQA groups, padded
lengths, small explicit tiles, seed words of 2^31 and above and a
threshold that is a rounding tie; then ``flash_attention`` with
``dropout_probability`` and its backward against the Pallas flash
attention in interpret mode and its ``jax.vjp`` (O, dQ, dK, dV, dbias and
dsink), and LSE against ``_flash_fwd``, under causal, padding, segment
ids, a bias, ALiBi and a window with a sink, in f32 and bf16. Rate 0 is
the dropout-free path, another seed word moves O beyond the tolerance,
and the refusals follow the reference.

On CPU tensors each wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.attention import (
    AttnMaskType as JMask, SequenceDescriptor as JDesc,
    SoftmaxType as JSoftmax)
from transformerengine_tpu.flex_attention import (
    alibi_arith_mod as j_alibi_arith_mod)
from transformerengine_tpu.ops.flash_attention import (
    _dropout_keep as j_dropout_keep, _effective_blocks as j_effective_blocks,
    _flash_fwd as j_flash_fwd, flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor, SoftmaxType)
from transformerengine_tpu_torch.flex_attention import alibi_arith_mod
from transformerengine_tpu_torch.ops.flash_attention import (
    Dropout, _effective_blocks, dropout_keep, dropout_seed, flash_attention,
    flash_bwd, flash_fwd)
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
# The reference's tiles of the flash cases: 32 queries by 64 keys, so a
# 96-token sequence spans three query tiles and two key tiles.
BLOCK_Q, BLOCK_K = 32, 64
# Relative to each output's largest |ref|, as the bias and training flash
# tests hold them: f32 differs in summation order alone; bf16 O and
# gradients round to bf16 from f32 scores summed in other orders (the
# masks are equal bit for bit, so dropout adds no difference of its own).
_RTOL = {"f32": 1e-5, "bf16": 2 ** -6}
LSE_ATOL = 1e-5
# Seed words as the reference reads them: int32, the first >= 2^31 as
# uint32.
SEED = np.array([0x9ABCDEF0 - 2 ** 32, 0x13579BDF], np.int32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _reference_keep(seed, b, hq, hkv, sq, skv, rate, block_q, block_k):
    """The reference's mask (B, Hq, Sq, Skv), assembled from
    ``_dropout_keep`` over its own tiles of the padded lengths, each
    tile's rows packed by GQA group."""
    g = hq // hkv
    bq, bk = j_effective_blocks(sq, skv, g, block_q, block_k)
    sq_p, skv_p = -(-sq // bq) * bq, -(-skv // bk) * bk
    out = np.zeros((b, hkv, g, sq_p, skv_p), bool)
    seed_j = jnp.asarray(seed, jnp.int32)
    for bi in range(b):
        for hk in range(hkv):
            for q0 in range(0, sq_p, bq):
                for k0 in range(0, skv_p, bk):
                    tile = np.asarray(j_dropout_keep(
                        seed_j, q0, k0, g * bq, bk, rate, (bi, hk)))
                    out[bi, hk, :, q0:q0 + bq, k0:k0 + bk] = tile.reshape(
                        g, bq, bk)
    return out[..., :sq, :skv].reshape(b, hq, sq, skv)


# (B, Hq, Hkv, Sq, Skv, rate, block_q, block_k, seed)
_KEEP_CASES = {
    "group1": (2, 4, 4, 40, 40, 0.1, 16, 16, SEED),
    "group2_padded": (2, 8, 4, 50, 70, 0.3, 16, 32, SEED),
    "group4_small_tiles": (1, 8, 2, 48, 40, 0.25, 8, 16, SEED),
    "group4_default_tiles_cap": (1, 16, 4, 300, 200, 0.1, 512, 1024,
                                 np.array([7, -9], np.int32)),
    "high_seed_words": (2, 4, 2, 33, 47, 0.5, 16, 16,
                        np.array([-1, -(2 ** 31)], np.int32)),
    # rate * 2^32 = 2^31 + 0.5: Python's round takes the even 2^31.
    "threshold_tie": (1, 4, 2, 24, 24, 0.5 + 2.0 ** -33, 8, 8, SEED),
}


@pytest.mark.parametrize("name", list(_KEEP_CASES))
def test_dropout_keep_matches_the_reference_bit_for_bit(name):
    b, hq, hkv, sq, skv, rate, bq, bk, seed = _KEEP_CASES[name]
    got = dropout_keep(torch.from_numpy(seed), b, hq, hkv, sq, skv, rate, bq,
                       bk)
    ref = _reference_keep(seed, b, hq, hkv, sq, skv, rate, bq, bk)
    assert got.dtype == torch.bool and got.shape == (b, hq, sq, skv)
    assert np.array_equal(got.numpy(), ref)
    assert _effective_blocks(sq, skv, hq // hkv, bq, bk) == \
        j_effective_blocks(sq, skv, hq // hkv, bq, bk)
    # The keep share is 1 - rate within a binomial bound of 5 sigma.
    n = ref.size
    assert abs(ref.mean() - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    if name == "threshold_tie":
        assert Dropout(torch.from_numpy(seed), rate).threshold == 2 ** 31
    if name == "group4_default_tiles_cap":
        # GQA 4 caps the packed rows at MAX_ROWS: tiles of 256 x 200.
        assert _effective_blocks(sq, skv, 4, bq, bk) == (256, 200)


def test_dropout_seed_takes_the_references_words():
    """A jax key's data (uint32 words) and a (2,) int32 seed give the same
    words; int64 words of 2^31 and above wrap to int32, as the reference's
    int32 cast does, and a single word is zero-padded."""
    key = jax.random.PRNGKey(2 ** 32 - 5)
    words = np.asarray(jax.random.key_data(key))
    as_int32 = np.asarray(jnp.asarray(words).astype(jnp.int32))
    got = dropout_seed(torch.from_numpy(words.astype(np.int64)))
    assert got.dtype == torch.int32 and got.tolist() == as_int32.tolist()
    assert dropout_seed([0x9ABCDEF0, 5]).tolist() == [0x9ABCDEF0 - 2 ** 32, 5]
    assert dropout_seed(torch.tensor([3])).tolist() == [3, 0]
    with pytest.raises(TypeError, match="integers"):
        dropout_seed(torch.zeros(2))


# (dtype, mask, lengths or ids, window, sink, term, rate)
_CASES = {
    "f32_causal": ("f32", "causal", None, None, None, None, 0.1),
    "bf16_causal": ("bf16", "causal", None, None, None, None, 0.1),
    "bf16_padding": ("bf16", "padding", (96, 50), None, None, None, 0.2),
    "f32_segments": ("f32", "padding_causal", "segments", None, None, None,
                     0.3),
    "bf16_bias_dbias": ("bf16", "padding", (96, 61), None, None, "bias",
                        0.1),
    "f32_alibi": ("f32", "causal", None, None, None, "alibi", 0.25),
    "bf16_window_sink": ("bf16", "causal", None, (40, 0), "learnable",
                         None, 0.1),
}
SEQ, HQ, HKV, D = 96, 4, 2, 64


def _case(name):
    dtype, mask, masks, window, sink, term, rate = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 700)
    b = 2
    tensors = [_pair(rng.standard_normal(shape), dtype) for shape in
               ((b, SEQ, HQ, D), (b, SEQ, HKV, D), (b, SEQ, HKV, D),
                (b, SEQ, HQ, D))]
    bias = (_pair(rng.standard_normal((1, HQ, SEQ, SEQ)) * 2, "f32")
            if term == "bias" else None)
    offset = (rng.standard_normal(HQ) * 2).astype(np.float32)
    if masks == "segments":
        ids = np.repeat(np.array([[1, 2, 3, 0], [1, 1, 2, 0]], np.int32),
                        SEQ // 4, axis=1)
        descs = (JDesc.from_segment_ids_and_pos(jnp.asarray(ids)),
                 SequenceDescriptor.from_segment_ids_and_pos(
                     torch.from_numpy(ids)))
    elif masks is not None:
        lens = np.asarray(masks, np.int32)
        descs = (JDesc.from_seqlens(jnp.asarray(lens)),
                 SequenceDescriptor.from_seqlens(torch.from_numpy(lens)))
    else:
        descs = (None, None)
    return dict(dtype=dtype, mask=mask, window=window, sink=sink, term=term,
                rate=rate, tensors=tensors, bias=bias, offset=offset,
                descs=descs)


def _run_both(c, seed=SEED, rate=None):
    """(got, ref): O and the gradients of the port's and the reference's
    flash_attention with dropout on the same seed words."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = c["tensors"]
    desc_j, desc_t = c["descs"]
    rate = c["rate"] if rate is None else rate
    sink, alibi = c["sink"], c["term"] == "alibi"
    bj, bt = c["bias"] if c["bias"] is not None else (None, None)
    offj = jnp.asarray(c["offset"])
    offt = torch.from_numpy(c["offset"]).requires_grad_(sink == "learnable")

    def fj(q, k, v, off, bias):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask(c["mask"]),
            window_size=c["window"], bias=bias,
            score_mod=j_alibi_arith_mod(HQ) if alibi else None,
            softmax_type=sink and JSoftmax(sink), softmax_offset=off,
            dropout_probability=rate, dropout_seed=jnp.asarray(seed),
            block_q=BLOCK_Q, block_k=BLOCK_K)

    oj, vjp = jax.vjp(fj, qj, kj, vj, offj, bj)
    grads_j = vjp(doj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    bt = bt.clone().requires_grad_(True) if bt is not None else None
    ot = flash_attention(*leaves, desc_t,
                         attn_mask_type=AttnMaskType(c["mask"]),
                         window_size=c["window"], bias=bt,
                         score_mod=alibi_arith_mod(HQ) if alibi else None,
                         softmax_type=sink and SoftmaxType(sink),
                         softmax_offset=offt, dropout_probability=rate,
                         dropout_seed=torch.from_numpy(seed),
                         block_q=BLOCK_Q, block_k=BLOCK_K)
    ot.backward(dot)
    got = {"O": ot, "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}
    ref = {"O": oj, "dq": grads_j[0], "dk": grads_j[1], "dv": grads_j[2]}
    if sink == "learnable":
        got["dsink"], ref["dsink"] = offt.grad, grads_j[3]
    if bt is not None:
        got["dbias"], ref["dbias"] = bt.grad, grads_j[4]
    return got, ref


@pytest.mark.parametrize("name", list(_CASES))
def test_dropout_flash_matches_pallas_vjp(name):
    """O, dQ, dK, dV (and dbias, dsink) with dropout against the Pallas
    kernel in interpret mode and its jax.vjp on the same seed words."""
    c = _case(name)
    got, ref = _run_both(c)
    tol = _RTOL[c["dtype"]]
    for key in got:
        assert got[key] is not None and got[key].shape == ref[key].shape
        r = _np(ref[key])
        np.testing.assert_allclose(_np(got[key]), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=key)


def test_another_seed_word_moves_the_output():
    """The test has teeth: with the second seed word changed by one, O
    differs from the reference's beyond the tolerance."""
    c = _case("bf16_causal")
    other = SEED.copy()
    other[1] += 1
    (qj, qt), (kj, kt), (vj, vt), _ = c["tensors"]
    oj = j_flash_attention(qj, kj, vj, attn_mask_type=JMask.CAUSAL,
                           dropout_probability=c["rate"],
                           dropout_seed=jnp.asarray(SEED), block_q=BLOCK_Q,
                           block_k=BLOCK_K)
    ot = flash_attention(qt, kt, vt, attn_mask_type=AttnMaskType.CAUSAL,
                         dropout_probability=c["rate"],
                         dropout_seed=torch.from_numpy(other),
                         block_q=BLOCK_Q, block_k=BLOCK_K)
    r = _np(oj)
    assert np.abs(_np(ot) - r).max() > 8 * _RTOL["bf16"] * np.abs(r).max()


def test_dropout_lse_matches_pallas():
    """LSE under dropout against ``_flash_fwd`` (the denominator sums the
    undropped weights, so it is the dropout-free LSE)."""
    c = _case("f32_alibi")
    (qj, qt), (kj, kt), (vj, vt), _ = c["tensors"]
    bhsd = lambda x: x.transpose(0, 2, 1, 3)
    _, lj = j_flash_fwd(
        bhsd(qj), bhsd(kj), bhsd(vj), None, None, jnp.zeros((1,), jnp.int32),
        scale=D ** -0.5, causal=True, window=(-1, -1), offset=0,
        block_q=BLOCK_Q, block_k=BLOCK_K, dropout_rate=c["rate"],
        dropout_seed=jnp.asarray(SEED), score_mod=j_alibi_arith_mod(HQ))
    from transformerengine_tpu_torch.flex_attention import AlibiMod
    kw = dict(scale=D ** -0.5, causal=True, score_mod=AlibiMod(HQ))
    _, lt = flash_fwd(qt, kt, vt, dropout_probability=c["rate"],
                      dropout_seed=torch.from_numpy(SEED), block_q=BLOCK_Q,
                      block_k=BLOCK_K, **kw)
    _, l0 = flash_fwd(qt, kt, vt, **kw)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-5, atol=LSE_ATOL)
    assert torch.equal(lt, l0)


def test_rate_zero_is_the_dropout_free_path():
    """Rate 0, with or without a seed, gives exactly the dropout-free O
    and gradients, and needs no seed."""
    c = _case("bf16_padding")
    (_, qt), (_, kt), (_, vt), (_, dot) = c["tensors"]
    desc = c["descs"][1]
    outs = []
    for kw in ({}, dict(dropout_probability=0.0),
               dict(dropout_probability=0.0,
                    dropout_seed=torch.from_numpy(SEED))):
        leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
        o = flash_attention(*leaves, desc, attn_mask_type=AttnMaskType.PADDING,
                            **kw)
        o.backward(dot)
        outs.append([o.detach()] + [t.grad for t in leaves])
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def _current():
    return CurrentScaleQuantizer(torch.float8_e4m3fn, QuantizeLayout.ROWWISE)


def test_refusals_follow_the_reference():
    """A rate without a seed raises as the reference's wrapper does, FP8
    Q/K/V included; FP8 Q/K/V take dropout (``qkv_quantizers``,
    ``mha_proj``, the wrappers' ``scale_invs``: tests/
    test_torch_fp8_dropout.py holds them to the reference) and its seed
    moves their output; a rate outside [0, 1) raises."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((1, 16, 4, 32), (1, 16, 2, 32),
                                             (1, 16, 2, 32)))
    seed = torch.from_numpy(SEED)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_probability=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_fwd(q, k, v, scale=0.2, causal=True, dropout_probability=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, qkv_quantizers=[_current() for _ in range(3)],
                        dropout_probability=0.1)
    outs = [flash_attention(q, k, v,
                            qkv_quantizers=[_current() for _ in range(3)],
                            dropout_probability=0.1, dropout_seed=s)
            for s in (seed, seed + 1)]
    assert not torch.equal(*outs)
    w = torch.zeros((128, 64), dtype=torch.bfloat16)
    assert flash_attention(q, k, v, mha_proj=(w, [_current()] * 7),
                           dropout_probability=0.1,
                           dropout_seed=seed).shape == (1, 16, 64)
    e4m3 = [t.to(torch.float8_e4m3fn) for t in (q, k, v)]
    o8, _ = flash_fwd(*e4m3, scale=0.2, causal=True, scale_invs=torch.ones(3),
                      dropout_probability=0.1, dropout_seed=seed)
    assert o8.dtype == torch.bfloat16
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            flash_attention(q, k, v, dropout_probability=rate,
                            dropout_seed=seed)
    # The backward takes the forward's seed and replays its mask: its
    # gradients move with the seed.
    o, lse = flash_fwd(q, k, v, scale=0.2, causal=True,
                       dropout_probability=0.5, dropout_seed=seed)
    g1 = flash_bwd(q, k, v, o, lse, q, scale=0.2, causal=True,
                   dropout_probability=0.5, dropout_seed=seed)
    g2 = flash_bwd(q, k, v, o, lse, q, scale=0.2, causal=True,
                   dropout_probability=0.5, dropout_seed=seed + 1)
    assert not torch.equal(g1[2], g2[2])
