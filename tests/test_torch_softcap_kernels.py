"""The soft cap in the port's flash attention, against the JAX package on
the CPU: ``flash_attention(score_mod=soft_cap_mod(cap))`` and its backward
against the Pallas flash attention in interpret mode and its ``jax.vjp``
(O, dQ, dK, dV and dsink), and LSE against ``_flash_fwd``, under causal,
padding with fully masked rows, GQA, a window with a sink, segment ids,
dropout (the keep bits equal) and D 64 and 128, in f32 and bf16; the
cap's VJP in the reference's order of operations, bit for bit; a wrong
cap moves O beyond the tolerance; the refusals follow the reference.

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
    soft_cap_mod as j_soft_cap_mod)
from transformerengine_tpu.ops.flash_attention import (
    _flash_fwd as j_flash_fwd, flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor, SoftmaxType)
from transformerengine_tpu_torch.flex_attention import (
    SoftCapMod, alibi_arith_mod, soft_cap_mod)
from transformerengine_tpu_torch.ops import flash_attention as fa
from transformerengine_tpu_torch.ops.flash_attention import (
    _soft_cap_grad, flash_attention, flash_bwd, flash_fwd)
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
# The reference's tiles: 32 queries by 64 keys.
BLOCK_Q, BLOCK_K = 32, 64
# Relative to each output's largest |ref|. f32: XLA compiles the
# reference's kernel with its constants folded (s * (scale / cap), then
# tanh(.) * (cap * log2(e))), an FMA in the derivative and its own tanh
# (up to 4 ulps off torch's), where the port divides by cap and calls
# torch's tanh: readings up to 1.2e-6 at caps 5-50 and scores of std 8.
# bf16 rounds p and ds from those f32 values, as the other bf16 flash
# tests hold them (readings up to 3.6e-3).
_RTOL = {"f32": 1e-5, "bf16": 2 ** -6}
LSE_ATOL = 1e-5
SEED = np.array([0x9ABCDEF0 - 2 ** 32, 0x13579BDF], np.int32)
# q and k are drawn with this spread: scores q . k * scale of std 8,
# where a cap of 5-50 bends them (std-1 scores would leave it linear).
SPREAD = 8.0 ** 0.5

# (dtype, D, Hq, Hkv, mask, lengths or ids, window, sink, cap, dropout)
_CASES = {
    "f32_causal_d64": ("f32", 64, 4, 2, "causal", None, None, None, 20.0,
                       None),
    "bf16_causal_d128": ("bf16", 128, 4, 2, "causal", None, None, None,
                         50.0, None),
    "f32_padding_masked_rows": ("f32", 64, 4, 1, "padding", (96, 40), None,
                                None, 5.0, None),
    "bf16_gqa4_window_sink": ("bf16", 64, 8, 2, "causal", None, (40, 0),
                              "learnable", 10.0, None),
    "f32_segments": ("f32", 64, 4, 2, "padding_causal", "segments", None,
                     None, 30.0, None),
    "bf16_dropout": ("bf16", 64, 4, 2, "causal", None, None, None, 15.0,
                     0.2),
    "f32_dropout_padding_d128": ("f32", 128, 4, 1, "padding", (96, 61),
                                 None, "off_by_one", 8.0, 0.1),
}
SEQ = 96


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(x: np.ndarray, dtype: str):
    xj = jnp.asarray(x).astype(_JD[dtype])
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(_TD[dtype])


def _case(name):
    dtype, d, hq, hkv, mask, masks, window, sink, cap, rate = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 900)
    b = 2
    shapes = ((b, SEQ, hq, d), (b, SEQ, hkv, d), (b, SEQ, hkv, d),
              (b, SEQ, hq, d))
    spreads = (SPREAD, SPREAD, 1.0, 1.0)
    tensors = [_pair(rng.standard_normal(s) * m, dtype)
               for s, m in zip(shapes, spreads)]
    offset = (rng.standard_normal(hq) * 2).astype(np.float32)
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
    return dict(dtype=dtype, d=d, hq=hq, mask=mask, window=window,
                sink=sink, cap=cap, rate=rate, tensors=tensors,
                offset=offset, descs=descs)


def _run_both(c, cap_t=None):
    """(got, ref): O and the gradients of the port's and the reference's
    flash_attention with the soft cap (``cap_t`` the port's, if other)."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = c["tensors"]
    desc_j, desc_t = c["descs"]
    sink = c["sink"]
    offj = jnp.asarray(c["offset"])
    offt = torch.from_numpy(c["offset"]).requires_grad_(sink == "learnable")
    drop_j = drop_t = {}
    if c["rate"]:
        drop_j = dict(dropout_probability=c["rate"],
                      dropout_seed=jnp.asarray(SEED))
        drop_t = dict(dropout_probability=c["rate"],
                      dropout_seed=torch.from_numpy(SEED))

    def fj(q, k, v, off):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask(c["mask"]),
            window_size=c["window"], score_mod=j_soft_cap_mod(c["cap"]),
            softmax_type=sink and JSoftmax(sink), softmax_offset=off,
            block_q=BLOCK_Q, block_k=BLOCK_K, **drop_j)

    oj, vjp = jax.vjp(fj, qj, kj, vj, offj)
    grads_j = vjp(doj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    ot = flash_attention(*leaves, desc_t,
                         attn_mask_type=AttnMaskType(c["mask"]),
                         window_size=c["window"],
                         score_mod=soft_cap_mod(cap_t or c["cap"]),
                         softmax_type=sink and SoftmaxType(sink),
                         softmax_offset=offt, block_q=BLOCK_Q,
                         block_k=BLOCK_K, **drop_t)
    ot.backward(dot)
    got = {"O": ot, "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}
    ref = {"O": oj, "dq": grads_j[0], "dk": grads_j[1], "dv": grads_j[2]}
    if sink == "learnable":
        got["dsink"], ref["dsink"] = offt.grad, grads_j[3]
    return got, ref


@pytest.mark.parametrize("name", list(_CASES))
def test_softcap_flash_matches_pallas_vjp(name):
    """O, dQ, dK, dV (and dsink) under the soft cap against the Pallas
    kernel in interpret mode and its jax.vjp."""
    c = _case(name)
    got, ref = _run_both(c)
    tol = _RTOL[c["dtype"]]
    for key in got:
        assert got[key] is not None and got[key].shape == ref[key].shape
        assert got[key].dtype == _TD[c["dtype"]] or key == "dsink"
        r = _np(ref[key])
        np.testing.assert_allclose(_np(got[key]), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=key)


def test_a_wrong_cap_moves_the_output():
    """The test has teeth: a cap 10 % off moves O and dQ beyond the
    tolerance."""
    c = _case("f32_causal_d64")
    got, ref = _run_both(c, cap_t=0.9 * c["cap"])
    for key in ("O", "dq"):
        r = _np(ref[key])
        assert np.abs(_np(got[key]) - r).max() > \
            100 * _RTOL["f32"] * np.abs(r).max(), key


def test_softcap_lse_and_launch_name():
    """LSE under the cap against ``_flash_fwd``, and the launch's branch
    name ("_softcap", before "_dropout" and "_sw")."""
    c = _case("f32_causal_d64")
    (qj, qt), (kj, kt), (vj, vt), _ = c["tensors"]
    bhsd = lambda x: x.transpose(0, 2, 1, 3)
    d = c["d"]
    _, lj = j_flash_fwd(
        bhsd(qj), bhsd(kj), bhsd(vj), None, None, jnp.zeros((1,), jnp.int32),
        scale=d ** -0.5, causal=True, window=(-1, -1), offset=0,
        block_q=BLOCK_Q, block_k=BLOCK_K,
        score_mod=j_soft_cap_mod(c["cap"]))
    _, lt = flash_fwd(qt, kt, vt, scale=d ** -0.5, causal=True,
                      score_mod=SoftCapMod(c["cap"]))
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-5, atol=LSE_ATOL)
    drop = fa._dropout(0.1, SEED, 512, 1024, "cpu")
    assert fa._branch(False, False, (8, 0), None, False, cap=50.0,
                      dropout=drop) == "_softcap_dropout_sw"


@pytest.mark.parametrize("cap", [1.0, 50.0, 1e4])
def test_softcap_vjp_is_the_references_order(cap):
    """The plain version's VJP of the cap, given the reference's tanh,
    equals the reference's op-by-op ``jax.vjp`` of ``cap * tanh(x / cap)``
    bit for bit (JAX's transpose of its tanh rule: (cap * ds) * (1 - t),
    then (w + w * t) / cap), saturated (cap 1), bending (50) and linear
    (1e4); the form ``ds * (1 - t^2)`` differs."""
    rng = np.random.default_rng(int(cap))
    x = (rng.standard_normal(4096) * 30).astype(np.float32)
    ds = rng.standard_normal(4096).astype(np.float32)
    mod = j_soft_cap_mod(cap)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda s: mod(s, 0, 0, 0, 0), jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(ds))[0])
        t = np.asarray(jnp.tanh(jnp.asarray(x) / cap))
    got = _soft_cap_grad(torch.from_numpy(ds), torch.from_numpy(t), cap)
    assert np.array_equal(got.numpy(), want)
    other = torch.from_numpy(ds) * (1.0 - torch.from_numpy(t) ** 2)
    assert not np.array_equal(other.numpy(), want)


def test_softcap_refusals_follow_the_reference():
    """The cap with a bias, with FP8 Q/K/V quantizers or with fp8_mha
    raises as the reference's asserts do; a cap that is not finite and
    positive raises in the wrappers; a plain callable is not a kernel
    branch."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((1, 16, 4, 32), (1, 16, 2, 32),
                                             (1, 16, 2, 32)))
    cap = soft_cap_mod(30.0)
    current = [CurrentScaleQuantizer(torch.float8_e4m3fn,
                                     QuantizeLayout.ROWWISE)
               for _ in range(7)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        flash_attention(q, k, v, bias=torch.zeros((1, 4, 16, 16)),
                        score_mod=cap)
    with pytest.raises(ValueError, match="FP8 flash path"):
        flash_attention(q, k, v, score_mod=cap, qkv_quantizers=current[:3])
    with pytest.raises(ValueError, match="fp8_mha"):
        flash_attention(q, k, v, score_mod=cap,
                        mha_proj=(torch.zeros((128, 8)), current))
    for bad in (0.0, -5.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="finite soft cap"):
            flash_fwd(q, k, v, scale=0.2, causal=True,
                      score_mod=SoftCapMod(bad))
    with pytest.raises(NotImplementedError, match="chunked"):
        flash_attention(q, k, v, score_mod=lambda s, b, h, i, j: s)
    # ALiBi and the cap are each a branch; the cap's q is unscaled.
    o1, lse1 = flash_fwd(q, k, v, scale=0.2, causal=True, score_mod=cap)
    o2, _ = flash_fwd(q, k, v, scale=0.2, causal=True,
                      score_mod=alibi_arith_mod(4))
    assert not torch.equal(o1, o2)
    g = flash_bwd(q, k, v, o1, lse1, q, scale=0.2, causal=True,
                  score_mod=cap)
    assert len(g) == 3 and all(t.dtype == torch.bfloat16 for t in g)
