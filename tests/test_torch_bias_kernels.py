"""Post-scale bias and ALiBi in the port's flash attention, against the
JAX package on the CPU: ``flash_attention`` with ``bias=`` (broadcast
over the batch and per batch, f32 and bf16) or ``score_mod=`` ALiBi, and
its backward, against the Pallas flash attention in interpret mode and
its ``jax.vjp`` (O, dQ, dK, dV and dbias), and LSE against ``_flash_fwd``;
no mask, causal, padding with fully masked rows, a window with a sink,
the bottom-right offset, GQA groups of 2, 4 and 8, D 64 and 128. The
per-batch dbias of ``flash_bwd`` is exactly 0 on a causally skipped block
(the reference's ``_flash_bwd`` too), the ALiBi slopes against the
reference's formula, and the refusals the reference makes.

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
    _flash_bwd as j_flash_bwd, _flash_fwd as j_flash_fwd,
    flash_attention as j_flash_attention)
from transformerengine_tpu_torch.attention import (
    AttnMaskType, SequenceDescriptor, SoftmaxType)
from transformerengine_tpu_torch.flex_attention import (
    AlibiMod, alibi_arith_mod, alibi_slopes)
from transformerengine_tpu_torch.ops.flash_attention import (
    flash_attention, flash_bwd, flash_fwd)
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCK = 16
# Relative to each output's largest |ref|: f32 differs in summation order
# alone (readings below 1e-6); bf16 O and gradients round to bf16 from f32
# scores summed in other orders, a few of them one ulp (2^-8) apart, as
# the unbiased flash tests hold them. dbias is f32 ds on both sides (bf16
# after the cast for a bf16 bias), the same products in other orders.
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


# (dtype, mask, Sq, Skv, GQA group, D, window, sink, lengths, term) where
# term is "bias1" (broadcast f32), "biasB" (per batch, the inputs' dtype)
# or "alibi".
_CASES = {
    "f32_bias1_nomask": ("f32", "no_mask", 32, 32, 2, 64, None, None, None,
                         "bias1"),
    "bf16_biasB_causal": ("bf16", "causal", 48, 48, 2, 64, None, None, None,
                          "biasB"),
    "bf16_bias1_padding_masked_row": ("bf16", "padding", 40, 40, 4, 128,
                                      None, None, (40, 0), "bias1"),
    "bf16_bias1_window_sink": ("bf16", "causal", 48, 48, 2, 64, (10, 0),
                               "learnable", None, "bias1"),
    "f32_biasB_gqa8_padding": ("f32", "padding", 32, 32, 8, 64, None, None,
                               (32, 19), "biasB"),
    "bf16_alibi_causal": ("bf16", "causal", 48, 48, 2, 64, None, None, None,
                          "alibi"),
    "f32_alibi_padding_d128": ("f32", "padding", 32, 32, 4, 128, None, None,
                               (32, 21), "alibi"),
    "bf16_alibi_bottom_right": ("bf16", "causal_bottom_right", 32, 48, 2,
                                64, None, None, None, "alibi"),
}


def _case(name):
    (dtype, mask, sq, skv, group, d, window, sink, lens,
     term) = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name) + 400)
    b, hkv = 2, 2 if group == 2 else 1
    hq = hkv * group
    tensors = [_pair(rng.standard_normal(shape), dtype) for shape in
               ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                (b, sq, hq, d))]
    bias = None
    if term.startswith("bias"):
        bb = 1 if term == "bias1" else b
        bias = _pair(rng.standard_normal((bb, hq, sq, skv)) * 2,
                     "f32" if term == "bias1" else dtype)
    offset = (rng.standard_normal(hq) * 2).astype(np.float32)
    return dict(dtype=dtype, mask=mask, window=window, sink=sink, lens=lens,
                term=term, tensors=tensors, bias=bias, offset=offset,
                scale=d ** -0.5, hq=hq)


def _descs(c):
    if c["lens"] is None:
        return None, None
    lens = np.asarray(c["lens"], np.int32)
    return (JDesc.from_seqlens(jnp.asarray(lens)),
            SequenceDescriptor.from_seqlens(torch.from_numpy(lens)))


@pytest.mark.parametrize("name", list(_CASES))
def test_bias_flash_matches_pallas_vjp(name):
    """O, dQ, dK, dV, dbias (and dsink) of ``flash_attention`` with a
    bias or ALiBi against the Pallas kernel in interpret mode and its
    jax.vjp; a query that sees no key writes O = 0 and gets dQ = 0."""
    c = _case(name)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = c["tensors"]
    desc_j, desc_t = _descs(c)
    sink = c["sink"]
    alibi = c["term"] == "alibi"
    bj, bt = c["bias"] if c["bias"] is not None else (None, None)
    offj = jnp.asarray(c["offset"])
    offt = torch.from_numpy(c["offset"]).requires_grad_(sink == "learnable")

    def fj(q, k, v, off, bias):
        return j_flash_attention(
            q, k, v, desc_j, attn_mask_type=JMask(c["mask"]),
            window_size=c["window"], bias=bias,
            score_mod=j_alibi_arith_mod(c["hq"]) if alibi else None,
            softmax_type=sink and JSoftmax(sink), softmax_offset=off,
            block_q=BLOCK, block_k=BLOCK)

    oj, vjp = jax.vjp(fj, qj, kj, vj, offj, bj)
    grads_j = vjp(doj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    if bt is not None:
        bt.requires_grad_(True)
    ot = flash_attention(qt, kt, vt, desc_t,
                         attn_mask_type=AttnMaskType(c["mask"]),
                         window_size=c["window"], bias=bt,
                         score_mod=alibi_arith_mod(c["hq"]) if alibi else None,
                         softmax_type=sink and SoftmaxType(sink),
                         softmax_offset=offt)
    ot.backward(dot)
    got = {"O": ot, "dq": qt.grad, "dk": kt.grad, "dv": vt.grad}
    ref = {"O": oj, "dq": grads_j[0], "dk": grads_j[1], "dv": grads_j[2]}
    if sink == "learnable":
        got["dsink"], ref["dsink"] = offt.grad, grads_j[3]
    if bt is not None:
        got["dbias"], ref["dbias"] = bt.grad, grads_j[4]
        assert bt.grad.dtype == bt.dtype and bt.grad.shape == bt.shape
    tol = _RTOL[c["dtype"]]
    for key in got:
        assert got[key] is not None and got[key].shape == ref[key].shape
        r = _np(ref[key])
        np.testing.assert_allclose(_np(got[key]), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=key)
    if c["lens"] is not None:
        pos = np.arange(qt.shape[1])[None, :]
        qzero = torch.from_numpy(pos >= np.asarray(c["lens"])[:, None])
        assert bool(qzero.any())
        for t in (ot.detach(), qt.grad):
            assert float(t[qzero].abs().max()) == 0.0


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("name", ["f32_bias1_nomask",
                                  "bf16_bias1_padding_masked_row",
                                  "f32_alibi_padding_d128",
                                  "bf16_alibi_bottom_right"])
def test_bias_flash_lse_matches_pallas(name):
    """LSE of every row against ``_flash_fwd``: -1e30 for a query that
    sees no key."""
    c = _case(name)
    (qj, qt), (kj, kt), (vj, vt), _ = c["tensors"]
    mask = AttnMaskType(c["mask"])
    off = kt.shape[1] - qt.shape[1] if mask.is_bottom_right else 0
    alibi = c["term"] == "alibi"
    bj, bt = c["bias"] if c["bias"] is not None else (None, None)
    qseg = kseg = None
    lens_t = None
    if c["lens"] is not None:
        lens = np.asarray(c["lens"])
        qseg = jnp.asarray(np.arange(qt.shape[1])[None] < lens[:, None],
                           jnp.int32)
        kseg = jnp.asarray(np.arange(kt.shape[1])[None] < lens[:, None],
                           jnp.int32)
        lens_t = torch.from_numpy(lens.astype(np.int32))
    _, lj = j_flash_fwd(
        _bhsd(qj), _bhsd(kj), _bhsd(vj), qseg, kseg,
        jnp.zeros((1,), jnp.int32), bj, scale=c["scale"],
        causal=mask.is_causal, window=(-1, -1), offset=off, block_q=BLOCK,
        block_k=BLOCK,
        score_mod=j_alibi_arith_mod(c["hq"]) if alibi else None)
    _, lt = flash_fwd(qt, kt, vt, lens_t, lens_t, scale=c["scale"],
                      causal=mask.is_causal, offset=off, bias=bt,
                      score_mod=AlibiMod(c["hq"]) if alibi else None)
    lj = _np(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=LSE_ATOL)
    if c["lens"] is not None:
        zero = np.arange(qt.shape[1])[None] >= np.asarray(c["lens"])[:, None]
        assert bool((lt.numpy().transpose(0, 2, 1)[zero] == -1e30).all())


def test_dbias_is_zero_on_a_skipped_block():
    """The per-batch dbias of a causal layer is exactly 0 above the
    diagonal, on the port's side and on the reference's (whose kernel
    skips those blocks and writes zeros), and matches it below."""
    c = _case("bf16_biasB_causal")
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = c["tensors"]
    bj, bt = c["bias"]
    scale = c["scale"]
    o, lse = flash_fwd(qt, kt, vt, scale=scale, causal=True, bias=bt)
    *_, dbias = flash_bwd(qt, kt, vt, o, lse, dot, scale=scale, causal=True,
                          bias=bt)
    zeros = jnp.zeros((1,), jnp.int32)
    kw = dict(scale=scale, causal=True, window=(-1, -1), offset=0,
              block_q=BLOCK, block_k=BLOCK)
    oj, lj = j_flash_fwd(_bhsd(qj), _bhsd(kj), _bhsd(vj), None, None, zeros,
                         bj, **kw)
    *_, dbj = j_flash_bwd(_bhsd(qj), _bhsd(kj), _bhsd(vj), oj, lj,
                          _bhsd(doj), None, None, zeros, bj, **kw)
    s = qt.shape[1]
    upper = np.triu(np.ones((s, s), bool), k=1)
    assert dbias.dtype == torch.float32 and dbias.shape == (2, c["hq"], s, s)
    assert float(dbias.numpy()[..., upper].__abs__().max()) == 0.0
    # Whole 16-key blocks above the diagonal are skipped by the
    # reference's kernel.
    assert float(np.abs(_np(dbj)[..., :16, 16:]).max()) == 0.0
    r = _np(dbj)
    np.testing.assert_allclose(dbias.numpy(), r, rtol=0,
                               atol=_RTOL["bf16"] * np.abs(r).max())


def test_alibi_slopes_against_the_reference_formula():
    """The port's slopes (torch's exp2 on f32) against the reference's
    formula under XLA on the CPU, whose exp2 is exact only at integer
    exponents: within 4 f32 ulps (readings: 3 at 12, 32 and 64 heads); at
    the integer exponents of 4 and 8 heads they are equal powers of
    two."""
    for hq in (4, 8, 12, 32, 64):
        h = jnp.arange(hq, dtype=jnp.float32)
        ref = np.asarray(jnp.exp2(-(h + 1.0) * (8.0 / hq)))
        got = alibi_slopes(hq).numpy()
        assert np.all(np.abs(got - ref) <= 4 * np.spacing(ref)), hq
    assert np.array_equal(alibi_slopes(8).numpy(),
                          2.0 ** -np.arange(1, 9, dtype=np.float32))
    mod = AlibiMod(8)
    assert torch.equal(mod.slopes(4), alibi_slopes(8)[:4])
    score = torch.zeros((1, 2, 3, 3))
    qi = torch.arange(3)[:, None]
    ki = torch.arange(3)[None, :]
    h = torch.arange(2)[:, None, None]
    want = -(2.0 ** -(h + 1.0)) * (qi - ki).abs()
    assert torch.equal(mod(score, 0, h, qi, ki), want[None].float())


def _qkv(dtype=torch.bfloat16):
    rng = np.random.default_rng(9)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in ((1, 16, 4, 32), (1, 16, 2, 32), (1, 16, 2, 32))]


def _current():
    return CurrentScaleQuantizer(torch.float8_e4m3fn, QuantizeLayout.ROWWISE)


def test_refusals_follow_the_reference():
    """A bias with a score mod, a bias or a score mod with FP8 Q/K/V
    quantizers or fp8_mha, and any score mod other than ALiBi raise, as
    the reference's asserts refuse them; a bias of the wrong shape or
    dtype raises in the wrappers."""
    q, k, v = _qkv()
    bias = torch.zeros((1, 4, 16, 16))
    alibi = alibi_arith_mod(4)
    quantizers = [_current() for _ in range(3)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        flash_attention(q, k, v, bias=bias, score_mod=alibi)
    with pytest.raises(ValueError, match="FP8 flash attention does not take"):
        flash_attention(q, k, v, bias=bias, qkv_quantizers=quantizers)
    with pytest.raises(ValueError, match="FP8 flash path"):
        flash_attention(q, k, v, score_mod=alibi, qkv_quantizers=quantizers)
    w = torch.zeros((128, 64), dtype=torch.bfloat16)
    for kw in (dict(bias=bias), dict(score_mod=alibi)):
        with pytest.raises(ValueError, match="fp8_mha"):
            flash_attention(q, k, v, mha_proj=(w, [_current()] * 7), **kw)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        flash_attention(q, k, v, score_mod=lambda s, b, h, i, j: s)
    for bad in (torch.zeros((2, 4, 16, 16)), torch.zeros((1, 2, 16, 16)),
                torch.zeros((1, 4, 16, 8)), torch.zeros((4, 16, 16))):
        with pytest.raises(ValueError, match="bias must be"):
            flash_fwd(q, k, v, scale=0.2, causal=False, bias=bad)
    with pytest.raises(TypeError, match="f32 or bf16"):
        flash_fwd(q, k, v, scale=0.2, causal=False,
                  bias=torch.zeros((1, 4, 16, 16), dtype=torch.float16))
    # The q-position offset is ported: an int or a one-element integer
    # tensor, anything else raises.
    with pytest.raises(TypeError, match="q_position_offset"):
        flash_attention(q, k, v, q_position_offset=0.1)
    # Dropout is ported: a rate without a seed raises, as the reference's
    # wrapper does.
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_probability=0.1)


def test_bias_gradient_is_off_without_requires_grad():
    """A bias that needs no gradient gets none, and the forward without
    autograd returns what the autograd function returns."""
    q, k, v = _qkv(torch.float32)
    rng = np.random.default_rng(3)
    bias = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(
        np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, bias=bias)
    out.sum().backward()
    assert bias.grad is None and all(t.grad is not None for t in leaves)
    with torch.no_grad():
        again = flash_attention(q, k, v, bias=bias)
    assert torch.equal(out.detach(), again)
