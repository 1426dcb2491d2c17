"""The port's ``flex_attention`` against the JAX package's on the CPU,
impl by impl: ``reference`` and ``chunked`` against the same impls of the
reference, and ``flash`` (the kernels' plain versions here) against the
reference's Pallas flash impl in interpret mode; every mod
(``soft_cap_mod``, ``alibi_mod``, ``alibi_arith_mod``,
``relative_position_bias_mod``, ``causal_mask_mod``), GQA, a ragged Skv
(150 keys with ``block_k`` 128), the forward and the gradients of q, k, v
and of the tensors the mods capture (the relative table and the ALiBi
slopes, and a plain callable's captured tensor through the chunked
impl's reentrant backward). Under ``flash`` a mod or mask without a
kernel branch raises. It mirrors the reference's own flex tests
(tests/test_misc_api.py, ``TestFlexAttention``).

Inputs are seeded numpy arrays on both sides."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu_torch as te_torch

J = importlib.import_module("transformerengine_tpu.flex_attention")
T = importlib.import_module("transformerengine_tpu_torch.flex_attention")

torch.set_num_threads(2)

# Relative to each output's largest |ref|. reference and chunked: f32 on
# both sides, sums in other orders (readings up to 1.9e-6 at scores of
# std 4). flash, f32: the kernels' exp2-domain plain versions against the
# reference's Pallas kernel in interpret mode, where XLA folds its
# constants and its tanh is a few ulps off torch's (readings up to
# 1.1e-6 over four seeds). bf16 rounds p and ds on both sides, where a
# one-ulp flip moves an element: over four seeds the soft cap reads up
# to 1.8e-4 and the causal mask alone up to 2.5e-4 (both through q
# unscaled, the mask alone in the kernels' ALiBi branch with zero slopes,
# as the reference folds its mask into a score mod).
RTOL = 1e-5
FLASH_RTOL = {"f32": 1e-5, "bf16": 2 ** -9}
SLOPES = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(name, got, ref, rtol):
    r = _np(ref)
    np.testing.assert_allclose(_np(got), r, rtol=0,
                               atol=rtol * np.abs(r).max(), err_msg=name)


def _inputs(seed, b, sq, skv, hq, hkv, d, spread=1.0):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
              (b, sq, hq, d))
    return [(rng.standard_normal(s) * m).astype(np.float32)
            for s, m in zip(shapes, (spread, spread, 1.0, 1.0))]


def _mods(name, hq, rng):
    """(reference mod, port mod, the captured table or slopes (numpy) or
    None): the port's takes a tensor that requires a gradient."""
    if name == "none":
        return None, None, None
    if name == "soft_cap":
        return J.soft_cap_mod(20.0), T.soft_cap_mod(20.0), None
    if name == "alibi_arith":
        return J.alibi_arith_mod(hq), T.alibi_arith_mod(hq), None
    if name == "alibi":
        s = SLOPES[:hq] if hq <= 4 else np.geomspace(0.5, 0.01, hq).astype(
            np.float32)
        t = torch.tensor(s, requires_grad=True)
        return J.alibi_mod(jnp.asarray(s)), T.alibi_mod(t), (s, t)
    table = (0.5 * rng.standard_normal((hq, 9))).astype(np.float32)
    t = torch.tensor(table, requires_grad=True)
    return (J.relative_position_bias_mod(jnp.asarray(table)),
            T.relative_position_bias_mod(t), (table, t))


def _run(impl, mod_name, causal, shape, seed, block_k=128, spread=1.0):
    """(port outputs, reference outputs): O and the gradients of q, k, v
    and of the mod's captured tensor, for one impl on both sides."""
    b, sq, skv, hq, hkv, d = shape
    q, k, v, do = _inputs(seed, b, sq, skv, hq, hkv, d, spread)
    jm, tm, cap = _mods(mod_name, hq, np.random.default_rng(seed + 1))
    jmask = J.causal_mask_mod if causal else None
    tmask = T.causal_mask_mod if causal else None
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    kw = dict(impl=impl, block_k=block_k)
    if cap is not None:
        rebuild = {"alibi": J.alibi_mod,
                   "relbias": J.relative_position_bias_mod}[mod_name]

        def fj(q, k, v, c):
            return J.flex_attention(q, k, v, score_mod=rebuild(c),
                                    mask_mod=jmask, **kw)
        jargs.append(jnp.asarray(cap[0]))
    else:
        def fj(q, k, v):
            return J.flex_attention(q, k, v, score_mod=jm, mask_mod=jmask,
                                    **kw)
    oj, vjp = jax.vjp(fj, *jargs)
    ref = [oj, *vjp(jnp.asarray(do))]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ot = T.flex_attention(*leaves, score_mod=tm, mask_mod=tmask, **kw)
    ot.backward(torch.from_numpy(do))
    got = [ot] + [t.grad for t in leaves]
    if cap is not None:
        got.append(cap[1].grad)
    return got, ref


# (mod, causal). One shape for all, GQA 2 with a ragged Skv of 150 keys
# (two blocks of 128, the second padded): (B, Sq, Skv, Hq, Hkv, D).
_CASES = {
    "causal_no_mod": ("none", True),
    "soft_cap_causal": ("soft_cap", True),
    "soft_cap": ("soft_cap", False),
    "alibi_causal": ("alibi", True),
    "alibi_arith": ("alibi_arith", False),
    "relbias_causal": ("relbias", True),
}
SHAPE = (2, 40, 150, 4, 2, 16)


@pytest.mark.parametrize("impl", ["reference", "chunked"])
@pytest.mark.parametrize("name", list(_CASES))
def test_impl_matches_the_references_impl(impl, name):
    """O and the gradients of q, k, v and of the captured table or
    slopes against the reference's same impl (its chunked impl reaches
    the captured tensors with ``jax.closure_convert``)."""
    mod, causal = _CASES[name]
    got, ref = _run(impl, mod, causal, SHAPE,
                    sorted(_CASES).index(name) + 40, spread=2.0)
    assert len(got) == len(ref)
    for gname, a, r in zip(("O", "dq", "dk", "dv", "dcaptured"), got, ref):
        assert a is not None and tuple(a.shape) == tuple(r.shape), gname
        _close(gname, a, r, RTOL)
    if len(got) == 5:
        assert float(got[4].abs().max()) > 0   # the tensor gets gradient


# (mod, causal, dtype)
_FLASH = {
    "soft_cap_causal_f32": ("soft_cap", True, "f32"),
    "soft_cap_bf16": ("soft_cap", False, "bf16"),
    "alibi_arith_causal_f32": ("alibi_arith", True, "f32"),
    "causal_bf16": ("none", True, "bf16"),
}


@pytest.mark.parametrize("name", list(_FLASH))
def test_flash_impl_matches_the_references_flash(name):
    """``impl="flash"``: the soft cap, ALiBi and the causal mask (offset
    0, Sq < Skv) through the kernels' plain versions against the
    reference's flash impl (the Pallas kernel in interpret mode), forward
    and q, k, v gradients. The reference folds the mask into its mod and
    visits every tile; every row here sees a key, so the numbers are the
    same."""
    mod, causal, dtype = _FLASH[name]
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, do = _inputs(sorted(_FLASH).index(name) + 60, 1, 48, 64, 4, 2,
                          32, spread=2.0)
    jm, tm, _ = _mods(mod, 4, None)
    jargs = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    oj, vjp = jax.vjp(lambda q, k, v: J.flex_attention(
        q, k, v, score_mod=jm, mask_mod=J.causal_mask_mod if causal
        else None, impl="flash"), *jargs)
    ref = [oj, *vjp(jnp.asarray(do).astype(jd))]
    leaves = [torch.tensor(np.asarray(x.astype(jnp.float32))).to(td)
              .requires_grad_() for x in jargs]
    ot = T.flex_attention(*leaves, score_mod=tm,
                          mask_mod=T.causal_mask_mod if causal else None,
                          impl="flash")
    ot.backward(torch.tensor(np.asarray(jnp.asarray(do).astype(jd)
                                        .astype(jnp.float32))).to(td))
    for gname, a, r in zip(("O", "dq", "dk", "dv"),
                           [ot] + [t.grad for t in leaves], ref):
        assert a.dtype == td, gname
        _close(gname, a, r, FLASH_RTOL[dtype])


def test_flash_alibi_slopes_and_captured_gradients():
    """``alibi_mod`` under ``impl="flash"`` runs the kernels' ALiBi branch
    from its (Hq,) slopes (the reference's flash impl cannot capture
    them: its kernel refuses captured constants), so it is held to the
    reference's reference impl; its slopes get no gradient, as captured
    tensors under the reference's flash impl do not."""
    q, k, v, do = _inputs(70, 2, 40, 40, 4, 2, 32, spread=2.0)
    ref_o, vjp = jax.vjp(lambda q, k, v: J.flex_attention(
        q, k, v, score_mod=J.alibi_mod(jnp.asarray(SLOPES)),
        mask_mod=J.causal_mask_mod, impl="reference"),
        *(jnp.asarray(x) for x in (q, k, v)))
    ref = [ref_o, *vjp(jnp.asarray(do))]
    slopes = torch.tensor(SLOPES, requires_grad=True)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ot = T.flex_attention(*leaves, score_mod=T.alibi_mod(slopes),
                          mask_mod=T.causal_mask_mod, impl="flash")
    ot.backward(torch.from_numpy(do))
    for gname, a, r in zip(("O", "dq", "dk", "dv"),
                           [ot] + [t.grad for t in leaves], ref):
        _close(gname, a, r, FLASH_RTOL["f32"])
    assert slopes.grad is None
    with pytest.raises(ValueError, match="one ALiBi slope per"):
        T.flex_attention(*leaves, score_mod=T.alibi_mod(slopes[:2]),
                         impl="flash")


def test_plain_callable_captures_get_gradients():
    """A plain callable's captured floating tensor gets its gradient
    through the chunked impl's reentrant backward (into ``.grad``), equal
    to the reference's ``jax.closure_convert`` gradient; a captured
    integer tensor gets none and does no harm."""
    q, k, v, do = _inputs(80, 1, 32, 40, 2, 1, 16)
    w = np.array([0.3, -0.2], np.float32)
    shift = np.array([1, 2], np.int32)

    def loss_j(q, k, v, w):
        sh = jnp.asarray(shift)
        mod = lambda s, b, h, i, j: s + w[h] * jnp.sin(
            (i - j + sh[h]).astype(jnp.float32))
        o = J.flex_attention(q, k, v, score_mod=mod, impl="chunked",
                             block_k=128)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, w)))
    wt = torch.tensor(w, requires_grad=True)
    sh = torch.from_numpy(shift)
    mod = lambda s, b, h, i, j: s + wt[h] * torch.sin(
        (i - j + sh[h]).to(torch.float32))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = T.flex_attention(*leaves, score_mod=mod, impl="chunked", block_k=128)
    (o * torch.from_numpy(do)).sum().backward()
    for gname, a, r in zip(("dq", "dk", "dv", "dw"),
                           [t.grad for t in leaves] + [wt.grad], ref):
        _close(gname, a, r, RTOL)
    assert float(wt.grad.abs().max()) > 0


def test_flash_refusals_and_the_api():
    """Under ``impl="flash"`` a mod or mask without a kernel branch raises
    ``NotImplementedError`` that names ``impl="chunked"``; an unknown impl
    raises; ``auto`` is ``chunked``; the package exports
    ``flex_attention`` as the reference does."""
    q, k, v, _ = _inputs(90, 1, 16, 16, 2, 2, 16)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    table = torch.zeros((2, 5))
    for kw in (dict(score_mod=T.relative_position_bias_mod(table)),
               dict(score_mod=lambda s, b, h, i, j: s * 2),
               dict(mask_mod=lambda b, h, i, j: i >= j)):
        with pytest.raises(NotImplementedError, match="chunked"):
            T.flex_attention(q, k, v, impl="flash", **kw)
    with pytest.raises(ValueError, match="unknown flex impl"):
        T.flex_attention(q, k, v, impl="paged")
    mod = T.soft_cap_mod(5.0)
    assert torch.equal(T.flex_attention(q, k, v, score_mod=mod),
                       T.flex_attention(q, k, v, score_mod=mod,
                                        impl="chunked"))
    assert te_torch.flex_attention is T.flex_attention
    assert "flex_attention" in te_torch.__all__
