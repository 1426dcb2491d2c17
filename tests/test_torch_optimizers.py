"""The port's optimizers against the JAX package's, on the same
numpy-seeded params and gradients: ``fused_adam`` (every storage form)
against the reference's ``step`` and ``update`` run eagerly, bit for bit
(under ``jax.jit`` XLA rewrites the fused chain and moves words of the
moments and params), ``fused_sgd`` against the reference's optax chain,
Newton-Schulz and Muon within a bf16 tolerance, the multi-tensor
functions, and the reference's AdamState carried into the port
mid-trajectory through ``load_flax_opt_state``."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.optimizers import (
    clip_by_global_norm as j_clip, fused_adam as j_adam,
    fused_sgd as j_sgd, multi_tensor_compute_scale_and_scale_inv as j_scales,
    multi_tensor_l2norm as j_l2norm, multi_tensor_scale as j_scale,
    multi_tensor_unscale_l2norm as j_unscale_l2norm, muon as j_muon,
    newton_schulz as j_newton_schulz)
from transformerengine_tpu.optimizers.fused_adam import (
    ScaledState as JScaledState)
from transformerengine_tpu.quantize import qmath as j_qmath
from transformerengine_tpu.quantize.scaling_modes import (
    ScalingMode as JScalingMode)
from transformerengine_tpu.quantize.tensor import make_scaled_tensor
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, flax_state, load_flax_opt_state,
    load_flax_params, unstack_layers)
from transformerengine_tpu_torch.optimizers import (
    AdamState, ScaledState, apply_updates, clip_by_global_norm, fused_adam,
    fused_sgd, grads_of, multi_tensor_compute_scale_and_scale_inv,
    multi_tensor_l2norm, multi_tensor_scale, multi_tensor_unscale_l2norm,
    muon, newton_schulz)
from transformerengine_tpu_torch.optimizers.fused_adam import (
    _combine_master)
from transformerengine_tpu_torch.quantize.qmath import current_scale_quantize
from transformerengine_tpu_torch.quantize.scaling_modes import ScalingMode
from transformerengine_tpu_torch.quantize.tensor import ScaledTensor1x

torch.set_num_threads(2)

E4M3 = ml_dtypes.float8_e4m3fn
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(ml_dtypes.bfloat16): torch.bfloat16,
          np.dtype(np.float16): torch.float16,
          np.dtype(E4M3): torch.float8_e4m3fn}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        view = _UINT[a.dtype.itemsize]
        return torch.from_numpy(a.view(view).copy()).view(_TORCH[a.dtype])
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """The words of an array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        return x.contiguous().view(ints[x.element_size()]).numpy().view(
            _UINT[x.element_size()])
    a = np.array(np.asarray(x), order="C")
    return a.view(_UINT[a.dtype.itemsize])


def _same(j, t, what):
    if isinstance(j, JScaledState):
        assert isinstance(t, ScaledState), what
        _same(j.payload, t.payload, what + ".payload")
        _same(j.scale_inv, t.scale_inv, what + ".scale_inv")
        return
    if j is None or t is None:
        assert j is None and t is None, what
        return
    if hasattr(j, "scaling_mode"):
        _same(j.data, t.data, what + ".data")
        _same(j.scale_inv, t.scale_inv, what + ".scale_inv")
        _same(j.amax, t.amax, what + ".amax")
        return
    jb, tb = _bits(j), _bits(t)
    assert jb.shape == tb.shape, what
    diff = int((jb != tb).sum())
    assert diff == 0, f"{what}: {diff} words differ"


def _params(dtypes=("f32", "f32"), seed=0):
    """{"b": (96,), "w": (64, 96)} in the given dtypes ("f32", "bf16" or
    "fp8": an e4m3 current-scaled ScaledTensor1x): (jax tree, port
    dict)."""
    rng = np.random.default_rng(seed)
    vals = {"b": rng.standard_normal(96).astype(np.float32) * 0.1,
            "w": rng.standard_normal((64, 96)).astype(np.float32)}
    jp, tp = {}, {}
    for (name, v), kind in zip(vals.items(), dtypes):
        if kind == "fp8":
            data, sinv, amax = j_qmath.current_scale_quantize(
                jnp.asarray(v), jnp.float8_e4m3fn)
            jp[name] = make_scaled_tensor(
                data, sinv, scaling_mode=JScalingMode.CURRENT_TENSOR_SCALING,
                dq_dtype=jnp.bfloat16, amax=amax.reshape(1))
            tdata, tsinv, tamax = current_scale_quantize(
                torch.from_numpy(v), torch.float8_e4m3fn)
            tp[name] = ScaledTensor1x(
                tdata, tsinv, tamax.reshape(1), torch.bfloat16,
                scaling_mode=ScalingMode.CURRENT_TENSOR_SCALING)
            _same(jp[name], tp[name], f"initial {name}")
            continue
        dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        jp[name] = jnp.asarray(v).astype(dt)
        tp[name] = _to_torch(np.asarray(jp[name]))
    return jp, tp


def _grads(shapes, rng, scale=1.0):
    g = {n: (rng.standard_normal(s) * scale).astype(np.float32)
         for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in g.items()},
            {n: torch.from_numpy(a) for n, a in g.items()})


def _shapes(tp):
    return {n: tuple(p.data.shape if isinstance(p, ScaledTensor1x)
                     else p.shape) for n, p in tp.items()}


def _same_state(js, ts, what=""):
    assert int(js.step) == int(ts.step)
    for part in ("mu", "nu", "master"):
        jt, tt = getattr(js, part), getattr(ts, part)
        assert set(jt) == set(tt)
        for n in jt:
            _same(jt[n], tt[n], f"{what}{part}.{n}")


# (name, params' dtypes, fused_adam's keywords)
ADAM_CASES = [
    ("plain", ("f32", "f32"), {}),
    ("adamw", ("f32", "f32"), dict(weight_decay=0.01)),
    ("l2", ("f32", "f32"), dict(weight_decay=0.01, adam_w_mode=False)),
    ("bf16_params", ("f32", "bf16"), dict(weight_decay=0.01)),
    ("masters", ("f32", "bf16"),
     dict(use_master_weights=True, weight_decay=0.01)),
    ("remainders", ("f32", "bf16"),
     dict(store_param_remainders=True, weight_decay=0.01)),
    ("remainders_l2", ("bf16", "bf16"),
     dict(store_param_remainders=True, weight_decay=0.01,
          adam_w_mode=False)),
    ("bf16_states", ("f32", "bf16"),
     dict(use_master_weights=True, exp_avg_dtype="bf16",
          exp_avg_sq_dtype="bf16")),
    ("f16_state", ("f32", "f32"), dict(exp_avg_sq_dtype="f16")),
    ("fp8_states", ("f32", "f32"),
     dict(exp_avg_dtype="bf16", exp_avg_sq_dtype="fp8")),
    ("fp8_params", ("fp8", "fp8"), dict(use_master_weights=True)),
    ("fp8_params_no_master", ("f32", "fp8"), dict(weight_decay=0.01)),
    ("low_precision_example", ("f32", "bf16"),
     dict(store_param_remainders=True, exp_avg_dtype="bf16")),
]
_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "f16": (jnp.float16, torch.float16),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _opts(kw, lr=1e-2):
    jkw, tkw = dict(kw), dict(kw)
    for key in ("exp_avg_dtype", "exp_avg_sq_dtype"):
        if key in kw:
            jkw[key], tkw[key] = _DT[kw[key]]
    return j_adam(lr, **jkw), fused_adam(lr, **tkw)


@pytest.mark.parametrize("name,dtypes,kw", ADAM_CASES,
                         ids=[c[0] for c in ADAM_CASES])
def test_fused_adam_step_matches_reference_bitwise(name, dtypes, kw):
    jo, to = _opts(kw)
    jp, tp = _params(dtypes)
    js, ts = jo.init(jp), to.init(tp)
    _same_state(js, ts, "init ")
    rng = np.random.default_rng(1)
    for step in range(5):
        jg, tg = _grads(_shapes(tp), rng)
        jp, js = jo.step(jg, js, jp)
        tp, ts = to.step(tg, ts, tp)
        for n in jp:
            _same(jp[n], tp[n], f"step {step + 1} param {n}")
        _same_state(js, ts, f"step {step + 1} ")


UPDATE_CASES = ["plain", "adamw", "l2", "masters", "bf16_states"]


@pytest.mark.parametrize("name", UPDATE_CASES)
def test_fused_adam_update_matches_reference_bitwise(name):
    _, dtypes, kw = next(c for c in ADAM_CASES if c[0] == name)
    jo, to = _opts(kw)
    jp, tp = _params(dtypes)
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(2)
    for step in range(3):
        jg, tg = _grads(_shapes(tp), rng)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        for n in ju:
            _same(ju[n], tu[n], f"step {step + 1} update {n}")
        jp, tp = optax.apply_updates(jp, ju), apply_updates(tp, tu)
        for n in jp:
            _same(jp[n], tp[n], f"step {step + 1} param {n}")
        _same_state(js, ts, f"step {step + 1} ")


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_stateless_update_matches_reference_bitwise(state_dtype):
    kw = {} if state_dtype == "f32" else dict(exp_avg_dtype="bf16")
    jo, to = _opts(kw)
    jp, tp = _params(("f32", "bf16"))
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(3)
    for step in range(3):
        jg, tg = _grads(_shapes(tp), rng)
        jg = {n: g.astype(jp[n].dtype) for n, g in jg.items()}
        tg = {n: g.to(tp[n].dtype) for n, g in tg.items()}
        ju, js = jo.update(jg, js)
        tu, ts = to.update(tg, ts)
        for n in ju:
            assert tu[n].dtype == tg[n].dtype
            _same(ju[n], tu[n], f"step {step + 1} delta {n}")
        _same_state(js, ts, f"step {step + 1} ")


def test_remainders_reconstruct_the_f32_trajectory():
    """bf16 params and int16 remainders recombine into the f32 masters of
    the port's own f32 paths, bit for bit, as the reference's test
    (tests/test_optim_ce.py) holds the reference."""
    rng = np.random.default_rng(4)
    vals = {"b": rng.standard_normal(96), "w": rng.standard_normal((64, 96))}
    p32 = {n: torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float()
           for n, v in vals.items()}
    p16 = {n: v.to(torch.bfloat16) for n, v in p32.items()}
    lp = fused_adam(1e-2, weight_decay=0.01, store_param_remainders=True)
    ref = fused_adam(1e-2, weight_decay=0.01)
    masters = fused_adam(1e-2, weight_decay=0.01, use_master_weights=True)
    s_lp, s_ref, s_m = lp.init(p16), ref.init(p32), masters.init(p16)
    pm = dict(p16)
    for _ in range(10):
        g = {n: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)) for n, v in p32.items()}
        p16, s_lp = lp.step(g, s_lp, p16)
        p32, s_ref = ref.step(g, s_ref, p32)
        pm, s_m = masters.step(g, s_m, pm)
    for n in p16:
        rem = s_lp.master[n]
        assert rem.dtype == torch.int16
        whole = _combine_master(p16[n], rem)
        assert torch.equal(whole, p32[n]) and torch.equal(whole, s_m.master[n])
        # The parameter is the master's high half, truncated.
        assert torch.equal(p16[n].view(torch.int16),
                           (whole.view(torch.int32) >> 16).to(torch.int16))


def test_remainder_split_is_bitwise_on_extremes():
    words = torch.tensor([0, 1, 0x7FFF, 0x8000, 0xFFFF, 0x3F80FFFF,
                          -0x40800001, 0x7F7FFFFF, -1, -0x80000000],
                         dtype=torch.int64).to(torch.int32)
    masters = words.view(torch.float32).reshape(2, 5)
    lp = fused_adam(store_param_remainders=True)
    from transformerengine_tpu_torch.optimizers.fused_adam import (
        _split_master)
    p, rem = _split_master(masters)
    assert p.dtype == torch.bfloat16 and rem.dtype == torch.int16
    assert torch.equal(_combine_master(p, rem).view(torch.int32),
                       masters.view(torch.int32))
    assert lp.init({"w": p}).master["w"].dtype == torch.int16


def test_update_refusals_and_tree_guard():
    jp, tp = _params(("f32", "bf16"))
    rng = np.random.default_rng(5)
    jg, tg = _grads(_shapes(tp), rng)
    jo, to = _opts(dict(store_param_remainders=True))
    with pytest.raises(ValueError, match="exact-apply path"):
        jo.update(jg, jo.init(jp), jp)
    with pytest.raises(ValueError, match="exact-apply path"):
        to.update(tg, to.init(tp), tp)
    jq, tq = _params(("f32", "fp8"))
    jo, to = _opts(dict(use_master_weights=True))
    with pytest.raises(ValueError, match="quantized param leaves"):
        jo.update(jg, jo.init(jq), jq)
    with pytest.raises(ValueError, match="quantized param leaves"):
        to.update(tg, to.init(tq), tq)
    # Without params the update takes no masters (the reference asserts).
    with pytest.raises(AssertionError):
        jo.update(jg, jo.init(jp))
    with pytest.raises(ValueError, match="neither master"):
        to.update(tg, to.init(tp))
    # A gradient tree that does not match the params.
    jo, to = _opts({})
    with pytest.raises(AssertionError, match="do not match"):
        jo.step({"w": jg["w"]}, jo.init(jp), jp)
    with pytest.raises(ValueError, match="do not match"):
        to.step({"w": tg["w"]}, to.init(tp), tp)
    with pytest.raises(ValueError, match="do not match"):
        to.step({"w": tg["w"], "x": tg["b"]}, to.init(tp), tp)


def test_apply_writes_the_step_into_the_module_in_place():
    """``apply`` runs ``step`` and copies into the parameter objects: the
    parameters stay the same objects, their values and the state equal
    the functional step's."""
    model = torch.nn.Linear(16, 8).to(torch.bfloat16)
    ids = {n: id(p) for n, p in model.named_parameters()}
    opt = fused_adam(1e-2, store_param_remainders=True, weight_decay=0.01)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, ref_state = opt.init(model), opt.init(params)
    rng = np.random.default_rng(6)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)).to(p.dtype)
        params, ref_state = opt.step(grads_of(model), ref_state, params)
        state = opt.apply(model, state)
    for n, p in model.named_parameters():
        assert id(p) == ids[n] and torch.equal(p.detach(), params[n])
    for part in ("mu", "nu", "master"):
        for n, t in getattr(state, part).items():
            assert torch.equal(t, getattr(ref_state, part)[n])
    assert int(state.step) == 3


SGD_CASES = [dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
             dict(momentum=0.9, nesterov=True, weight_decay=0.01)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kw", SGD_CASES,
                         ids=["plain", "momentum", "nesterov", "decay"])
def test_fused_sgd_matches_reference_optax_chain_bitwise(kw, dtype):
    jo, to = j_sgd(0.1, **kw), fused_sgd(0.1, **kw)
    jp, tp = _params((dtype, dtype))
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(7)
    for step in range(3):
        jg, tg = _grads(_shapes(tp), rng)
        jg = {n: g.astype(jp[n].dtype) for n, g in jg.items()}
        tg = {n: g.to(tp[n].dtype) for n, g in tg.items()}
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        for n in ju:
            _same(ju[n], tu[n], f"step {step + 1} update {n}")
        jp, tp = optax.apply_updates(jp, ju), apply_updates(tp, tu)
        for n in jp:
            _same(jp[n], tp[n], f"step {step + 1} param {n}")


# Newton-Schulz runs five bf16 iterations: XLA's and PyTorch's CPU bf16
# products round their f32 sums differently in a few elements, and the
# iteration carries that. Each element within this share of the
# output's largest |value| (readings below 2^-7; one bf16 step at the
# largest values is 2^-8 of them).
NS_RTOL = 2 ** -5


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (48, 48)])
def test_newton_schulz_matches_reference(shape):
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_newton_schulz(jnp.asarray(g)), np.float32)
    got = newton_schulz(torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= NS_RTOL, err
    # Orthogonalized: singular values pushed toward 1.
    sv = np.linalg.svd(got.numpy(), compute_uv=False)
    assert sv.min() > 0.5 and sv.max() < 1.5


@pytest.mark.parametrize("nesterov", [True, False])
def test_muon_matches_reference(nesterov):
    rng = np.random.default_rng(9)
    p = {"b": rng.standard_normal(16).astype(np.float32),
         "w": rng.standard_normal((32, 16)).astype(np.float32)}
    jo, to = j_muon(0.02, nesterov=nesterov), muon(0.02, nesterov=nesterov)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jg, tg = _grads({n: v.shape for n, v in p.items()}, rng)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        # The momentum is f32 arithmetic: bitwise. The 1-D leaf's update
        # is the momentum's: bitwise. The 2-D one is orthogonalized in
        # bf16: within NS_RTOL.
        for n in p:
            _same(js[n], ts[n], f"momentum {n}")
        _same(ju["b"], tu["b"], "update b")
        want = np.asarray(ju["w"])
        err = np.abs(tu["w"].numpy() - want).max() / np.abs(want).max()
        assert err <= NS_RTOL, err


def _tree():
    rng = np.random.default_rng(10)
    jt = {"a": rng.standard_normal((33, 17)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32) * 5,
          "c": rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16)}
    return ({n: jnp.asarray(v) for n, v in jt.items()},
            {n: _to_torch(v) for n, v in jt.items()})


# Sums: XLA and PyTorch reduce a leaf's squares in other orders, so the
# norms agree to a few f32 ulps.
NORM_RTOL = 1e-6


@pytest.mark.parametrize("per_tensor", [False, True])
def test_l2norms_match_reference(per_tensor):
    jt, tt = _tree()
    for j, t in ((j_l2norm(jt, per_tensor=per_tensor),
                  multi_tensor_l2norm(tt, per_tensor=per_tensor)),
                 (j_unscale_l2norm(jt, 0.25, per_tensor=per_tensor),
                  multi_tensor_unscale_l2norm(tt, 0.25,
                                              per_tensor=per_tensor))):
        jn, tn = (j, t) if per_tensor else ((j, None), (t, None))
        np.testing.assert_allclose(float(tn[0]), float(jn[0]),
                                   rtol=NORM_RTOL)
        if per_tensor:
            for n in jt:
                np.testing.assert_allclose(float(tn[1][n]),
                                           float(jn[1][n]), rtol=NORM_RTOL)


def test_scale_and_clip_match_reference():
    jt, tt = _tree()
    for n, j in j_scale(jt, 0.3).items():
        _same(j, multi_tensor_scale(tt, 0.3)[n], f"scale {n}")
    for max_norm in (1.0, 1e3):
        jc, jn = j_clip(jt, max_norm)
        tc, tn = clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=NORM_RTOL)
        # The same factor gives the same words; a factor one ulp apart
        # moves an f32 leaf by at most that share.
        for n in jt:
            np.testing.assert_allclose(
                tc[n].float().numpy(), np.asarray(jc[n], np.float32),
                rtol=2 ** -7 if tt[n].dtype == torch.bfloat16 else 4e-7)
        if max_norm > float(jn):
            for n in jt:
                _same(jc[n], tc[n], f"unclipped {n}")


def test_multi_tensor_functions_take_a_module():
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
    model(torch.ones(3, 8)).sum().backward()
    grads = grads_of(model)
    assert torch.equal(multi_tensor_l2norm(model), multi_tensor_l2norm(grads))
    clipped, norm = clip_by_global_norm(model, 1e-3)
    assert torch.equal(norm, multi_tensor_l2norm(grads))
    assert float(multi_tensor_l2norm(clipped)) == pytest.approx(1e-3,
                                                                rel=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(margin=1.0),
                                dict(epsilon=1e-3), dict(pow_2_scales=True)],
                         ids=["plain", "margin", "epsilon", "pow2"])
def test_compute_scale_and_scale_inv_matches_reference(kw):
    amaxes = {"a": np.float32(3.7), "b": np.float32(0.0),
              "c": np.float32(1e-4), "d": np.float32(448.0)}
    js, jinv = j_scales({n: jnp.asarray(a) for n, a in amaxes.items()},
                        448.0, **kw)
    ts, tinv = multi_tensor_compute_scale_and_scale_inv(
        {n: torch.tensor(a) for n, a in amaxes.items()}, 448.0, **kw)
    for n, a in amaxes.items():
        want = np.float32(448.0) / max(a, np.float32(kw.get("epsilon", 0)))
        want = want / np.float32(2.0 ** kw.get("margin", 0.0)) \
            if a > 0 or kw.get("epsilon") else np.float32(1.0)
        if kw.get("pow_2_scales"):
            # The exact power of two below (XLA's CPU exp2 may land an ulp
            # off it; PyTorch's does not).
            want = np.float32(2.0 ** np.floor(np.log2(np.float64(want))))
            np.testing.assert_allclose(float(js[n]), want, rtol=1e-6)
        else:
            _same(js[n], ts[n], f"scale {n}")
            _same(jinv[n], tinv[n], f"scale_inv {n}")
        assert float(ts[n]) == float(want), n
        assert float(tinv[n]) == float(np.float32(1.0) / want), n


def _flat_keys(tree, prefix=""):
    """A reference tree's leaves under the port's state_dict keys."""
    out = {}
    for name, sub in tree.items():
        key = f"layers.{name[len('layer_'):]}" if name.startswith(
            "layer_") else name
        if isinstance(sub, dict):
            out.update(_flat_keys(sub, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = sub
    return out


def _tiny_tree(scan: bool):
    """LLAMA_TINY's params tree (plain or scanned) drawn with numpy in
    the reference's dtypes."""
    jm = JLlama(dataclasses.replace(J_TINY, scan_layers=scan))
    shapes = fnn.meta.unbox(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda s: jnp.asarray((rng.standard_normal(s.shape) * 0.05).astype(
            np.float32)).astype(s.dtype), shapes["params"])


CARRY_CASES = {
    "remainders": dict(store_param_remainders=True, exp_avg_dtype="bf16"),
    "masters_fp8_state": dict(use_master_weights=True,
                              exp_avg_sq_dtype="fp8", weight_decay=0.01),
    "scan_layers": dict(store_param_remainders=True, exp_avg_dtype="bf16"),
}


@pytest.mark.parametrize("case", list(CARRY_CASES))
def test_reference_adam_state_carries_across_mid_trajectory(case):
    """Two reference steps on LLAMA_TINY's tree, then its params and
    AdamState as numpy go through ``load_flax_params`` and
    ``load_flax_opt_state``; one more step on both sides is equal bit for
    bit."""
    scan = case == "scan_layers"
    cfg = dataclasses.replace(LLAMA_TINY, scan_layers=scan)
    jo, to = _opts(CARRY_CASES[case], lr=1e-3)
    jp = _tiny_tree(scan)
    js = jo.init(jp)
    rng = np.random.default_rng(12)

    def jgrads():
        return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)).astype(p.dtype), jp)
    for _ in range(2):
        jp, js = jo.step(jgrads(), js, jp)
    np_state = jax.tree.map(np.asarray, js)
    ts = load_flax_opt_state(np_state, cfg, device="cpu")
    assert isinstance(ts, AdamState) and int(ts.step) == 2
    state = load_flax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    model = LlamaModel(cfg, device="cpu")
    model.load_state_dict(state)
    tp = {n: p.detach() for n, p in model.named_parameters()}
    assert set(tp) == set(ts.mu) == set(ts.master)
    jg = jgrads()
    jg_np = jax.tree.map(np.asarray, jg)
    if scan:
        jg_np = unstack_layers(jg_np, cfg.num_layers)
    tg = flax_state(jg_np, None, "cpu", leaf=lambda n, a: _to_torch(a))
    jp, js = jo.step(jg, js, jp)
    tp, ts = to.step(tg, ts, tp)
    want_p = jax.tree.map(np.asarray, jp)
    want_s = jax.tree.map(np.asarray, js)
    if scan:
        want_p = unstack_layers(want_p, cfg.num_layers)
        want_s = dataclasses.make_dataclass("S", ["step", "mu", "nu",
                                                  "master"])(
            want_s.step, *(unstack_layers(getattr(want_s, k), cfg.num_layers)
                           for k in ("mu", "nu", "master")))
    for key, arr in _flat_keys(want_p).items():
        _same(arr, tp[key], f"param {key}")
    for part in ("mu", "nu", "master"):
        for key, arr in _flat_keys(getattr(want_s, part)).items():
            _same(arr, getattr(ts, part)[key], f"{part} {key}")
    assert int(ts.step) == int(want_s.step) == 3
