"""The port's MoE stack against the JAX package's, on the same numpy
inputs: the router in each of its modes and its aux loss, token dispatch
and combine, the four grouped GEMMs against ``lax.ragged_dot`` and
``ragged_dot_general``, ``grouped_dense`` forward and backward under each
branch against the reference's ``custom_vjp`` (with the quantize calls
each branch makes), ``moe`` and ``MoELayerNormMLP``.

Routing is discontinuous: a near-tie between the k-th and the next
expert's logit can flip on a one-ulp difference. Every input here is
checked to keep that gap far above the f32 sum-order differences of the
router GEMM (a few 1e-7), so both sides route alike.

The reference runs eagerly (no ``jit``): under a fusion XLA may keep the
swiglu's f32 values where the eager reference, like the port, rounds the
grouped GEMM's output to bf16 first."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import transformerengine_tpu as te
from transformerengine_tpu.flax.moe import MoELayerNormMLP as JMoELayer
from transformerengine_tpu.grouped_dense import grouped_dense as j_grouped_dense
from transformerengine_tpu.moe import moe as j_moe
from transformerengine_tpu.ops import router as j_router
from transformerengine_tpu import permutation as j_perm
from transformerengine_tpu.quantize.helper import QuantizerFactory as JFactory
from transformerengine_tpu.quantize.quantizer import (
    noop_quantizer_set as j_noop)
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import permutation as t_perm
from transformerengine_tpu_torch.grouped_dense import grouped_dense
from transformerengine_tpu_torch.moe import moe
from transformerengine_tpu_torch.nn.moe import MoELayerNormMLP
from transformerengine_tpu_torch.ops import quantize_kernels as qk
from transformerengine_tpu_torch.ops import router as t_router
from transformerengine_tpu_torch.ops.grouped_gemm import (
    grouped_gemm, grouped_gemm_dgrad, grouped_gemm_dw, grouped_gemm_tn)
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory
from transformerengine_tpu_torch.quantize.quantizer import (
    Quantizer, noop_quantizer_set)

# The ops package re-exports a function of the module's name.
j_gg = importlib.import_module("transformerengine_tpu.ops.grouped_gemm")

torch.set_num_threads(2)

# Router probabilities: f32 softmax or sigmoid of the same logits, in
# another order of operations; readings up to 1.2e-7.
PROBS_ATOL = 1e-6
# Grouped GEMMs in f32 from bf16 operands, summed in another order;
# readings 1.2e-7 of the largest element.
GEMM_RTOL = 2 ** -20
# bf16 results after f32 GEMMs: one bf16 ulp of the largest element at
# most where an f32 sum rounds to the other side; readings 0.
BF16_RTOL = 2 ** -7
# Gradients through the combine weights (the probabilities, hence the
# router kernel): the reference's VJP of the bf16 product ``expert_out *
# w`` sums over H in bf16, the port's autograd in f32, so a weight's
# gradient differs by a few bf16 ulps, and so do the gradients it feeds
# (x's and the norm scale's through the router); readings of the largest
# element: router kernel 8.5e-3, probabilities 5.8e-3, x 4.3e-3, norm
# scale 3.3e-3.
PROB_GRAD_RTOL = 2 ** -5
# The smallest gap between the k-th and the next selection score that
# the inputs must keep.
MIN_GAP = 1e-5


def _pair(a: np.ndarray, dtype=jnp.bfloat16):
    j = jnp.asarray(np.asarray(a, np.float32)).astype(dtype)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, ref) -> float:
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _gap(scores: np.ndarray, k: int) -> float:
    s = -np.sort(-scores, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


_ROUTER_MODES = {
    "softmax": dict(),
    "pre_softmax": dict(use_pre_softmax=True),
    "sigmoid": dict(score_function="sigmoid"),
    "group_limited": dict(num_groups=4, group_topk=2),
    "bias_and_scaling": dict(expert_bias=True, scaling_factor=2.5),
    "sigmoid_grouped_bias": dict(score_function="sigmoid", num_groups=2,
                                 group_topk=1, expert_bias=True),
}


@pytest.mark.parametrize("mode", sorted(_ROUTER_MODES))
@pytest.mark.parametrize("topk", [1, 2, 3])
def test_router_matches(mode, topk):
    rng = np.random.default_rng(topk)
    t, e = 64, 8
    logits = rng.standard_normal((t, e)).astype(np.float32) * 2
    kw = dict(_ROUTER_MODES[mode])
    bias = None
    if kw.pop("expert_bias", False):
        bias = (rng.standard_normal(e) * 0.3).astype(np.float32)
    scores = 1 / (1 + np.exp(-logits)) if "sigmoid" in mode else logits
    if bias is not None:
        scores = scores + bias
    if "num_groups" not in kw:
        assert _gap(scores, topk) > MIN_GAP
    pj, mj = j_router.fused_topk_with_score_function(
        jnp.asarray(logits), topk, **kw,
        expert_bias=None if bias is None else jnp.asarray(bias))
    pt, mt = t_router.fused_topk_with_score_function(
        torch.from_numpy(logits), topk, **kw,
        expert_bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert (mt.sum(-1) == topk).all()
    assert pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=PROBS_ATOL)


def test_group_limited_routing_keeps_the_best_groups():
    """A token whose best single expert lies in a group that loses on the
    sum of its two best scores does not select it."""
    logits = np.array([[9.0, -8.0, 1.0, 1.2, 2.0, 2.5, -1.0, 0.0]],
                      np.float32)
    for side in ("jax", "torch"):
        if side == "jax":
            _, m = j_router.fused_topk_with_score_function(
                jnp.asarray(logits), 2, num_groups=4, group_topk=2)
        else:
            _, m = t_router.fused_topk_with_score_function(
                torch.from_numpy(logits), 2, num_groups=4, group_topk=2)
        assert np.flatnonzero(np.asarray(m)[0]).tolist() == [4, 5], side


@pytest.mark.parametrize("topk", [1, 2])
def test_compute_routing_and_aux_loss_match(topk):
    rng = np.random.default_rng(5 + topk)
    logits = rng.standard_normal((48, 4)).astype(np.float32)
    assert _gap(logits, topk) > MIN_GAP
    pj, mj, aj = j_router.compute_routing(jnp.asarray(logits), topk,
                                          aux_loss_coeff=3e-2)
    pt, mt, at = t_router.compute_routing(torch.from_numpy(logits), topk,
                                          aux_loss_coeff=3e-2)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=PROBS_ATOL)
    assert at.dtype == torch.float32 and at.dim() == 0
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    # The aux loss's gradient in the logits, through the full softmax.
    lt = torch.from_numpy(logits).requires_grad_()
    t_router.compute_routing(lt, topk)[2].backward()
    gj = jax.grad(lambda l: j_router.compute_routing(l, topk)[2])(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-8)


def _routing(t, e, k, seed, empty=None):
    """A (T, E) routing map of k experts a token, from seeded scores;
    expert ``empty`` gets no token."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((t, e))
    if empty is not None:
        scores[:, empty] = -1e9
    idx = np.argsort(-scores, axis=1)[:, :k]
    m = np.zeros((t, e), bool)
    np.put_along_axis(m, idx, True, axis=1)
    return m


@pytest.mark.parametrize("num_out", [None, "tight"])
def test_dispatch_and_combine_match(num_out):
    t, e, h, k = 40, 6, 32, 2
    m = _routing(t, e, k, 3, empty=4)
    n = t * k if num_out == "tight" else None
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((t, h)))
    dj, auxj = j_perm.token_dispatch(xj, jnp.asarray(m), n)
    dt, auxt = t_perm.token_dispatch(xt, torch.from_numpy(m), n)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(dt), _np(dj))
    for key in ("perm", "inv_perm", "group_sizes", "token_of_slot",
                "valid"):
        np.testing.assert_array_equal(auxt[key].numpy(),
                                      np.asarray(auxj[key]), err_msg=key)
    assert auxt["group_sizes"].tolist()[4] == 0
    assert auxt["group_sizes"].sum() == t * k
    probs = np.where(m, rng.random((t, e)), 0.0).astype(np.float32)
    eoj, eot = _pair(rng.standard_normal((dt.shape[0], h)))
    cj = j_perm.token_combine(eoj, jnp.asarray(probs), auxj)
    ct = t_perm.token_combine(eot, torch.from_numpy(probs), auxt)
    assert ct.dtype == torch.bfloat16 and ct.shape == (t, h)
    np.testing.assert_array_equal(_np(ct), _np(cj))
    # The aliases.
    np.testing.assert_array_equal(
        _np(t_perm.moe_permute(xt, torch.from_numpy(m), n)[0]), _np(dj))
    np.testing.assert_array_equal(
        _np(t_perm.moe_unpermute(eot, torch.from_numpy(probs), auxt)),
        _np(cj))


def test_dispatch_and_combine_gradients_match():
    t, e, h, k = 24, 4, 16, 2
    m = _routing(t, e, k, 9)
    rng = np.random.default_rng(10)
    xj, xt = _pair(rng.standard_normal((t, h)))
    probs = np.where(m, rng.random((t, e)), 0.0).astype(np.float32)
    gj, gt = _pair(rng.standard_normal((t, h)))

    def j_fn(x, p):
        d, aux = j_perm.token_dispatch(x, jnp.asarray(m), t * k)
        return j_perm.token_combine(d * 3, p, aux)

    _, vjp = jax.vjp(j_fn, xj, jnp.asarray(probs))
    dxj, dpj = vjp(gj)
    x1 = xt.clone().requires_grad_()
    p1 = torch.from_numpy(probs).requires_grad_()
    d, aux = t_perm.token_dispatch(x1, torch.from_numpy(m), t * k)
    t_perm.token_combine(d * 3, p1, aux).backward(gt)
    np.testing.assert_array_equal(_np(x1.grad), _np(dxj))
    assert _rel(p1.grad, dpj) <= PROB_GRAD_RTOL, _rel(p1.grad, dpj)


_SIZES = np.array([10, 0, 30, 24, 0, 30, 20, 14], np.int32)


def test_grouped_gemms_match_ragged_dot():
    """The four products, an expert with no rows among them (an empty
    product, and a zero wgrad), rows past the groups giving zeros."""
    rng = np.random.default_rng(1)
    e, k, m = len(_SIZES), 64, 48
    n = int(_SIZES.sum()) + 6
    xj, xt = _pair(rng.standard_normal((n, k)))
    wj, wt = _pair(rng.standard_normal((e, k, m)))
    gj, gt = _pair(rng.standard_normal((n, m)))
    gs = jnp.asarray(_SIZES)
    cases = [
        (grouped_gemm(xt, wt, torch.from_numpy(_SIZES)),
         j_gg.grouped_gemm(xj, wj, gs)),
        (grouped_gemm_tn(xt, wt.transpose(1, 2), _SIZES.tolist()),
         j_gg.grouped_gemm_tn(xj, jnp.swapaxes(wj, 1, 2), gs)),
        (grouped_gemm_dgrad(gt, wt.transpose(1, 2), _SIZES),
         j_gg.grouped_gemm_dgrad(gj, jnp.swapaxes(wj, 1, 2), gs)),
        (grouped_gemm_dw(xt, gt, _SIZES, e),
         j_gg.grouped_gemm_dw(xj, gj, gs, e)),
    ]
    for i, (got, ref) in enumerate(cases):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= GEMM_RTOL, i
    assert not cases[0][0][-6:].any() and not cases[2][0][-6:].any()
    dw = cases[3][0]
    assert not dw[1].any() and not dw[4].any() and dw[0].abs().max() > 0
    # out_dtype rounds the f32 products once.
    bf = grouped_gemm(xt, wt, _SIZES, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(bf), _np(cases[0][0].bfloat16()))


_RECIPES = {"none": (None, None),
            "current": (te.Float8CurrentScaling(), tt.Float8CurrentScaling()),
            "delayed": (te.DelayedScaling(amax_history_len=4),
                        tt.DelayedScaling(amax_history_len=4)),
            "mxfp8": (te.MXFP8BlockScaling(), tt.MXFP8BlockScaling())}
# The quantize calls of one forward and backward: (Quantizer.quantize,
# mxfp8_quantize_1x, mxfp8_qdq_2x_grouped). Tensor scaling quantizes x,
# the kernel and the gradient; MXFP8 quantizes x and the gradient rowwise
# (the 1x kernel each) and the kernel once through the grouped QDQ.
_QUANTIZE_CALLS = {"none": (0, 0, 0), "current": (3, 0, 0),
                   "delayed": (3, 0, 0), "mxfp8": (2, 2, 1)}


def _counting(monkeypatch):
    counts = {"quantize": 0, "1x": 0, "qdq": 0}
    real_q, real_1x, real_qdq = (Quantizer.quantize, qk.mxfp8_quantize_1x,
                                 qk.mxfp8_qdq_2x_grouped)

    def wrap(key, fn):
        def counted(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(Quantizer, "quantize", wrap("quantize", real_q))
    monkeypatch.setattr(qk, "mxfp8_quantize_1x", wrap("1x", real_1x))
    monkeypatch.setattr(qk, "mxfp8_qdq_2x_grouped", wrap("qdq", real_qdq))
    return counts


@pytest.mark.parametrize("recipe,fused", [
    ("none", "0"), ("current", "0"), ("delayed", "0"), ("mxfp8", "0"),
    ("mxfp8", "1")])
def test_grouped_dense_matches_custom_vjp(recipe, fused, monkeypatch):
    """Forward, dx and dW against the reference's custom VJP (its fused
    kernels in interpret mode with ``TE_TPU_FUSED_QUANTIZE=1``, its chain
    with 0), an expert without rows among the groups; under
    DelayedScaling the state the port's backward writes equals the
    quantizer set's cotangent."""
    monkeypatch.setenv("TE_TPU_FUSED_QUANTIZE", fused)
    rng = np.random.default_rng(2)
    e, k, m = 4, 64, 128
    sizes = np.array([40, 0, 56, 32], np.int32)
    n = int(sizes.sum())
    xj, xt = _pair(rng.standard_normal((n, k)))
    wj, wt = _pair(rng.standard_normal((e, k, m)) * 0.1)
    gj, gt = _pair(rng.standard_normal((n, m)))
    j_recipe, t_recipe = _RECIPES[recipe]
    jq = JFactory.create_set(j_recipe) if j_recipe else j_noop
    tq = QuantizerFactory.create_set(t_recipe) if t_recipe \
        else noop_quantizer_set

    def j_fn(x, w, q):
        return j_grouped_dense(x, w, jnp.asarray(sizes), quantizer_set=q)

    out_j, vjp = jax.vjp(j_fn, xj, wj, jq)
    dxj, dwj, dqj = vjp(gj)
    counts = _counting(monkeypatch)
    x1, w1 = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    out = grouped_dense(x1, w1, torch.from_numpy(sizes), quantizer_set=tq)
    out.backward(gt)
    assert out.dtype == x1.grad.dtype == w1.grad.dtype == torch.bfloat16
    for got, ref, what in ((out, out_j, "out"), (x1.grad, dxj, "dx"),
                           (w1.grad, dwj, "dw")):
        assert _rel(got, ref) <= BF16_RTOL, (what, _rel(got, ref))
    assert not w1.grad[1].any()
    assert tuple(counts.values()) == _QUANTIZE_CALLS[recipe]
    if recipe == "delayed":
        for role in ("x", "kernel", "dgrad"):
            for name in ("scale", "amax_history"):
                np.testing.assert_array_equal(
                    getattr(getattr(tq, role), name).numpy(),
                    np.asarray(getattr(getattr(dqj, role), name)),
                    err_msg=f"{role} {name}")
        assert float(tq.x.amax_history.max()) > 0


def test_grouped_dense_forward_without_grad_and_unported_options():
    rng = np.random.default_rng(3)
    sizes = [16, 16]
    _, xt = _pair(rng.standard_normal((32, 32)))
    _, wt = _pair(rng.standard_normal((2, 32, 128)))
    q = QuantizerFactory.create_set(tt.MXFP8BlockScaling())
    with torch.no_grad():
        out = grouped_dense(xt, wt, sizes, quantizer_set=q)
    assert out.grad_fn is None
    x1 = xt.clone().requires_grad_()
    np.testing.assert_array_equal(
        _np(grouped_dense(x1, wt, sizes, quantizer_set=q)), _np(out))
    from transformerengine_tpu_torch.quantize.microbatch import (
        quantize_grouped_kernel)
    cache, _ = quantize_grouped_kernel(wt, q)
    with torch.no_grad():
        cached = grouped_dense(xt, wt, sizes, quantizer_set=q,
                               kernel_cache=cache)
    np.testing.assert_array_equal(_np(cached), _np(out))
    from transformerengine_tpu.quantize.grouped import (
        GroupedQuantizer as JGroupedQuantizer)
    from transformerengine_tpu.grouped_dense import (
        grouped_dense_gq as j_grouped_dense_gq)
    from transformerengine_tpu_torch.grouped_dense import grouped_dense_gq
    from transformerengine_tpu_torch.quantize.grouped import GroupedQuantizer
    xj, wj = (jnp.asarray(_np(a)).astype(jnp.bfloat16) for a in (xt, wt))
    ref = j_grouped_dense_gq(xj, wj, jnp.asarray(sizes, jnp.int32),
                             JGroupedQuantizer(jnp.dtype(jnp.float8_e4m3fn),
                                               num_groups=2))
    got = grouped_dense_gq(xt, wt, sizes,
                           GroupedQuantizer(torch.float8_e4m3fn, 2))
    assert _rel(got, ref) <= BF16_RTOL
    with pytest.raises(NotImplementedError, match="not ported"):
        moe(xt, torch.zeros((32, 2)), wt, wt, ep_axis="ep")


def _moe_inputs(t=64, h=64, e=4, f=64, seed=0):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng.standard_normal((t, h)))
    router = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    uj, ut = _pair(rng.standard_normal((e, h, 2 * f)) / np.sqrt(h))
    dj, dt = _pair(rng.standard_normal((e, f, h)) / np.sqrt(f))
    logits = np.asarray(xj.astype(jnp.float32)) @ router
    return (xj, jnp.asarray(router), uj, dj), (xt, torch.from_numpy(router),
                                               ut, dt), logits


@pytest.mark.parametrize("recipe", ["none", "mxfp8", "current"])
def test_moe_matches(recipe):
    """``moe`` forward (output and aux loss) and the gradients of x, the
    router and both expert kernels."""
    jin, tin, logits = _moe_inputs(seed=21)
    assert _gap(logits, 2) > MIN_GAP
    j_recipe, t_recipe = _RECIPES[recipe]
    jq = tuple(JFactory.create_set(j_recipe) if j_recipe else j_noop
               for _ in range(2))
    tq = tuple(QuantizerFactory.create_set(t_recipe) if t_recipe
               else noop_quantizer_set for _ in range(2))
    rng = np.random.default_rng(22)
    gj, gt = _pair(rng.standard_normal(jin[0].shape))

    def j_fn(*args):
        out, aux = j_moe(*args, topk=2, quantizer_sets=jq)
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32)) \
            + 100 * aux, (out, aux)

    (_, (out_j, aux_j)), grads_j = jax.value_and_grad(
        j_fn, argnums=(0, 1, 2, 3), has_aux=True)(*jin)
    leaves = [t.clone().requires_grad_() for t in tin]
    out, aux = moe(*leaves, topk=2, quantizer_sets=tq)
    ((out.float() * gt.float()).sum() + 100 * aux).backward()
    assert out.dtype == torch.bfloat16 and out.shape == tin[0].shape
    assert _rel(out, out_j) <= BF16_RTOL
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=1e-6)
    for leaf, ref, name in zip(leaves, grads_j, ("x", "router", "up",
                                                 "down")):
        assert leaf.grad.dtype == leaf.dtype
        rtol = PROB_GRAD_RTOL if name in ("x", "router") else BF16_RTOL
        assert _rel(leaf.grad, ref) <= rtol, (name, _rel(leaf.grad, ref))


def _flat(tree, prefix=""):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(sub, np.float32)
    return out


def _load(module, params):
    state = {k: torch.from_numpy(v.copy()).to(module.state_dict()[k].dtype)
             for k, v in _flat(params).items()}
    module.load_state_dict(state)
    return module


def test_moe_layer_matches_flax_module():
    """``MoELayerNormMLP`` against the Flax module with the same
    parameters (names included): output, aux loss and every gradient."""
    h, e, f = 64, 4, 96
    rng = np.random.default_rng(31)
    xj, xt = _pair(rng.standard_normal((2, 32, h)))
    jm = JMoELayer(num_experts=e, topk=2, intermediate_dim=f, epsilon=1e-5)
    variables = jm.init(jax.random.PRNGKey(4), xj)
    params = jax.tree.map(np.asarray, meta.unbox(variables["params"]))
    layer = _load(MoELayerNormMLP(h, f, num_experts=e, topk=2, epsilon=1e-5,
                                  device="cpu"), params)
    assert layer.router_kernel.dtype == torch.float32
    assert layer.wi_kernel.shape == (e, h, 2 * f)
    gj, gt = _pair(rng.standard_normal((2, 32, h)))

    def j_loss(p):
        out, mut = jm.apply({"params": p}, xj, mutable=["intermediates"])
        aux = jax.tree.leaves(mut["intermediates"])[0]
        return jnp.sum(out.astype(jnp.float32)
                       * gj.astype(jnp.float32)) + 100 * aux, (out, aux)

    (_, (out_j, aux_j)), grads_j = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    out, aux = layer(xt)
    ((out.float() * gt.float()).sum() + 100 * aux).backward()
    assert _rel(out, out_j) <= BF16_RTOL
    np.testing.assert_allclose(float(aux.detach()), float(aux_j),
                               rtol=1e-6)
    grads_j = _flat(jax.tree.map(np.asarray, grads_j))
    for name, p in layer.named_parameters():
        rtol = PROB_GRAD_RTOL if name in ("router_kernel", "ln.scale") \
            else BF16_RTOL
        assert _rel(p.grad, grads_j[name]) <= rtol, (name, _rel(
            p.grad, grads_j[name]))


def test_topk_all_experts_is_the_dense_mixture():
    """topk == E: the output is the probability-weighted sum of every
    expert's MLP on the normed input (the reference's own identity),
    in f32."""
    e, h, f = 3, 16, 24
    torch.manual_seed(0)
    layer = MoELayerNormMLP(h, f, num_experts=e, topk=e, dtype=torch.float32,
                            device="cpu")
    x = torch.randn((1, 8, h))
    with torch.no_grad():
        out, _ = layer(x)
        y = layer.ln(x).reshape(-1, h)
        probs = torch.softmax(y @ layer.router_kernel, dim=-1)
        ref = torch.zeros((8, h))
        for i in range(e):
            z = y @ layer.wi_kernel[i]
            a = torch.nn.functional.silu(z[:, :f]) * z[:, f:]
            ref += probs[:, i:i + 1] * (a @ layer.wo_kernel[i])
    assert float((out.reshape(-1, h) - ref).abs().max()) < 1e-5
