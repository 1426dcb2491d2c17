"""The MoE forward without a gradient on device-side group sizes: the
port's bf16 grouped products (``grouped_gemm``, ``grouped_gemm_tn``,
``grouped_dense``) and ``moe`` against the JAX package's ``ragged_dot``
forms and ``moe``, with ``host_sizes`` made to raise, which shows that no
group size is read on the host. Tensor-scaled operands and the gradient
keep the host-sized loop.

Inputs are seeded with numpy and held as bf16. Routing is discontinuous,
so every input keeps the gap between the k-th and the next expert's
logit far above the router GEMM's f32 sum-order differences."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.grouped_dense import grouped_dense as j_grouped_dense
from transformerengine_tpu.moe import moe as j_moe
from transformerengine_tpu import permutation as j_perm
from transformerengine_tpu.quantize.helper import QuantizerFactory as JFactory
import transformerengine_tpu_torch as tt
from transformerengine_tpu_torch import grouped_dense as t_gd
from transformerengine_tpu_torch import moe as t_moe
from transformerengine_tpu_torch import permutation as t_perm
from transformerengine_tpu_torch.ops import grouped_gemm as t_gg
from transformerengine_tpu_torch.quantize.helper import QuantizerFactory

# The ops package re-exports a function of the module's name.
j_gg = importlib.import_module("transformerengine_tpu.ops.grouped_gemm")

torch.set_num_threads(2)

# Both sides sum exact bf16 products in f32, in other orders, and round
# once to bf16: an element may land one bf16 ulp (at most 2^-7 of its
# magnitude) away, so 2^-7 of the largest element bounds the difference.
BF16_RTOL = 2 ** -7
# The smallest gap between the k-th and the next router logit.
MIN_GAP = 1e-5
# Sizes with empty experts; the rows are 6 more than the groups hold.
_SIZES = np.array([10, 0, 30, 24, 0, 30, 20, 14], np.int32)
_PAST = 6


def _pair(a: np.ndarray):
    j = jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, ref) -> float:
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / np.abs(ref).max())


def _no_host_reads(monkeypatch):
    def refuse(sizes):
        raise AssertionError("a group size was read on the host")
    for mod in (t_gg, t_gd, t_moe):
        monkeypatch.setattr(mod, "host_sizes", refuse)


@pytest.mark.parametrize("form", ["grouped_gemm", "grouped_gemm_tn"])
def test_device_sized_products_match_ragged_dot(form, monkeypatch):
    """bf16 out on an (E,) int32 tensor of sizes: the JAX form's f32
    product rounded to bf16, the port's own host-sized loop, and exact
    zeros past the groups."""
    rng = np.random.default_rng(2)
    e, k, m = len(_SIZES), 64, 48
    n = int(_SIZES.sum()) + _PAST
    xj, xt = _pair(rng.standard_normal((n, k)))
    wj, wt = _pair(rng.standard_normal((e, k, m)) / np.sqrt(k))
    gs = jnp.asarray(_SIZES)
    if form == "grouped_gemm":
        ref = j_gg.grouped_gemm(xj, wj, gs)
        args = (xt, wt)
    else:
        ref = j_gg.grouped_gemm_tn(xj, jnp.swapaxes(wj, 1, 2), gs)
        args = (xt, wt.transpose(1, 2).contiguous())
    fn = getattr(t_gg, form)
    loop = fn(*args, _SIZES.tolist(), torch.bfloat16)
    _no_host_reads(monkeypatch)
    got = fn(*args, torch.from_numpy(_SIZES), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, m)
    assert _rel(got, ref.astype(jnp.bfloat16)) <= BF16_RTOL
    assert _rel(got, loop) <= BF16_RTOL
    assert not got[-_PAST:].any()


@pytest.mark.parametrize("recipe", ["none", "mxfp8"])
def test_grouped_dense_without_grad_on_device_sizes(recipe, monkeypatch):
    """``grouped_dense`` under ``torch.no_grad`` with a size tensor, plain
    and MXFP8 (dequantized to bf16, no scale after), against the JAX
    ``grouped_dense`` forward."""
    rng = np.random.default_rng(4)
    sizes = np.array([32, 0, 64, 32], np.int32)
    xj, xt = _pair(rng.standard_normal((int(sizes.sum()), 64)))
    wj, wt = _pair(rng.standard_normal((len(sizes), 64, 96)) / 8)
    jq = JFactory.create_set(te.MXFP8BlockScaling()) if recipe == "mxfp8" \
        else None
    tq = QuantizerFactory.create_set(tt.MXFP8BlockScaling()) \
        if recipe == "mxfp8" else None
    ref = j_grouped_dense(xj, wj, jnp.asarray(sizes),
                          **({"quantizer_set": jq} if jq else {}))
    _no_host_reads(monkeypatch)
    with torch.no_grad():
        got = t_gd.grouped_dense(xt, wt, torch.from_numpy(sizes),
                                 **({"quantizer_set": tq} if tq else {}))
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref) <= BF16_RTOL


def test_tensor_scaled_products_keep_the_host_loop(monkeypatch):
    """Tensor-scaled operands need the f32 product and then the scale:
    they read the sizes on the host, without a gradient too."""
    rng = np.random.default_rng(5)
    sizes = torch.tensor([16, 0, 16], dtype=torch.int32)
    _, xt = _pair(rng.standard_normal((32, 32)))
    _, wt = _pair(rng.standard_normal((3, 32, 64)))
    reads = []
    real = t_gg.host_sizes
    monkeypatch.setattr(t_gg, "host_sizes",
                        lambda g: reads.append(1) or real(g))
    q = QuantizerFactory.create_set(tt.Float8CurrentScaling())
    with torch.no_grad():
        out = t_gd.grouped_dense(xt, wt, sizes, quantizer_set=q)
    assert reads == [1] and out.dtype == torch.bfloat16


def _moe_inputs(t, h, e, f, topk, seed):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng.standard_normal((t, h)))
    router = (rng.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32)
    uj, ut = _pair(rng.standard_normal((e, h, 2 * f)) / np.sqrt(h))
    dj, dt = _pair(rng.standard_normal((e, f, h)) / np.sqrt(f))
    logits = np.asarray(xj.astype(jnp.float32)) @ router
    s = -np.sort(-logits, axis=-1)
    assert float((s[:, topk - 1] - s[:, topk]).min()) > MIN_GAP
    return (xj, jnp.asarray(router), uj, dj), (xt, torch.from_numpy(router),
                                               ut, dt)


# Small Mixtral-like (SwiGLU, top-2 of 8) and GPT-OSS-like (the clamped
# SwiGLU, top-4 of 8) widths.
_MOE = {"mixtral": dict(t=48, h=64, e=8, f=96, topk=2, act="swiglu",
                        seed=41),
        "gptoss": dict(t=48, h=64, e=8, f=64, topk=4,
                       act="clamped_swiglu", seed=43)}


@pytest.mark.parametrize("name", sorted(_MOE))
def test_moe_without_grad_reads_no_size(name, monkeypatch):
    c = _MOE[name]
    jin, tin = _moe_inputs(c["t"], c["h"], c["e"], c["f"], c["topk"],
                           c["seed"])
    out_j, aux_j = j_moe(*jin, topk=c["topk"], activation_type=c["act"])
    _no_host_reads(monkeypatch)
    with torch.no_grad():
        out, aux = t_moe.moe(*tin, topk=c["topk"], activation_type=c["act"])
    assert out.dtype == torch.bfloat16 and out.shape == tin[0].shape
    assert _rel(out, out_j) <= BF16_RTOL
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("topk", [2, 4])
def test_top_k_combine_matches(topk):
    """The top-k combine (each token's ``topk`` slots summed over a (T,
    topk) grid, no (T, E) one) against the JAX ``token_combine``, within
    one bf16 rounding (both sum in f32, in other orders), and against the
    port's own (T, E) grid exactly (the same terms in the same order)."""
    t, e, h = 40, 8, 32
    rng = np.random.default_rng(50 + topk)
    m = np.zeros((t, e), bool)
    np.put_along_axis(m, np.argsort(rng.random((t, e)), axis=1)[:, :topk],
                      True, axis=1)
    probs = np.where(m, rng.random((t, e)), 0.0).astype(np.float32)
    xj, xt = _pair(rng.standard_normal((t, h)))
    _, auxj = j_perm.token_dispatch(xj, jnp.asarray(m), t * topk)
    _, auxt = t_perm.token_dispatch(xt, torch.from_numpy(m), t * topk)
    eoj, eot = _pair(rng.standard_normal((t * topk, h)))
    ref = j_perm.token_combine(eoj, jnp.asarray(probs), auxj)
    got = t_perm.token_combine(eot, torch.from_numpy(probs), auxt,
                               topk=topk)
    grid = t_perm.token_combine(eot, torch.from_numpy(probs), auxt)
    assert got.dtype == torch.bfloat16 and got.shape == (t, h)
    assert _rel(got, ref) <= BF16_RTOL
    assert torch.equal(got, grid)
    with pytest.raises(ValueError, match="slots"):
        t_perm.token_combine(eot[:-1], torch.from_numpy(probs), auxt,
                             topk=topk)
