"""Per-expert quantization (``quantize/grouped.py``) and
``grouped_dense_gq`` in the port against the JAX package, on the cases of
the reference's ``tests/test_moe.py`` (``TestGroupedQuantizer``): one
current-scaling scale per expert group, an empty group, experts of very
different magnitudes, and the forward and gradients against the
reference's ``custom_vjp`` and against the unquantized product."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.grouped_dense import (
    grouped_dense_gq as j_grouped_dense_gq)
from transformerengine_tpu.quantize.grouped import (
    GroupedQuantizer as JGroupedQuantizer)
from transformerengine_tpu_torch.grouped_dense import grouped_dense_gq
from transformerengine_tpu_torch.quantize.grouped import (
    GroupedQuantizer, grouped_gemm_scaled)

torch.set_num_threads(2)

E4M3 = torch.float8_e4m3fn


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _inputs(sizes, k=32, m=16, seed=0):
    """Rows of experts of very different magnitudes (x 100 and x 0.01),
    and kernels (E, K, M), as the reference's test draws them."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    x = rng.standard_normal((n, k)).astype(np.float32)
    x[: n // 2] *= 100.0
    x[n // 2:] *= 0.01
    w = (rng.standard_normal((len(sizes), k, m)) * 0.1).astype(np.float32)
    return x, w


def test_quantize_rows_per_group_amax():
    x = np.concatenate([np.full((4, 8), 100.0), np.full((4, 8), 0.5)]
                       ).astype(np.float32)
    gq = GroupedQuantizer(E4M3, num_groups=2)
    t = gq.quantize_rows(torch.from_numpy(x), [4, 4])
    j = JGroupedQuantizer(q_dtype=jnp.dtype(jnp.float8_e4m3fn),
                          num_groups=2).quantize_rows(
        jnp.asarray(x), jnp.asarray([4, 4], jnp.int32))
    np.testing.assert_array_equal(t.amax.numpy(), [100.0, 0.5])
    np.testing.assert_array_equal(t.amax.numpy(), np.asarray(j.amax))
    np.testing.assert_array_equal(_bytes(t.data), _bytes(j.data))
    np.testing.assert_array_equal(t.scale_inv.numpy(), np.asarray(j.scale_inv))
    assert float((t.dequantize() - torch.from_numpy(x)).abs().max()) / 100 \
        < 0.01


@pytest.mark.parametrize("sizes", [(8, 0, 8), (5, 7, 4), (6, 6, 0)])
def test_quantizer_bytes_match_reference(sizes):
    """Rows and kernels, payload bytes and scales, with an empty group
    (its amax 0, its scale 1) and rows past the groups counted as the
    last expert's."""
    x, w = _inputs(sizes, seed=sum(sizes))
    e = len(sizes)
    pad = np.concatenate([x, x[:3] * 3])       # 3 rows past the groups
    gq = GroupedQuantizer(E4M3, num_groups=e)
    jq = JGroupedQuantizer(q_dtype=jnp.dtype(jnp.float8_e4m3fn),
                           num_groups=e)
    for rows in (x, pad):
        t = gq.quantize_rows(torch.from_numpy(rows), list(sizes))
        j = jq.quantize_rows(jnp.asarray(rows), jnp.asarray(sizes, jnp.int32))
        np.testing.assert_array_equal(_bytes(t.data), _bytes(j.data))
        np.testing.assert_array_equal(t.scale_inv.numpy(),
                                      np.asarray(j.scale_inv))
        np.testing.assert_array_equal(t.row_scale_inv().numpy(),
                                      np.asarray(j.row_scale_inv()))
    tk = gq.quantize_kernels(torch.from_numpy(w))
    jk = jq.quantize_kernels(jnp.asarray(w))
    np.testing.assert_array_equal(_bytes(tk.data), _bytes(jk.data))
    np.testing.assert_array_equal(tk.scale_inv.numpy(),
                                  np.asarray(jk.scale_inv))
    out = grouped_gemm_scaled(gq.quantize_rows(torch.from_numpy(x),
                                               list(sizes)), tk, list(sizes))
    from transformerengine_tpu.quantize.grouped import (
        grouped_gemm_scaled as j_gemm)
    ref = j_gemm(jq.quantize_rows(jnp.asarray(x),
                                  jnp.asarray(sizes, jnp.int32)), jk,
                 jnp.asarray(sizes, jnp.int32))
    # f32 sums of exact products in another order.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


# The port against the reference's custom_vjp: the same payloads and
# scales, f32 sums of exact products in another order, one rounding to
# the operands' dtype: a few f32 ulps of the largest element.
GQ_RTOL = 1e-6


@pytest.mark.parametrize("sizes", [(8, 0, 8), (5, 7, 4)])
def test_grouped_dense_gq_fwd_bwd(sizes):
    x, w = _inputs(sizes)
    e = len(sizes)
    gs = jnp.asarray(sizes, jnp.int32)
    jq = JGroupedQuantizer(q_dtype=jnp.dtype(jnp.float8_e4m3fn),
                           num_groups=e)

    def jf(x, w):
        return j_grouped_dense_gq(x, w, gs, jq)

    rng = np.random.default_rng(9)
    g = rng.standard_normal((sum(sizes), w.shape[2])).astype(np.float32)
    oj, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ot = grouped_dense_gq(xt, wt, list(sizes), GroupedQuantizer(E4M3, e))
    ot.backward(torch.from_numpy(g))
    for got, ref, what in ((ot, oj, "out"), (xt.grad, dxj, "dx"),
                           (wt.grad, dwj, "dw")):
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=GQ_RTOL * np.abs(ref).max(),
                                   err_msg=what)


def test_per_expert_scales_against_the_unquantized_product():
    """The reference's own test: per-expert scales keep each expert's
    rows accurate where one global scale would not."""
    sizes = (8, 0, 8)
    x, w = _inputs(sizes)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = grouped_dense_gq(xt, wt, list(sizes), GroupedQuantizer(E4M3, 3))
    ref = torch.cat([xt[:8] @ wt[0], xt[8:] @ wt[2]])
    rel = (out - ref).abs() / ref.abs().amax(0).clamp_min(1e-6)
    assert float(rel.detach().max()) < 0.15  # two e4m3 quantizations
    g = torch.autograd.grad((out ** 2).sum(), (xt, wt))
    gr = torch.autograd.grad((ref ** 2).sum(), (xt, wt))
    for a, b in zip(g, gr):
        assert float((a - b).abs().max() / b.abs().max().clamp_min(1e-6)) \
            < 0.1
    with pytest.raises(ValueError, match="groups"):
        grouped_dense_gq(xt, wt, list(sizes), GroupedQuantizer(E4M3, 2))
