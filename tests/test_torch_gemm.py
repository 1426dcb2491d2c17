"""The port's scaled matmuls (ops/gemm.py) against the JAX package's, for
per-tensor-scaled and plain operands, and the routing of resident-weight
products to the decode kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformerengine_tpu as te
from transformerengine_tpu.ops import gemm as jgemm
from transformerengine_tpu.ops.decode_matmul import (
    use_decode_matvec as j_use_decode_matvec)
from transformerengine_tpu.quantize.helper import QuantizerFactory
from transformerengine_tpu.quantize.prequant import (
    prequantize_kernel_array as j_prequantize_kernel_array)
from transformerengine_tpu.quantize.quantizer import QuantizeLayout as JLayout
from transformerengine_tpu_torch import Float8CurrentScaling
from transformerengine_tpu_torch.ops import gemm
from transformerengine_tpu_torch.ops.decode_matmul import use_decode_matvec
from transformerengine_tpu_torch.quantize.prequant import (
    prequantize_kernel_array)
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout)

torch.set_num_threads(2)


def _pair(x: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.tensor(np.asarray(xj, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m,n,k", [(8, 2048, 1024), (32, 1024, 4096),
                                   (33, 2048, 1024), (8, 512, 1024),
                                   (8, 2048, 512), (8, 2048, 1040),
                                   (1, 6144, 4096)])
def test_use_decode_matvec_routes_like_the_reference(m, n, k, monkeypatch):
    # Off the TPU the reference routes only when asked to.
    monkeypatch.setenv("TE_TPU_DECODE_MATVEC", "1")
    assert use_decode_matvec(m, n, k) == j_use_decode_matvec(m, n, k)


# The plain (recipe=None) resident layout takes no activation quantizer.
@pytest.mark.parametrize("recipe,x_quant", [("fp8", False), ("fp8", True),
                                            (None, False)])
@pytest.mark.parametrize("m", [8, 64])
def test_prequant_dot_matches_jax(recipe, x_quant, m, monkeypatch):
    rng = np.random.default_rng(0)
    k, n = 1024, 2048
    xj, xt = _pair(rng.standard_normal((m, k)))
    kj, kt = _pair(rng.standard_normal((k, n)) / 32)
    pj = j_prequantize_kernel_array(
        kj, te.Float8CurrentScaling() if recipe else None)
    pt = prequantize_kernel_array(
        kt, Float8CurrentScaling() if recipe else None)
    qj = (QuantizerFactory.create(te.Float8CurrentScaling(), "x",
                                  JLayout.ROWWISE) if x_quant else None)
    qt = (CurrentScaleQuantizer(torch.float8_e4m3fn, QuantizeLayout.ROWWISE)
          if x_quant else None)
    routed = []
    real = gemm.decode_tn_matvec
    monkeypatch.setattr(gemm, "decode_tn_matvec",
                        lambda *a: routed.append(1) or real(*a))
    oj = np.asarray(jgemm.prequant_dot(xj, pj.colwise, qj), np.float32)
    ot = gemm.prequant_dot(xt, pt.colwise, qt)
    assert ot.dtype == torch.float32 and ot.shape == (m, n)
    assert bool(routed) == (m <= 32)
    # Exact products on both sides (bf16 or fp8 operands, f32 sums); only
    # the order of the f32 sums over K = 1024 differs.
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-5 * np.abs(oj).max())


def test_f32_resident_weight_takes_the_plain_gemm(monkeypatch):
    """The decode kernel takes e4m3 or bf16 weights: a plain f32 resident
    weight (an f32 model prequantized with recipe=None) goes to the plain
    GEMM at decode shapes, and the kernel's wrapper refuses it."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2048, 1024)).astype(np.float32))

    def routed(*args):
        raise AssertionError("an f32 weight reached the decode kernel")

    monkeypatch.setattr(gemm, "decode_tn_matvec", routed)
    out = gemm.resident_dot(x, w)
    torch.testing.assert_close(out, x @ w.t(), rtol=0, atol=0)
    monkeypatch.undo()
    with pytest.raises(TypeError, match="e4m3 or bf16"):
        gemm.decode_tn_matvec(x, w)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("lhs_cdim,rhs_cdim",[(1, 0), (1, 1), (0, 0),
                                               (0, 1)])
def test_q_dot_any_contraction_axes(lhs_cdim, rhs_cdim, scaled):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((48, 40) if lhs_cdim == 1 else (40, 48))
    b = rng.standard_normal((40, 24) if rhs_cdim == 0 else (24, 40))
    (aj, at), (bj, bt) = _pair(a), _pair(b)
    if scaled:
        jq = QuantizerFactory.create(te.Float8CurrentScaling(), "x",
                                     JLayout.ROWWISE)
        tq = CurrentScaleQuantizer(torch.float8_e4m3fn)
        aj, bj = jq.quantize(aj), jq.quantize(bj)
        at, bt = tq.quantize(at), tq.quantize(bt)
    oj = np.asarray(jgemm.q_dot(aj, bj, lhs_cdim, rhs_cdim), np.float32)
    ot = gemm.q_dot(at, bt, lhs_cdim, rhs_cdim)
    assert ot.shape == (48, 24) and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-5 * np.abs(oj).max())
