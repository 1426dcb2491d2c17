"""The port's per-tensor quantize core and prequantization against the JAX
package: payload bytes, scale_inv and amax bit-exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import transformerengine_tpu as te
from transformerengine_tpu.models.llama import (
    LLAMA_TINY as J_TINY, LlamaModel as JLlama)
from transformerengine_tpu.quantize import qmath as jq
from transformerengine_tpu.quantize.dtypes import float8_e4m3 as j_e4m3
from transformerengine_tpu.quantize.helper import QuantizerFactory
from transformerengine_tpu.quantize.prequant import (
    prequantize_kernels as j_prequantize)
from transformerengine_tpu.quantize.quantizer import (
    QuantizeLayout as JLayout)
from transformerengine_tpu_torch import Float8CurrentScaling
from transformerengine_tpu_torch.models.llama import (
    LLAMA_TINY, LlamaModel, load_flax_params)
from transformerengine_tpu_torch.quantize import qmath
from transformerengine_tpu_torch.quantize.prequant import (
    PrequantizedKernel, prequantize_kernels)
from transformerengine_tpu_torch.quantize.quantizer import (
    CurrentScaleQuantizer, QuantizeLayout)

torch.set_num_threads(2)


def _bytes(a) -> np.ndarray:
    """Raw bytes of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return a.view(np.uint8)


def _inputs(kind: str, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3.0
    if kind == "zeros":
        x = np.zeros_like(x)
    elif kind == "outlier":
        x[5, 7] = 1e4            # one value sets the scale
        x[9, 1] = -2.5e3
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "zeros", "outlier"])
def test_current_scale_quantize_bit_exact(kind, dtype):
    xj, xt = _inputs(kind, dtype)
    dj, sj, aj = jq.current_scale_quantize(xj, j_e4m3)
    dt, st, at = qmath.current_scale_quantize(xt, torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(dj), _bytes(dt))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())


def test_saturate_cast_clips_before_the_cast():
    vals = np.array([0.0, 1e-9, 0.3, 447.9, 448.0, 448.1, 463.9, 500.0,
                     1e6, -1e6, -449.0, -0.0], np.float32)
    dj = jq.saturate_cast(jnp.asarray(vals), j_e4m3)
    dt = qmath.saturate_cast(torch.from_numpy(vals), torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(dj), _bytes(dt))
    assert float(dt.float().abs().max()) == 448.0


@pytest.mark.parametrize("amax", [0.0, 3.5, float("inf")])
def test_scale_from_amax(amax):
    sj = jq.compute_scale_from_amax(jnp.float32(amax), j_e4m3)
    st = qmath.compute_scale_from_amax(amax, torch.float8_e4m3fn)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


def test_colwise_quantizer_matches_jax():
    xj, xt = _inputs("normal", jnp.bfloat16)
    qj = QuantizerFactory.create(te.Float8CurrentScaling(), "kernel",
                                 JLayout.COLWISE).quantize(xj)
    qt = CurrentScaleQuantizer(torch.float8_e4m3fn,
                               QuantizeLayout.COLWISE).quantize(xt)
    assert qt.layout == qj.layout == "T"
    assert tuple(qt.data.shape) == tuple(qj.data.shape) == (96, 64)
    np.testing.assert_array_equal(_bytes(qj.data), _bytes(qt.data))
    np.testing.assert_array_equal(np.asarray(qj.scale_inv), qt.scale_inv)
    np.testing.assert_allclose(np.asarray(qj.dequantize(), np.float32),
                               qt.dequantize().float().numpy())


@pytest.mark.parametrize("recipe", ["fp8", None])
def test_prequantize_kernels_payload_matches_jax(recipe):
    cfg_j = dataclasses.replace(J_TINY)
    jm = JLlama(config=cfg_j)
    variables = jm.init(jax.random.PRNGKey(3), jnp.ones((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    model = LlamaModel(LLAMA_TINY, device="cpu")
    model.load_state_dict(load_flax_params(params, LLAMA_TINY, device="cpu"))
    jvars = j_prequantize(
        {"params": params}, te.Float8CurrentScaling() if recipe else None)
    prequantize_kernels(model, Float8CurrentScaling() if recipe else None)
    ported = {n: m for n, m in model.named_modules()
              if isinstance(m, PrequantizedKernel)}
    assert len(ported) == 4 * LLAMA_TINY.num_layers
    for name, pk in ported.items():
        node = jvars["prequant"]
        for part in name.replace("layers.", "layer_").split("."):
            node = node[part]
        if recipe:
            np.testing.assert_array_equal(_bytes(node.colwise.data),
                                          _bytes(pk.data))
            np.testing.assert_array_equal(np.asarray(node.colwise.scale_inv),
                                          pk.scale_inv.numpy())
        else:
            np.testing.assert_array_equal(
                np.asarray(node.colwise, np.float32), pk.data.float().numpy())
        assert pk.shape == tuple(node.logical_shape)
    # The kernels left the parameter list; the norms and embedding stayed.
    names = {n.rsplit(".", 1)[-1] for n, _ in model.named_parameters()}
    assert names == {"embedding", "scale"}
