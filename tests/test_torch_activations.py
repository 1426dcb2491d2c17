"""The port's activation table against the JAX package on the CPU:
``act_lu`` and ``dact_lu`` for every activation and gated alias of the
reference (GELU's tanh form, quick GELU, SiLU, ReLU, squared ReLU,
linear; GeGLU, SwiGLU, ReGLU, quick GeGLU, squared ReGLU) on the same
seeded inputs, in f32 and bf16, with ReLU's ties at 0 (``-0`` among
them), and the layers' rule for n_act."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformerengine_tpu.ops.activation import (
    act_lu as j_act_lu, dact_lu as j_dact_lu,
    normalize_activation_type as j_normalize)
from transformerengine_tpu_torch.ops.activation import (
    act_lu, dact_lu, is_gated, normalize_activation_type, num_halves)

torch.set_num_threads(2)

_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16}
_NAMES = ("gelu", "qgelu", "quick_gelu", "silu", "relu", "srelu", "linear",
          "geglu", "swiglu", "reglu", "qgeglu", "sreglu")
# f32: the same f32 operations in the same order, but XLA's CPU tanh and
# logistic are not torch's, a few f32 ulps apart. Where 1 + tanh cancels
# (GELU far below 0) that is a few ulps of 1, and XLA's tanh reaches -1
# where torch's stays above it, so GELU's gradient there is 0 on one side
# and about 3e-6 on the other: besides a relative part each element gets
# 4e-6 of the largest |ref| (readings: up to 1.2e-6 of it). bf16: results
# round to bf16 from those f32 values, so an element may land one bf16
# ulp (2^-8 of itself) away.
_RTOL = {"f32": 2e-6, "bf16": 2 ** -7}
_ATOL_OF_MAX = 4e-6


def _inputs(name: str, dtype: str):
    rng = np.random.default_rng(_NAMES.index(name) + (0 if dtype == "f32"
                                                     else 50))
    gated = is_gated(name)
    x = rng.standard_normal((6, 2, 64) if gated else (6, 64)) * 3
    x.reshape(-1)[:4] = (0.0, -0.0, 1e-3, -1e-3)     # ReLU's tie at 0
    dz = rng.standard_normal((6, 64))
    xj = jnp.asarray(x, jnp.float32).astype(_JD[dtype])
    dzj = jnp.asarray(dz, jnp.float32).astype(_JD[dtype])
    to_t = lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(_TD[dtype])
    return xj, dzj, to_t(xj), to_t(dzj)


def _close(got, ref, dtype, what):
    r = np.asarray(ref.astype(jnp.float32))
    g = got.float().numpy()
    tol = _RTOL[dtype] * np.abs(r) + _ATOL_OF_MAX * np.abs(r).max()
    assert np.all(np.abs(g - r) <= tol), (
        what, float(np.max(np.abs(g - r) / tol)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", _NAMES)
def test_act_lu_and_its_vjp_match_the_reference(name, dtype):
    """Forward and VJP element by element, each in the input's dtype."""
    assert normalize_activation_type(name) == j_normalize(name)
    xj, dzj, xt, dzt = _inputs(name, dtype)
    out = act_lu(xt, name)
    assert out.dtype == xt.dtype
    _close(out, j_act_lu(xj, name), dtype, "forward")
    dx = dact_lu(dzt, xt, name)
    assert dx.dtype == xt.dtype and dx.shape == xt.shape
    _close(dx, j_dact_lu(dzj, xj, name), dtype, "vjp")


def test_relu_ties_take_half_the_gradient():
    """JAX's max gives half the gradient at x == 0 (and -0): ReLU, ReGLU's
    activation half; squared ReLU gives 0 there."""
    x = torch.tensor([0.0, -0.0, 2.0, -2.0])
    dz = torch.ones(4)
    assert dact_lu(dz, x, "relu").tolist() == [0.5, 0.5, 1.0, 0.0]
    assert dact_lu(dz, x, "srelu").tolist() == [0.0, 0.0, 4.0, 0.0]
    xj = jnp.asarray([0.0, -0.0, 2.0, -2.0])
    assert np.asarray(j_dact_lu(jnp.ones(4), xj, "relu")).tolist() == \
        [0.5, 0.5, 1.0, 0.0]


def test_gated_names_and_halves():
    """The gated aliases map to the reference's pairs and take two halves
    of the up projection; an unknown name raises as the reference's."""
    for name in ("geglu", "reglu", "qgeglu", "sreglu", ("gelu", "linear")):
        assert num_halves(name) == 2
    for name in ("gelu", ("gelu",), "relu", "srelu", "qgelu"):
        assert num_halves(name) == 1
    with pytest.raises(ValueError, match="unknown activation"):
        normalize_activation_type("tanh")
