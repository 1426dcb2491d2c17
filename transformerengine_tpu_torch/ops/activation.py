"""Activations and their gradients (counterpart of
transformerengine_tpu/ops/activation.py act_lu / dact_lu): the
reference's table, GELU (its tanh approximation), quick GELU, SiLU,
ReLU, squared ReLU and linear, and the gated pairs GeGLU, SwiGLU, ReGLU,
quick GeGLU and squared ReGLU. Computed in f32; results take the input's
dtype. Each gradient takes the reference's autodiff order of f32
operations (``jax.vjp`` of the forward), and at a tie of ReLU's max JAX's
half gradient.

Gated activations take ``[..., 2, H]``: ``act(x[..., 0, :]) *
x[..., 1, :]``, so SwiGLU applies SiLU to the first half of the
up-projection and the second half is the linear gate. GPT-OSS's clamped
SwiGLU is gated too, but its gate is clipped and offset, so it stays the
one-name sentinel ``("clamped_swiglu",)``, applied by
:func:`clamped_swiglu`, an autograd function whose backward gives half
the gradient at an exact tie with a clip bound, as JAX's ``minimum`` and
``clip`` do (``lax.min``'s balanced JVP)."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import math

import torch

# GELU's tanh approximation: sqrt(2 / pi) and the cubic's coefficient.
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715
_QGELU_ALPHA = 1.702


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU: ``0.5 x (1 + tanh(c (x + a x^3)))``."""
    x = x.float()
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + _GELU_A * (x * x * x))))


def qgelu(x: torch.Tensor) -> torch.Tensor:
    """Quick GELU: ``x * sigmoid(1.702 x)``."""
    x = x.float()
    return x * torch.sigmoid(_QGELU_ALPHA * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.sigmoid(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.float(), 0.0)


def srelu(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU: ``x^2`` where x > 0, else 0."""
    x = x.float()
    return torch.where(x > 0, x * x, 0.0)


def linear(x: torch.Tensor) -> torch.Tensor:
    return x.float()


_ACT = {"gelu": gelu, "qgelu": qgelu, "quick_gelu": qgelu, "silu": silu,
        "swish": silu, "relu": relu, "srelu": srelu, "linear": linear}
GATED_ALIASES = {"geglu": ("gelu", "linear"), "swiglu": ("silu", "linear"),
                 "reglu": ("relu", "linear"), "qgeglu": ("qgelu", "linear"),
                 "sreglu": ("srelu", "linear")}
CLAMPED = ("clamped_swiglu",)

# GPT-OSS's clamp (the reference's ClampedSwiGLUParam defaults).
CLAMP_LIMIT, CLAMP_ALPHA, CLAMP_OFFSET = 7.0, 1.702, 1.0


def _tie_grad(inside: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """1 inside a clip, 0.5 at an exact tie with its bound, 0 past it."""
    return torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0))


class _ClampedSwiGLU(torch.autograd.Function):
    """``clamped_silu(x0) * (clip(x1, -limit, limit) + offset)`` over
    [..., 2, H] in f32, the result in x's dtype."""

    @staticmethod
    def forward(ctx, x, limit, alpha, offset):
        ctx.save_for_backward(x)
        ctx.cfg = (limit, alpha, offset)
        gate = torch.clamp(x[..., 1, :].float(), -limit, limit) + offset
        return (clamped_silu(x[..., 0, :], limit, alpha) * gate).to(x.dtype)

    @staticmethod
    def backward(ctx, dz):
        (x,) = ctx.saved_tensors
        limit, alpha, offset = ctx.cfg
        return dclamped_swiglu(dz, x, limit, alpha, offset), None, None, None


def clamped_silu(x: torch.Tensor, limit: float = CLAMP_LIMIT,
                 alpha: float = CLAMP_ALPHA) -> torch.Tensor:
    """``v * sigmoid(alpha * v)`` with ``v = min(x, limit)``, in f32."""
    v = torch.clamp(x.float(), max=limit)
    return v * torch.sigmoid(alpha * v)


def clamped_swiglu(x: torch.Tensor, limit: float = CLAMP_LIMIT,
                   alpha: float = CLAMP_ALPHA,
                   linear_offset: float = CLAMP_OFFSET) -> torch.Tensor:
    """GPT-OSS's gated activation over [..., 2, H]: ``clamped_silu(x0) *
    (clip(x1, -limit, limit) + linear_offset)``, computed in f32, in x's
    dtype; differentiable (:func:`dclamped_swiglu`)."""
    if x.shape[-2] != 2:
        raise ValueError(f"clamped_swiglu needs [..., 2, H], got "
                         f"{tuple(x.shape)}")
    return _ClampedSwiGLU.apply(x, float(limit), float(alpha),
                                float(linear_offset))


def dclamped_swiglu(dz: torch.Tensor, x: torch.Tensor,
                    limit: float = CLAMP_LIMIT, alpha: float = CLAMP_ALPHA,
                    linear_offset: float = CLAMP_OFFSET) -> torch.Tensor:
    """The VJP of :func:`clamped_swiglu` at ``x`` [..., 2, H] for ``dz``,
    in x's dtype, in the order JAX's autodiff takes it."""
    dzf = dz.float()
    x0, x1 = x[..., 0, :].float(), x[..., 1, :].float()
    v = torch.clamp(x0, max=limit)
    s = torch.sigmoid(alpha * v)
    gate = torch.clamp(x1, -limit, limit) + linear_offset
    d_act, d_gate = dzf * gate, dzf * (v * s)
    dv = d_act * s + ((d_act * v) * (s * (1.0 - s))) * alpha
    dx0 = dv * _tie_grad(x0 < limit, x0 == limit)
    dx1 = d_gate * _tie_grad(x1.abs() < limit, x1.abs() == limit)
    return torch.stack([dx0, dx1], dim=-2).to(x.dtype)


def normalize_activation_type(
        activation_type: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    if activation_type in ("clamped_swiglu", CLAMPED):
        return CLAMPED
    if isinstance(activation_type, str):
        acts = GATED_ALIASES.get(activation_type, (activation_type,))
    else:
        acts = tuple(activation_type)
    for a in acts:
        if a not in _ACT:
            raise ValueError(
                f"unknown activation {a!r}; one of {sorted(_ACT)} or gated "
                f"aliases {sorted(GATED_ALIASES)}")
    return acts


def is_gated(activation_type: Union[str, Sequence[str]]) -> bool:
    """True for an act(x0) * gate(x1) pair over [..., 2, H]."""
    acts = normalize_activation_type(activation_type)
    return len(acts) == 2 or acts == CLAMPED


def num_halves(activation_type: Union[str, Sequence[str]]) -> int:
    """The up projection's n_act: 2 for a gated activation, else 1."""
    return 2 if is_gated(activation_type) else 1


def act_lu(x: torch.Tensor,
           activation_type: Union[str, Sequence[str]] = "swiglu"):
    """Optionally gated activation, in ``x``'s dtype."""
    acts = normalize_activation_type(activation_type)
    if acts == CLAMPED:
        return clamped_swiglu(x)
    if len(acts) == 2:
        if x.shape[-2] != 2:
            raise ValueError(f"gated activation needs [..., 2, H], got "
                             f"{tuple(x.shape)}")
        out = _ACT[acts[0]](x[..., 0, :]) * _ACT[acts[1]](x[..., 1, :])
    else:
        out = _ACT[acts[0]](x)
    return out.to(x.dtype)


def _dsilu(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The VJP of ``x * sigmoid(x)`` in the order the reference's
    autodiff takes: ``dout * s + (dout * x) * (s * (1 - s))``."""
    s = torch.sigmoid(x)
    return dout * s + (dout * x) * (s * (1.0 - s))


def _dgelu(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The VJP of :func:`gelu` as JAX's autodiff takes it: through
    ``0.5 x * (1 + t)``, then tanh's ``(g + g t)(1 - t)``, the cubic's
    ``3 x^2`` and the three uses of x summed in the order the backward
    pass reaches them."""
    half = 0.5 * x
    t = torch.tanh(_GELU_C * (x + _GELU_A * (x * x * x)))
    r = (half * dout) * (1.0 - t)
    u = _GELU_C * (r + r * t)
    return (u + (_GELU_A * u) * (3.0 * (x * x))) + 0.5 * (dout * (1.0 + t))


def _dqgelu(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The VJP of :func:`qgelu`: ``dout s + 1.702 ((x dout) (s (1 -
    s)))`` with ``s = sigmoid(1.702 x)``."""
    s = torch.sigmoid(_QGELU_ALPHA * x)
    return dout * s + _QGELU_ALPHA * ((x * dout) * (s * (1.0 - s)))


def _drelu(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The VJP of ``max(x, 0)`` with JAX's ``max`` rule: 1 above 0, 0
    below, one half at x == 0 (a tie)."""
    return dout * _tie_grad(x > 0, x == 0)


def _dsrelu(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The VJP of :func:`srelu`: ``x g + g x`` with ``g`` the gradient
    where x > 0, else 0."""
    g = torch.where(x > 0, dout, 0.0)
    return x * g + g * x


_DACT = {"silu": _dsilu, "swish": _dsilu, "gelu": _dgelu, "qgelu": _dqgelu,
         "quick_gelu": _dqgelu, "relu": _drelu, "srelu": _dsrelu}


def _dact(name: str, x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    if name in _DACT:
        return _DACT[name](x, dout)
    return dout


def dact_lu(dz: torch.Tensor, x: torch.Tensor,
            activation_type: Union[str, Sequence[str]] = "swiglu"
            ) -> torch.Tensor:
    """The VJP of :func:`act_lu` at ``x`` for the output gradient ``dz``,
    in ``x``'s dtype. Gated: ``x`` is [..., 2, H] and so is the result."""
    acts = normalize_activation_type(activation_type)
    if acts == CLAMPED:
        return dclamped_swiglu(dz, x)
    dzf = dz.float()
    if len(acts) == 2:
        x0, x1 = x[..., 0, :].float(), x[..., 1, :].float()
        a, g = _ACT[acts[0]](x0), _ACT[acts[1]](x1)
        dx = torch.stack([_dact(acts[0], x0, dzf * g),
                          _dact(acts[1], x1, dzf * a)], dim=-2)
    else:
        dx = _dact(acts[0], x.float(), dzf)
    return dx.to(x.dtype)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    return act_lu(x, "swiglu")
