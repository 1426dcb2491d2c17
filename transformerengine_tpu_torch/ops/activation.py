"""Activations and their gradients (counterpart of
transformerengine_tpu/ops/activation.py act_lu / dact_lu). Computed in
f32; results take the input's dtype.

Gated activations take ``[..., 2, H]``: ``act(x[..., 0, :]) *
x[..., 1, :]``, so SwiGLU applies SiLU to the first half of the
up-projection and the second half is the linear gate."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.sigmoid(x)


def linear(x: torch.Tensor) -> torch.Tensor:
    return x.float()


_ACT = {"silu": silu, "swish": silu, "linear": linear}
GATED_ALIASES = {"swiglu": ("silu", "linear")}


def normalize_activation_type(
        activation_type: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    if isinstance(activation_type, str):
        acts = GATED_ALIASES.get(activation_type, (activation_type,))
    else:
        acts = tuple(activation_type)
    for a in acts:
        if a not in _ACT:
            raise NotImplementedError(
                f"activation {a!r} is not ported yet; ported: {sorted(_ACT)} "
                f"and gated {sorted(GATED_ALIASES)}")
    return acts


def act_lu(x: torch.Tensor,
           activation_type: Union[str, Sequence[str]] = "swiglu"):
    """Optionally gated activation, in ``x``'s dtype."""
    acts = normalize_activation_type(activation_type)
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


def _dact(name: str, x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    if name in ("silu", "swish"):
        return _dsilu(x, dout)
    return dout


def dact_lu(dz: torch.Tensor, x: torch.Tensor,
            activation_type: Union[str, Sequence[str]] = "swiglu"
            ) -> torch.Tensor:
    """The VJP of :func:`act_lu` at ``x`` for the output gradient ``dz``,
    in ``x``'s dtype. Gated: ``x`` is [..., 2, H] and so is the result."""
    acts = normalize_activation_type(activation_type)
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
