"""Activations (counterpart of transformerengine_tpu/ops/activation.py),
forward only. Computed in f32; callers cast back.

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


def swiglu(x: torch.Tensor) -> torch.Tensor:
    return act_lu(x, "swiglu")
