"""``torch.nn`` modules over the functional layers (counterpart of
transformerengine_tpu/flax/module.py: LayerNorm, DenseGeneral,
LayerNormDenseGeneral, LayerNormMLP), forward only.

Parameters keep the reference's names and layouts (kernels contracting
dim first, norm ``scale`` in f32), so a Flax params tree maps onto a
``state_dict`` one to one. After
:func:`~..quantize.prequant.prequantize_kernels`, a kernel parameter is
replaced by a :class:`~..quantize.prequant.PrequantizedKernel` whose
buffers hold the resident (N, K) payload.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..dense import dense
from ..layernorm_dense import layernorm_dense
from ..layernorm_mlp import layernorm_mlp
from ..ops.activation import normalize_activation_type
from ..ops.normalization import rmsnorm_fwd


def init_kernel(shape, fan_in: int, dtype: torch.dtype, device,
                generator: Optional[torch.Generator]) -> nn.Parameter:
    """LeCun-normal kernel (std 1/sqrt(fan_in)), drawn in f32."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) / math.sqrt(fan_in)
    return nn.Parameter(w.to(dtype), requires_grad=False)


def _ones(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=torch.float32, device=device),
                        requires_grad=False)


class LayerNorm(nn.Module):
    """RMSNorm over the last axis with an f32 ``scale`` (the reference's
    ``LayerNorm(norm_type="rmsnorm")``; LayerNorm proper arrives with the
    training slice)."""

    def __init__(self, hidden: int, *, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = _ones(hidden, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_fwd(x, self.scale, epsilon=self.epsilon)[0]


class DenseGeneral(nn.Module):
    """``x . kernel`` with a (in_features, features) kernel."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = init_kernel((in_features, features), in_features,
                                  dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel)


class LayerNormDenseGeneral(nn.Module):
    """``rmsnorm(x) . kernel``."""

    def __init__(self, in_features: int, features: int, *,
                 epsilon: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = _ones(in_features, device)
        self.kernel = init_kernel((in_features, features), in_features,
                                  dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_dense(x, self.kernel, self.scale,
                               epsilon=self.epsilon)


class LayerNormMLP(nn.Module):
    """``dense(act(dense(rmsnorm(x))))`` with ``wi_kernel`` (hidden,
    n_act, intermediate) and ``wo_kernel`` (intermediate, hidden)."""

    def __init__(self, hidden: int, intermediate_dim: int, *,
                 epsilon: float = 1e-6,
                 activations: Union[str, Sequence[str]] = "swiglu",
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        self.activations = normalize_activation_type(activations)
        n_act = len(self.activations)
        self.scale = _ones(hidden, device)
        self.wi_kernel = init_kernel((hidden, n_act, intermediate_dim),
                                     hidden, dtype, device, generator)
        self.wo_kernel = init_kernel((intermediate_dim, hidden),
                                     intermediate_dim, dtype, device,
                                     generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_mlp(x, self.scale, self.wi_kernel, self.wo_kernel,
                             epsilon=self.epsilon,
                             activation_type=self.activations)
