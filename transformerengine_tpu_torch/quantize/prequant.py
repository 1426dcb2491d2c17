"""Prequantized (FP8-resident) weights for inference (counterpart of
transformerengine_tpu/quantize/prequant.py).

:func:`prequantize_kernels` replaces every projection kernel of a model,
in place, with a :class:`PrequantizedKernel`: a module whose buffers
hold only the (N, K) forward-GEMM usage of the (K, ...) kernel, so
decode reads one byte per weight and never re-quantizes. Embedding and
norm parameters stay in high precision.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..common.recipe import Float8CurrentScaling, Recipe
from .quantizer import CurrentScaleQuantizer, QuantizeLayout
from .tensor import ScaledTensor1x

_KERNEL_NAMES = ("kernel", "wi_kernel", "wo_kernel")


class PrequantizedKernel(nn.Module):
    """A kernel stored only as its colwise (N, K) usage.

    The buffers are ``data`` (the e4m3 payload, or for ``recipe=None``
    the kernel itself transposed once at load) and ``scale_inv`` ((1,)
    f32, None for ``recipe=None``). ``logical_shape`` is the original
    kernel's shape, contracting dim first."""

    def __init__(self, data: torch.Tensor, scale_inv: Optional[torch.Tensor],
                 logical_shape, dq_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("data", data)
        self.register_buffer("scale_inv", scale_inv)
        self.logical_shape = tuple(logical_shape)
        self.dq_dtype = dq_dtype

    @property
    def shape(self):
        return self.logical_shape

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the kernel had before it was prequantized."""
        return self.dq_dtype

    @property
    def colwise(self):
        """What the GEMMs read: a resident ScaledTensor1x, or the plain
        (N, K) tensor."""
        if self.scale_inv is None:
            return self.data
        return ScaledTensor1x(self.data, self.scale_inv, None, self.dq_dtype,
                              layout="T", resident=True)


def prequantize_kernel_array(kernel: torch.Tensor, recipe: Optional[Recipe]
                             ) -> PrequantizedKernel:
    """Quantizes one kernel (contracting dim first) to its colwise usage.
    ``recipe=None`` keeps the dtype and only stores it (N, K)."""
    k2d = kernel.detach().reshape(kernel.shape[0], -1)
    if recipe is None:
        return PrequantizedKernel(k2d.t().contiguous(), None, kernel.shape,
                                  kernel.dtype)
    if not isinstance(recipe, Float8CurrentScaling):
        raise NotImplementedError(
            f"prequantization with {type(recipe).__name__} is not ported "
            f"yet; ported: Float8CurrentScaling and recipe=None")
    q = CurrentScaleQuantizer(recipe.fp8_dtype, QuantizeLayout.COLWISE)
    t = q.quantize(k2d, dq_dtype=kernel.dtype)
    return PrequantizedKernel(t.data, t.scale_inv, kernel.shape, kernel.dtype)


def prequantize_kernels(model: nn.Module, recipe: Optional[Recipe]
                        ) -> nn.Module:
    """Converts ``model`` for resident-weight inference, in place: every
    projection kernel parameter becomes a :class:`PrequantizedKernel`
    submodule of the same name, and the source parameter is released.
    Returns ``model``."""
    for module in list(model.modules()):
        for name in _KERNEL_NAMES:
            param = getattr(module, name, None)
            if not isinstance(param, nn.Parameter) or param.dim() < 2:
                continue
            pk = prequantize_kernel_array(param, recipe)
            delattr(module, name)
            setattr(module, name, pk)
    return model
