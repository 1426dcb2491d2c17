"""Once-per-step quantized weight workspaces for gradient accumulation
(counterpart of transformerengine_tpu/quantize/microbatch.py).

:func:`quantize_kernel` quantizes a kernel once, at the first microbatch
of an optimizer step, into a :class:`KernelCache`; every microbatch of
the step passes it to ``dense``, ``layernorm_dense`` or
``layernorm_mlp`` (``kernel_cache=``, ``kernel_caches=``), which then
skip their per-call kernel quantize. :func:`quantize_grouped_kernel` does
the same for ``grouped_dense`` and ``moe``. Gradients still flow to the
kernel itself; the cache is held detached and takes none.

What a cache holds follows the recipe, as in the reference: under
per-tensor scaling the kernel's rowwise payload (one payload serves the
forward, the dgrad and the wgrad) with the amax it was quantized from;
under block scaling both dequantized bf16 orientations
(:class:`~.tensor.QDQKernel`, for expert stacks :class:`GroupedQDQKernel`),
the values the GEMMs would have dequantized from the quantized usages.

Delayed scaling: the kernel's observation rides the cache. The first
backward through a cache rolls the kernel quantizer's state with the
cache-time amax; later backwards through the same cache leave it, so the
kernel's history rolls once per step, as the reference's overwrite-with-
gradient convention keeps one microbatch's update. The x and gradient
quantizers update at every backward, as without a cache.

A cache holds the weights as they were when it was built: build it anew
after every optimizer step (the module form, ``nn.module.kernel_cache``,
drops it when its step ends) or the layers compute with stale weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from .quantizer import QuantizeLayout, QuantizerSet
from .tensor import QDQKernel, ScaledTensor1x, ScaledTensor2x, get_rowwise

__all__ = ["GroupedQDQKernel", "KernelCache", "QDQKernel", "quantize_kernel",
           "quantize_grouped_kernel"]


@dataclasses.dataclass(frozen=True)
class GroupedQDQKernel:
    """Block-scaled expert weights as both dequantized bf16 orientations:
    ``nn`` (E, K, M), the forward GEMM's form, and ``tn`` (E, M, K), the
    dgrad's (contracting M). The values equal the quantized kernel
    dequantized inside the GEMM."""

    nn: torch.Tensor
    tn: torch.Tensor


@dataclasses.dataclass
class KernelCache:
    """The quantized usages of one kernel for one optimizer step: ``q``,
    a rowwise ScaledTensor1x (per-tensor scaling) or a QDQKernel or
    GroupedQDQKernel (block scaling); ``amax``, the kernel's amax when it
    was quantized (None under block scaling). ``observed`` turns True at
    the first backward that writes the kernel's observation into its
    quantizer (module docstring)."""

    q: Union[ScaledTensor1x, QDQKernel, GroupedQDQKernel]
    amax: Optional[torch.Tensor] = None
    observed: bool = False

    def observe(self, qset: QuantizerSet, new: QuantizerSet) -> QuantizerSet:
        """``new`` (``qset``'s update at one backward) with the kernel's
        update kept only at the cache's first backward."""
        if self.observed:
            return dataclasses.replace(new, kernel=qset.kernel)
        self.observed = True
        return new


def _tensor_scaled(qset: QuantizerSet) -> bool:
    return all(q is not None and q.scaling_mode.is_tensor_scaling
               for q in (qset.x, qset.kernel, qset.dgrad))


@torch.no_grad()
def quantize_kernel(kernel: torch.Tensor, quantizer_set: QuantizerSet,
                    n_cdims: int = 1):
    """(cache, quantizer_set) for ``kernel`` (its first ``n_cdims`` dims
    contracted): the set comes back unchanged, and the cache is None
    without quantization (no x or kernel quantizer)."""
    if quantizer_set.x is None or quantizer_set.kernel is None:
        return None, quantizer_set
    k = math.prod(kernel.shape[:n_cdims])
    k2d = kernel.detach().reshape(k, -1)
    if _tensor_scaled(quantizer_set):
        q = quantizer_set.kernel.quantize(k2d, layout=QuantizeLayout.ROWWISE)
        return KernelCache(q, q.amax), quantizer_set
    q = quantizer_set.kernel.quantize(k2d)
    amax = get_rowwise(q).amax
    if isinstance(q, ScaledTensor2x):
        q = QDQKernel(row=q.rowwise.dequantize().to(torch.bfloat16),
                      col=q.colwise.dequantize().to(torch.bfloat16))
    return KernelCache(q, amax), quantizer_set


@torch.no_grad()
def quantize_grouped_kernel(kernel: torch.Tensor,
                            quantizer_set: QuantizerSet):
    """:func:`quantize_kernel` for stacked expert kernels (E, K, M): the
    (E, K, M) rowwise payload under per-tensor scaling, else a
    :class:`GroupedQDQKernel` as ``grouped_dense`` builds it."""
    from ..grouped_dense import _q1x, _qdq_kernel
    if quantizer_set.x is None or quantizer_set.kernel is None:
        return None, quantizer_set
    kernel = kernel.detach()
    if quantizer_set.x.scaling_mode.is_tensor_scaling:
        q = _q1x(quantizer_set.kernel, kernel)
        return KernelCache(q, q.amax), quantizer_set
    return KernelCache(_qdq_kernel(quantizer_set.kernel, kernel)), \
        quantizer_set
