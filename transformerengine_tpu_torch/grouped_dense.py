"""Grouped dense (expert) layer with its backward (counterpart of
transformerengine_tpu/grouped_dense.py). Rows of ``x`` are
expert-contiguous (the output of ``token_dispatch``), the kernels are
stacked (E, K, M), and the three GEMMs (forward, dgrad, wgrad) are the
grouped GEMMs of ``ops/grouped_gemm.py``, with the reference's branches:

* no quantizer set: plain operands;
* tensor scaling (current or delayed): x, the kernel and the gradient
  each quantized rowwise, the per-tensor scales on the f32 products; the
  backward writes the delayed state's update into the set's tensors, as
  ``dense.py`` does;
* block scaling (MXFP8, FP8 block scaling): x and the gradient
  quantized rowwise (scales along the contraction axis), the kernel
  quantized along K and dequantized in both orientations
  (:class:`GroupedQDQKernel`), under MXFP8 by the grouped QDQ kernel,
  under FP8 block scaling by the plain chain (the reference has no kernel
  for it); the forward contracts x with ``nn``, the dgrad the gradient
  with ``tn``, the wgrad the dequantized x with the dequantized gradient.

``kernel_cache`` (``quantize.microbatch.quantize_grouped_kernel``) takes
the place of the kernel's per-call quantize, as in ``dense.py``.
:func:`grouped_dense_gq` is the per-expert-scaled variant
(``quantize/grouped.py``) with its own backward.

With a gradient the group sizes are read to the host once per call and
kept for the backward (the caller may pass host ints, as ``moe`` does
once per layer). Without one they go to the grouped GEMMs as given, and
a tensor stays on the device through the bf16 products."""
from __future__ import annotations

import torch

from .dense import _amax_of, join_residuals, needs_grad, split_residuals
from .ops import quantize_kernels as qk
from .ops.grouped_gemm import (GroupSizes, grouped_gemm, grouped_gemm_dgrad,
                               grouped_gemm_dw, grouped_gemm_tn, host_sizes)
from .quantize.grouped import (GroupedQuantizer, expert_of_row,
                               grouped_gemm_scaled)
from .quantize.microbatch import GroupedQDQKernel
from .quantize.quantizer import (QuantizeLayout, QuantizerSet,
                                 noop_quantizer_set)
from .quantize.scaling_modes import ScalingMode


def _q1x(quantizer, x):
    """x quantized rowwise: scales along its stored last axis, which the
    callers make the contraction axis."""
    return quantizer.quantize(x, layout=QuantizeLayout.ROWWISE)


def _qdq_kernel(quantizer, kernel) -> GroupedQDQKernel:
    """Both dequantized orientations of the (E, K, M) kernel quantized
    along K: the grouped QDQ kernel under MXFP8 where it takes the shape,
    else the reference's chain (quantize the (E, M, K) view rowwise,
    dequantize, transpose)."""
    if quantizer.scaling_mode is ScalingMode.MXFP8_1D_SCALING:
        out = qk.mxfp8_qdq_2x_grouped(kernel, quantizer.q_dtype)
        if out is not None:
            return GroupedQDQKernel(nn=out[0], tn=out[1])
    tn = _q1x(quantizer, kernel.transpose(1, 2)).dequantize().to(
        torch.bfloat16)
    return GroupedQDQKernel(nn=tn.transpose(1, 2), tn=tn)


def _gd_fwd(x, kernel, sizes, qset: QuantizerSet, cache=None):
    """(out in x's dtype, residuals): the branch's name, then what its
    backward reads."""
    if qset.x is None:
        return grouped_gemm(x, kernel, sizes, x.dtype), ("plain", x, kernel)
    qx = _q1x(qset.x, x)
    if qset.x.scaling_mode.is_tensor_scaling:
        qkern = cache.q if cache is not None else _q1x(qset.kernel, kernel)
        return grouped_gemm(qx, qkern, sizes, x.dtype), ("tensor", qx, qkern)
    qdq = cache.q if cache is not None else _qdq_kernel(qset.kernel, kernel)
    # The reference keeps nn among its residuals too, but its backward
    # reads only tn; keeping tn alone changes no value and frees one bf16
    # copy of the expert weights per layer until the backward.
    return grouped_gemm(qx, qdq.nn, sizes, x.dtype), ("block", qx, qdq.tn)


def _gd_bwd(g, res, sizes, qset: QuantizerSet, num_experts: int,
            x_dtype, k_dtype, cache=None):
    """(dx, dw, the set's updated state or None; with ``cache``, the
    kernel's update only at the cache's first backward)."""
    if res[0] == "plain":
        _, x, kernel = res
        return (grouped_gemm_tn(g, kernel, sizes, x_dtype),
                grouped_gemm_dw(x, g, sizes, num_experts, k_dtype), None)
    tag, qx, kq = res
    gq = _q1x(qset.dgrad, g)
    if tag == "tensor":
        dx = grouped_gemm_tn(gq, kq, sizes, x_dtype)
        k_amax = _amax_of(kq)
    else:
        # The dequantized tn carries no amax; block scaling keeps no state.
        dx = grouped_gemm_dgrad(gq, kq, sizes, x_dtype)
        k_amax = torch.zeros((), dtype=torch.float32)
    new = qset.update(QuantizerSet(x=_amax_of(qx), kernel=k_amax,
                                   dgrad=_amax_of(gq)))
    if cache is not None:
        new = cache.observe(qset, new)
    return dx, grouped_gemm_dw(qx, gq, sizes, num_experts, k_dtype), new


class _GroupedDense(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, sizes, qset, cache):
        out, res = _gd_fwd(x, kernel, sizes, qset, cache)
        tensors, ctx.tag = split_residuals(res)
        ctx.save_for_backward(*tensors)
        ctx.sizes, ctx.qset, ctx.cache = sizes, qset, cache
        ctx.dtypes = (x.dtype, kernel.shape[0], kernel.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x_dtype, num_experts, k_dtype = ctx.dtypes
        res = join_residuals(ctx.tag, ctx.saved_tensors)
        dx, dw, new = _gd_bwd(g.contiguous(), res, ctx.sizes, ctx.qset,
                              num_experts, x_dtype, k_dtype, ctx.cache)
        if new is not None:
            ctx.qset.write_back(new)
        return dx, dw, None, None, None


def grouped_dense(x: torch.Tensor, kernel: torch.Tensor,
                  group_sizes: GroupSizes, *,
                  quantizer_set: QuantizerSet = noop_quantizer_set,
                  kernel_cache=None) -> torch.Tensor:
    """``out[n] = x[n] @ kernel[expert_of(n)]`` for expert-contiguous x
    (N, K) and kernels (E, K, M), in x's dtype. Differentiable in x and
    the kernel; a delayed-scaling set's state is updated by the
    backward. ``kernel_cache``: the kernels quantized once per step by
    ``quantize.microbatch.quantize_grouped_kernel`` (rebuild it after
    every optimizer step)."""
    if kernel.dim() != 3 or x.shape[-1] != kernel.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(kernel.shape)}")
    if needs_grad(x, kernel):
        return _GroupedDense.apply(x, kernel, host_sizes(group_sizes),
                                   quantizer_set, kernel_cache)
    return _gd_fwd(x, kernel, group_sizes, quantizer_set, kernel_cache)[0]


class _GroupedDenseGQ(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, sizes, gq):
        qx = gq.quantize_rows(x, sizes)
        qk = gq.quantize_kernels(kernel)
        out = grouped_gemm_scaled(qx, qk, sizes).to(x.dtype)
        ctx.save_for_backward(qx.data, qx.scale_inv, qk.data, qk.scale_inv)
        ctx.sizes, ctx.gq, ctx.dtypes = sizes, gq, (x.dtype, kernel.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x_data, x_sinv, k_data, k_sinv = ctx.saved_tensors
        x_dtype, k_dtype = ctx.dtypes
        qg = ctx.gq.quantize_rows(g.contiguous(), ctx.sizes)
        gb = qg.data.to(torch.bfloat16)
        # dx[n] = g[n] @ W[e]^T, each row times its scale product.
        dx = grouped_gemm_tn(gb, k_data.to(torch.bfloat16), ctx.sizes)
        k_rows = k_sinv[expert_of_row(ctx.sizes, dx.shape[0], dx.device)]
        dx = (dx * (qg.row_scale_inv() * k_rows)[:, None]).to(x_dtype)
        # dW[e] = x_e^T g_e, each expert times its scale product.
        dw = grouped_gemm_dw(x_data.to(torch.bfloat16), gb, ctx.sizes,
                             k_data.shape[0])
        dw = (dw * (x_sinv * qg.scale_inv)[:, None, None]).to(k_dtype)
        return dx, dw, None, None


def grouped_dense_gq(x: torch.Tensor, kernel: torch.Tensor,
                     group_sizes: GroupSizes,
                     grouped_quantizer: GroupedQuantizer) -> torch.Tensor:
    """:func:`grouped_dense` with one current-scaling scale per expert
    (``quantize/grouped.py``): x's rows, the kernels and, in the
    backward, the gradient's rows each quantized per group; the products'
    scales applied to the f32 rows. ``grouped_quantizer.num_groups`` must
    be the number of experts."""
    if kernel.dim() != 3 or x.shape[-1] != kernel.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(kernel.shape)}")
    if grouped_quantizer.num_groups != kernel.shape[0]:
        raise ValueError(f"{grouped_quantizer.num_groups} groups for "
                         f"{kernel.shape[0]} experts")
    return _GroupedDenseGQ.apply(x, kernel, host_sizes(group_sizes),
                                 grouped_quantizer)
