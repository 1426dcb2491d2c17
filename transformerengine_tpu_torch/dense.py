"""Dense layer with its backward (counterpart of transformerengine_tpu/
dense.py), and the GEMM forward and backward that the fused layers share.

Each layer is a ``torch.autograd.Function`` mirroring the reference's
``custom_vjp``, with the reference's branches:

* no quantizer set: plain operands; the residuals are the operands;
* every quantizer per-tensor scaled (current or delayed scaling): one
  orientation of each operand is quantized ("1x", rowwise), and the
  backward contracts the same payloads along the needed axis (dgrad
  ``q_dot(qg, qk, 1, 1)``, wgrad ``q_dot(qx, qg, 0, 0)``), as the scales
  are scalars;
* block scaling (MXFP8, FP8 block scaling, NVFP4), training ("2x"): x,
  the kernel and the
  gradient are each quantized in both orientations, and every GEMM
  contracts along the stored last axis of both operands: forward
  ``tn_dot(rowwise(qx), colwise(qk))``, dgrad ``tn_dot(rowwise(qg),
  rowwise(qk))``, wgrad ``tn_dot(colwise(qx), colwise(qg))``;
* block scaling, forward without a gradient (the reference's
  ``inference=True`` primal): x rowwise and the kernel colwise only.

Quantizer state: the reference returns the updated quantizer set as the
set's cotangent ("overwrite with gradient"). Here the backward computes
the same update (``QuantizerSet.update`` with this step's amaxes of x,
the kernel and the gradient) and writes it, once per backward, into the
tensors of the set it was given (``QuantizerSet.write_back``): for an
``nn`` module those are its ``{name}_{role}_scale`` and
``{name}_{role}_amax_history`` buffers. A forward without a backward
(``torch.no_grad``) leaves the state as it was, as the reference's
primal does.

Residuals go through ``ctx.save_for_backward``, so autograd's version
check raises when a saved parameter is updated in place before the
backward that reads it. When no input requires a gradient (serving under
``torch.no_grad``), the layers run their forward directly, without an
autograd node, and take the reference primal's branches.

A :class:`~.quantize.prequant.PrequantizedKernel` serves the forward
only; a backward through it raises.

``kernel_cache`` (``quantize/microbatch.py``) supplies the kernel's
quantized usages of a gradient-accumulation step in place of the per-call
kernel quantize: under per-tensor scaling its rowwise payload, under
block scaling its two dequantized bf16 orientations. The backward takes
the kernel's observation from the cache once per step.

A bias is added in f32 to the f32 product before its one rounding to the
output's dtype, as the reference adds it; its gradient is the sum of the
output gradient over the rows, in the bias's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .ops.gemm import prequant_dot, q_dot, tn_dot
from .quantize.prequant import PrequantizedKernel
from .quantize.quantizer import (QuantizeLayout, QuantizerSet,
                                 noop_quantizer_set)
from .quantize.tensor import ScaledTensor1x, get_colwise, get_rowwise


def all_tensor_scaling(qset: QuantizerSet) -> bool:
    """True when every quantizer of the set is per-tensor scaled, so one
    quantized orientation serves the forward and the backward."""
    return all(q is not None and q.scaling_mode.is_tensor_scaling
               for q in (qset.x, qset.kernel, qset.dgrad))


def needs_grad(*inputs) -> bool:
    """True when autograd records and some input requires a gradient."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in inputs)


def split_residuals(res):
    """(tensors, tag) of a GEMM's residuals, a branch name followed by
    tensors and quantized tensors: the tensors for
    ``ctx.save_for_backward`` (a quantized residual's data, scales, amax
    and tensor scale, the last two None where the recipe has none), the
    tag (the branch, and each quantized residual's dtype, layout and
    scaling mode, None for a plain tensor) for ``ctx``."""
    tensors, tag = [], [res[0]]
    for t in res[1:]:
        if isinstance(t, ScaledTensor1x):
            tensors += [t.data, t.scale_inv, t.amax, t.tensor_scale_inv]
            tag.append((t.dq_dtype, t.layout, t.scaling_mode))
        else:
            tensors.append(t)
            tag.append(None)
    return tuple(tensors), tuple(tag)


def join_residuals(tag, tensors):
    """The residuals that :func:`split_residuals` split."""
    out, i = [tag[0]], 0
    for meta in tag[1:]:
        if meta is None:
            out.append(tensors[i])
            i += 1
            continue
        dq, layout, mode = meta
        out.append(ScaledTensor1x(*tensors[i:i + 3], dq, layout=layout,
                                  scaling_mode=mode,
                                  tensor_scale_inv=tensors[i + 3]))
        i += 4
    return tuple(out)


def _amax_of(t) -> torch.Tensor:
    a = getattr(get_rowwise(t), "amax", None)
    return a if a is not None else torch.zeros((), dtype=torch.float32)


def gemm_fwd(x2d, kernel, qset: QuantizerSet, *, inference: bool = False,
             qx=None, kernel_cache=None):
    """``(M, N) f32 x2d (M, K) . kernel`` for a (K, ...) kernel or a
    PrequantizedKernel, and the residuals its backward needs.
    ``inference``: the forward without a gradient (block scaling then
    quantizes one orientation of each operand). ``qx``: x already
    quantized (the fused norm's output), in place of ``x2d``.
    ``kernel_cache``: the kernel's usages quantized once per step."""
    if isinstance(kernel, PrequantizedKernel):
        return prequant_dot(x2d, kernel.colwise, qset.x), ("prequant",)
    k2d = kernel.reshape(kernel.shape[0], -1)
    if qset.x is None:
        return q_dot(x2d, k2d, 1, 0), ("plain", x2d, k2d)
    cached = kernel_cache.q if kernel_cache is not None else None
    if all_tensor_scaling(qset):
        qx = qset.x.quantize(x2d, layout=QuantizeLayout.ROWWISE)
        qk = get_rowwise(cached) if cached is not None else \
            qset.kernel.quantize(k2d, layout=QuantizeLayout.ROWWISE)
        return q_dot(qx, qk, 1, 0), ("1x", qx, qk)
    if inference:
        if qx is None:
            qx = qset.x.quantize(x2d, layout=QuantizeLayout.ROWWISE)
        qk = get_colwise(cached) if cached is not None else \
            qset.kernel.quantize(k2d, layout=QuantizeLayout.COLWISE)
        return tn_dot(get_rowwise(qx), get_colwise(qk)), ("inference",)
    if qx is None:
        qx = qset.x.quantize(x2d)
    qk = cached if cached is not None else qset.kernel.quantize(k2d)
    # (M, K) x (N, K) -> (M, N); the backward keeps x's colwise usage and
    # the kernel's rowwise one.
    return (tn_dot(get_rowwise(qx), get_colwise(qk)),
            ("2x", get_colwise(qx), get_rowwise(qk)))


def gemm_bwd(g2d: torch.Tensor, res, qset: QuantizerSet, need_dw=True,
             kernel_cache=None):
    """(dx2d, dw2d (K, N) or None, the set's updated state or None) of
    the GEMM that :func:`gemm_fwd` ran (with ``kernel_cache``, the
    kernel's update only at the cache's first backward)."""
    if res[0] == "prequant":
        raise NotImplementedError(
            "backward through a PrequantizedKernel (inference-only "
            "weights); use plain kernels for training")
    if res[0] == "plain":
        _, x2d, k2d = res
        dw2d = q_dot(x2d, g2d, 0, 0) if need_dw else None
        return tn_dot(g2d, k2d), dw2d, None
    if res[0] == "1x":
        _, qx, qk = res
        qg = qset.dgrad.quantize(g2d, layout=QuantizeLayout.ROWWISE)
        dx2d = q_dot(qg, qk, 1, 1)
        dw2d = q_dot(qx, qg, 0, 0) if need_dw else None
    else:
        _, qx, qk = res           # x colwise (K, M), kernel rowwise (K, N)
        qg = qset.dgrad.quantize(g2d)
        dx2d = tn_dot(get_rowwise(qg), qk)                 # -> (M, K)
        dw2d = tn_dot(qx, get_colwise(qg)) if need_dw else None  # (K, N)
    new = qset.update(QuantizerSet(x=_amax_of(qx), kernel=_amax_of(qk),
                                   dgrad=_amax_of(qg)))
    if kernel_cache is not None:
        new = kernel_cache.observe(qset, new)
    return dx2d, dw2d, new


def add_bias(out2d: torch.Tensor, bias) -> torch.Tensor:
    """The f32 GEMM output plus the bias in f32 (None: unchanged)."""
    if bias is None:
        return out2d
    return out2d + bias.reshape(1, -1).float()


def bias_meta(bias):
    """(shape, dtype) of a bias, for its gradient; None without one."""
    return None if bias is None else (tuple(bias.shape), bias.dtype)


def bias_grad(g2d: torch.Tensor, meta):
    """The bias's gradient: the output gradient summed over the rows, in
    the bias's dtype (``meta`` from :func:`bias_meta`)."""
    if meta is None:
        return None
    shape, dtype = meta
    return g2d.float().sum(dim=0).reshape(shape).to(dtype)


def _dense_fwd(x, kernel, bias, qset, cache, inference=False):
    out2d, res = gemm_fwd(x.reshape(-1, kernel.shape[0]), kernel, qset,
                          inference=inference, kernel_cache=cache)
    out2d = add_bias(out2d, bias)
    return out2d.reshape(*x.shape[:-1], *kernel.shape[1:]).to(x.dtype), res


class _Dense(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, bias, qset, cache):
        out, res = _dense_fwd(x, kernel, bias, qset, cache)
        tensors, ctx.tag = split_residuals(res)
        ctx.save_for_backward(*tensors)
        ctx.qset, ctx.cache = qset, cache
        ctx.shapes = (x.shape, x.dtype, tuple(kernel.shape), kernel.dtype)
        ctx.bias = bias_meta(bias)
        return out

    @staticmethod
    def backward(ctx, g):
        x_shape, x_dtype, k_shape, k_dtype = ctx.shapes
        n = math.prod(k_shape[1:])
        res = join_residuals(ctx.tag, ctx.saved_tensors)
        dx2d, dw2d, new = gemm_bwd(g.reshape(-1, n), res, ctx.qset,
                                   need_dw=ctx.needs_input_grad[1],
                                   kernel_cache=ctx.cache)
        if new is not None:
            ctx.qset.write_back(new)
        dw = dw2d.reshape(k_shape).to(k_dtype) if dw2d is not None else None
        return (dx2d.reshape(x_shape).to(x_dtype), dw,
                bias_grad(g.reshape(-1, n), ctx.bias), None, None)


def check_bias(bias, kernel) -> None:
    if bias is not None and tuple(bias.shape) != tuple(kernel.shape[1:]):
        raise ValueError(f"bias {tuple(bias.shape)} does not match the "
                         f"kernel's features {tuple(kernel.shape[1:])}")


def dense(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None, *,
          quantizer_set: QuantizerSet = noop_quantizer_set,
          kernel_cache=None) -> torch.Tensor:
    """``out = x . kernel + bias``, contracting the last dim of ``x`` with
    the first of ``kernel``; the result takes ``x``'s dtype. ``bias`` has
    the kernel's feature shape, or is None. Differentiable in ``x``,
    ``kernel`` and ``bias``; the quantizer set's state is updated by the
    backward (module docstring). ``kernel_cache``: the kernel quantized
    once per step by ``quantize.microbatch.quantize_kernel`` (rebuild it
    after every optimizer step)."""
    if kernel.shape[0] != x.shape[-1]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not contract "
                         f"with x {tuple(x.shape)}")
    check_bias(bias, kernel)
    if needs_grad(x, kernel, bias):
        return _Dense.apply(x, kernel, bias, quantizer_set, kernel_cache)
    return _dense_fwd(x, kernel, bias, quantizer_set, kernel_cache,
                      inference=True)[0]
