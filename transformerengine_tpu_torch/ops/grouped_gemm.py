"""Grouped (ragged) matmuls of the MoE experts (counterpart of
transformerengine_tpu/ops/grouped_gemm.py, which computes them with
XLA's ``lax.ragged_dot``). Rows are expert-contiguous: the first
``group_sizes[0]`` rows belong to expert 0, and so on; rows past the
groups give zeros. Each expert's slice is one product with exact
products and f32 accumulation (``matmul_f32``); an expert with no rows
gives an empty product and, in :func:`grouped_gemm_dw`, a zero gradient.

``group_sizes`` is a host sequence of ints or an (E,) int32 tensor. Where
it is a tensor and the product is bf16 throughout (bf16 operands, no
tensor scale, bf16 out), :func:`grouped_gemm` and :func:`grouped_gemm_tn`
read no size on the host: one ``torch._grouped_mm`` over the sizes'
cumulative sums on the device (f32 sums, one bf16 rounding), as the
reference's ``ragged_dot`` takes device sizes, so a captured decode step
can run them. Any other product reads a tensor's sizes back once per
call (:func:`host_sizes`, which raises inside a capture), so callers that
run several grouped GEMMs over one grouping with a gradient (a MoE
layer's forward and backward) read it once and pass the host values.

Operands may be quantized (``ScaledTensor1x``): per-tensor-scaled
payloads widen to bf16 and their scales multiply the f32 result;
block-scaled ones are dequantized and rounded to bf16 first, as the
reference's ``_dq`` does (exact for MXFP8 into bf16)."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..quantize.tensor import ScaledTensor1x
from .gemm import matmul_f32

GroupSizes = Union[Sequence[int], torch.Tensor]


def host_sizes(group_sizes: GroupSizes) -> Tuple[int, ...]:
    """The group sizes as host ints (one read of a card tensor, which a
    CUDA graph capture cannot make)."""
    if isinstance(group_sizes, torch.Tensor):
        if group_sizes.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a grouped GEMM with tensor-scaled or non-bf16 operands reads"
                " its group sizes to the host, which a captured step cannot"
                " do")
        return tuple(group_sizes.tolist())
    return tuple(int(n) for n in group_sizes)


def _dq(t):
    """(bf16 or unquantized operand, f32 scale of the product or None)."""
    if not isinstance(t, ScaledTensor1x):
        return t, None
    if t.scaling_mode.is_tensor_scaling:
        return t.data.to(torch.bfloat16), t.scale_inv.float().reshape(())
    return t.dequantize().to(torch.bfloat16), None


def _scaled(out: torch.Tensor, *scales) -> torch.Tensor:
    scales = [s for s in scales if s is not None]
    if not scales:
        return out
    post = scales[0] if len(scales) == 1 else scales[0] * scales[1]
    return out * post


def _row_products(lhs, rhs_of, sizes, n_out: int, out_dtype) -> torch.Tensor:
    """(N, n_out): each expert's row slice of ``lhs`` times ``rhs_of(e)``,
    zeros past the groups."""
    out = torch.empty((lhs.shape[0], n_out), dtype=out_dtype,
                      device=lhs.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = matmul_f32(lhs[start:start + n],
                                              rhs_of(e))
        start += n
    out[start:].zero_()
    return out


def _on_device(lhs, rhs, sl, sr, group_sizes, out_dtype) -> bool:
    """True where the product takes :func:`_device_products`: sizes in a
    tensor, no scale, bf16 in and out."""
    return (isinstance(group_sizes, torch.Tensor) and sl is None
            and sr is None
            and lhs.dtype == rhs.dtype == out_dtype == torch.bfloat16)


def _device_products(lhs, rhs, group_sizes: torch.Tensor) -> torch.Tensor:
    """(N, n_out) bf16: each expert's row slice of ``lhs`` times its
    slice of ``rhs`` (E, K, n_out), zeros past the groups, with the sizes
    left on the device."""
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    out = torch._grouped_mm(lhs, rhs, offs=offs)
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return torch.where((rows < offs[-1])[:, None], out, 0)


def grouped_gemm(x, kernels, group_sizes: GroupSizes,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``out[n] = x[n] @ kernels[expert_of(n)]``: x (N, K), kernels (E, K,
    M) -> (N, M), the f32 products rounded once to ``out_dtype``."""
    xb, sx = _dq(x)
    kb, sk = _dq(kernels)
    if _on_device(xb, kb, sx, sk, group_sizes, out_dtype):
        return _device_products(xb, kb, group_sizes)
    out = _row_products(xb, lambda e: kb[e], host_sizes(group_sizes),
                        kb.shape[2], torch.float32 if sx is not None
                        or sk is not None else out_dtype)
    return _scaled(out, sx, sk).to(out_dtype)


def grouped_gemm_tn(x, kernels_t, group_sizes: GroupSizes,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`grouped_gemm` against kernels stored (E, M, K)."""
    xb, sx = _dq(x)
    kb, sk = _dq(kernels_t)
    if _on_device(xb, kb, sx, sk, group_sizes, out_dtype):
        return _device_products(xb, kb.transpose(1, 2), group_sizes)
    out = _row_products(xb, lambda e: kb[e].t(), host_sizes(group_sizes),
                        kb.shape[1], torch.float32 if sx is not None
                        or sk is not None else out_dtype)
    return _scaled(out, sx, sk).to(out_dtype)


def grouped_gemm_dgrad(g, kernels_t, group_sizes: GroupSizes,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """``dx[n] = g[n] @ kernels_t[expert_of(n)]``: g (N, M), kernels_t (E,
    M, K) -> (N, K), contracting M."""
    gb, sg = _dq(g)
    kb, sk = _dq(kernels_t)
    out = _row_products(gb, lambda e: kb[e], host_sizes(group_sizes),
                        kb.shape[2], torch.float32 if sg is not None
                        or sk is not None else out_dtype)
    return _scaled(out, sg, sk).to(out_dtype)


def grouped_gemm_dw(x, g, group_sizes: GroupSizes, num_experts: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-expert wgrad ``dW[e] = x_e^T @ g_e``: x (N, K), g (N, M) -> (E,
    K, M); zero for an expert with no rows."""
    xb, sx = _dq(x)
    gb, sg = _dq(g)
    sizes = host_sizes(group_sizes)
    if len(sizes) != num_experts:
        raise ValueError(f"{len(sizes)} group sizes for {num_experts} "
                         f"experts")
    scale = _scaled(torch.ones((), device=xb.device), sx, sg) \
        if sx is not None or sg is not None else None
    out = torch.empty((num_experts, xb.shape[1], gb.shape[1]),
                      dtype=out_dtype, device=xb.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            dw = matmul_f32(xb[start:start + n].t(), gb[start:start + n])
            out[e] = dw if scale is None else dw * scale
        else:
            out[e].zero_()
        start += n
    return out
