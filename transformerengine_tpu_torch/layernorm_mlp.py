"""Fused norm + MLP block, forward only (counterpart of
transformerengine_tpu/layernorm_mlp.py for kernels without quantizer
sets, or prequantized kernels). RMSNorm only."""
from __future__ import annotations

from typing import Sequence, Union

import torch

from .dense import forward_gemm
from .ops.activation import _ACT, normalize_activation_type
from .ops.normalization import rmsnorm_fwd


def layernorm_mlp(x: torch.Tensor, gamma: torch.Tensor, kernel1, kernel2, *,
                  epsilon: float = 1e-6,
                  activation_type: Union[str, Sequence[str]] = "swiglu"
                  ) -> torch.Tensor:
    """``dense(act(dense(rmsnorm(x))))``. ``kernel1`` is (hidden, n_act,
    ffn), with n_act = 2 for gated activations; ``kernel2`` is (ffn,
    hidden). The gated product is taken on the flat (M, n_act * ffn) GEMM
    output sliced at the ffn boundary, in ``x``'s dtype."""
    acts = normalize_activation_type(activation_type)
    hidden = x.shape[-1]
    ffn = kernel1.shape[-1]
    if len(kernel1.shape) == 3 and kernel1.shape[1] != len(acts):
        raise ValueError(f"kernel1 n_act dim {kernel1.shape[1]} != "
                         f"{len(acts)} activations")
    ln, _ = rmsnorm_fwd(x, gamma, epsilon=epsilon)
    z2d = forward_gemm(ln.reshape(-1, hidden), kernel1).to(x.dtype)
    if len(acts) == 2:
        a2d = _ACT[acts[0]](z2d[:, :ffn]) * _ACT[acts[1]](z2d[:, ffn:])
    else:
        a2d = _ACT[acts[0]](z2d)
    out2d = forward_gemm(a2d.to(x.dtype), kernel2)
    return out2d.reshape(x.shape).to(x.dtype)
