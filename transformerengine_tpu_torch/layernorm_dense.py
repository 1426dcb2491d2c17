"""Fused norm + dense, forward only (counterpart of transformerengine_tpu/
layernorm_dense.py for a kernel without a quantizer set, or a
prequantized kernel). RMSNorm only; LayerNorm arrives with training."""
from __future__ import annotations

import torch

from .dense import dense
from .ops.normalization import rmsnorm_fwd


def layernorm_dense(x: torch.Tensor, kernel, gamma: torch.Tensor, *,
                    epsilon: float = 1e-6) -> torch.Tensor:
    """``out = rmsnorm(x) . kernel`` in ``x``'s dtype."""
    ln, _ = rmsnorm_fwd(x, gamma, epsilon=epsilon)
    return dense(ln, kernel)
