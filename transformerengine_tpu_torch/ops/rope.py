"""Rotary position embeddings (counterpart of transformerengine_tpu/ops/
rope.py rope_frequencies / apply_rope): the "rotate half" layout, with
optional per-token absolute positions."""
from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(dim: int, max_seq_len: int, *, base: float = 10000.0,
                     device=None) -> torch.Tensor:
    """The (max_seq_len, dim / 2) phase table ``t * base^(-2i/dim)``."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    inv_freq = 1.0 / (base ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotates the leading ``2 * freqs.shape[-1]`` channels of ``x``
    (B, S, H, D); ``positions`` (B, S) picks each token's row of the
    table, else rows 0..S-1."""
    s = x.shape[1]
    half = freqs.shape[-1]
    rot = 2 * half
    if positions is not None:
        phase = freqs[positions.long()][:, :, None, :]
    else:
        phase = freqs[:s][None, :, None, :]
    cos, sin = torch.cos(phase), torch.sin(phase)
    xf = x.float()
    x1, x2, x_pass = xf[..., :half], xf[..., half:rot], xf[..., rot:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x_pass],
                    dim=-1)
    return out.to(x.dtype)
