"""Decode GEMM: small-M activations against a resident (N, K) weight
(counterpart of transformerengine_tpu/ops/decode_matmul.py
decode_tn_matvec). On CUDA tensors it launches the kernel in
``csrc/decode_matvec.cu``; on CPU tensors it runs the plain version."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

_X_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def use_decode_matvec(m: int, n: int, k: int) -> bool:
    """Shapes that the resident-weight GEMMs route to the decode kernel."""
    return m <= 32 and n >= 1024 and k >= 1024 and k % 128 == 0


def decode_tn_matvec_plain(x: torch.Tensor, w: torch.Tensor,
                           scale_inv: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``x @ w.T * scale_inv`` with exact products and f32 sums."""
    out = x.float() @ w.float().t()
    if scale_inv is not None:
        out = out * scale_inv.float().reshape(())
    return out


def decode_tn_matvec(x: torch.Tensor, w_payload: torch.Tensor,
                     scale_inv: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(M, N) f32 ``out = x (M, K) . w_payload (N, K)^T * scale_inv``.

    ``x`` is bf16 or f32 with M <= 32 (another dtype, such as an fp8
    activation payload, is widened to bf16 first); ``w_payload`` is the
    e4m3 or bf16 resident weight; ``scale_inv`` an optional one-element
    f32 dequant scale."""
    if x.dim() != 2 or w_payload.dim() != 2 or \
            w_payload.shape[1] != x.shape[1]:
        raise ValueError(f"expected x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w_payload.shape)}")
    if scale_inv is not None and scale_inv.numel() != 1:
        raise ValueError("scale_inv must hold one value")
    if w_payload.dtype not in _W_DTYPES:
        raise TypeError(f"the decode kernel takes e4m3 or bf16 weights, got "
                        f"{w_payload.dtype}")
    if x.dtype not in _X_DTYPES:
        x = x.to(torch.bfloat16)    # an fp8 activation payload, exactly
    if _build.on_cpu(x, w_payload, scale_inv):
        return decode_tn_matvec_plain(x, w_payload, scale_inv)
    m, k = x.shape
    n = w_payload.shape[0]
    if m > 32 or k % 16:
        raise ValueError(f"the decode kernel takes M <= 32 and K % 16 == 0, "
                         f"got M={m}, K={k}")
    x_code = _build.dtype_code(x, _X_DTYPES)
    w_code = _build.dtype_code(w_payload, _W_DTYPES)
    if scale_inv is not None:
        scale_inv = scale_inv.float().reshape(1).contiguous()
    _build.check_aligned(x, w_payload, scale_inv)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch("te_decode_tn_matvec", _build.ptr(x), x_code,
                  _build.ptr(w_payload), w_code, _build.ptr(scale_inv),
                  _build.ptr(out), m, n, k, _build.stream(x))
    _build.LAUNCHES["decode_tn_matvec"] += 1
    return out
