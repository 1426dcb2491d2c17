"""Decode GEMMs: small-M activations against a resident weight
(counterpart of transformerengine_tpu/ops/decode_matmul.py).

:func:`decode_tn_matvec` takes a per-tensor-scaled or plain (N, K)
weight and launches ``csrc/decode_matvec.cu``; :func:`decode_kn_matvec`
takes a block-scaled (K, N) weight (e4m3 bytes, or nibble-packed e2m1
codes) and launches ``csrc/decode_kn_matvec.cu``. On CPU tensors each
runs its plain version."""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

_X_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)
# The fewest stored rows of the (K, N) payload that one block of the KN
# kernel sums (kMmaChunk in csrc/decode_kn_matvec.cu; the FMA body's
# kChunk is larger): the K chunks' partial sums take at most
# ceil(K_store / _KN_CHUNK) * M * N floats of workspace.
_KN_CHUNK = 256


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


def _e2m1_code_to_e4m3_bits(code: torch.Tensor) -> torch.Tensor:
    """4-bit e2m1 codes (int32) -> the e4m3 bytes of the same values
    (exact: e2m1's magnitudes {0, .5, 1, 1.5, 2, 3, 4, 6} are e4m3
    values); the sign moves from bit 3 to bit 7."""
    mag = code & 7
    byte = torch.where(mag < 2, mag * 48, mag * 4 + 48)
    return byte | ((code & 8) << 4)


def _unpack_nibbles_to_bf16(packed: torch.Tensor):
    """(rows, n) uint8 split-plane packed e2m1 codes -> two (rows, n) bf16
    halves: the low nibbles are code rows [0, rows), the high ones
    [rows, 2 * rows)."""
    p = packed.to(torch.int32)
    return [_e2m1_code_to_e4m3_bits(code).to(torch.uint8).view(
                torch.float8_e4m3fn).to(torch.bfloat16)
            for code in (p & 15, p >> 4)]


def dequantize_kn(payload: torch.Tensor, scale: torch.Tensor, block: int,
                  packed: bool = False) -> torch.Tensor:
    """(K, N) bf16 weight of a block-scaled (K, N) payload (or a (K/2, N)
    packed one): each code times its row block's bf16 scale, multiplied in
    bf16 (exact for these payloads and power-of-two or e4m3 scales)."""
    if packed:
        w = torch.cat(_unpack_nibbles_to_bf16(payload), dim=0)
    else:
        w = payload.to(torch.bfloat16)
    k, n = w.shape
    return (w.reshape(k // block, block, n)
            * scale.to(torch.bfloat16)[:, None, :]).reshape(k, n)


def decode_kn_matvec_plain(x: torch.Tensor, payload: torch.Tensor,
                           scale: torch.Tensor,
                           out_scale: Optional[torch.Tensor] = None, *,
                           block: int, packed: bool = False) -> torch.Tensor:
    """``x @ dequantize_kn(...) * out_scale`` with exact products and f32
    sums."""
    out = x.float() @ dequantize_kn(payload, scale, block, packed).float()
    if out_scale is not None:
        out = out * out_scale.float().reshape(())
    return out


def decode_kn_matvec(x: torch.Tensor, payload: torch.Tensor,
                     scale: torch.Tensor,
                     out_scale: Optional[torch.Tensor] = None, *,
                     block: int, packed: bool = False) -> torch.Tensor:
    """(M, N) f32 ``out = x (M, K) . dequantize_kn(payload, scale) *
    out_scale``.

    ``x`` is bf16 or f32 with M <= 32 (another dtype is widened to bf16
    first); ``payload`` is the (K, N) e4m3 block-scaled weight, or with
    ``packed`` its (K/2, N) uint8 split-plane e2m1 codes; ``scale`` the
    (K / block, N) bf16 block scales; ``out_scale`` an optional
    one-element f32 second-level scale. A launch counts under
    ``decode_kn_matvec``, or ``decode_kn_matvec_packed`` for the packed
    branch."""
    if x.dim() != 2 or payload.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"expected x (M, K), payload (K, N) and scale "
                         f"(K / block, N), got {tuple(x.shape)}, "
                         f"{tuple(payload.shape)}, {tuple(scale.shape)}")
    m, k = x.shape
    n = payload.shape[1]
    if payload.shape[0] != (k // 2 if packed else k) or \
            scale.shape != (k // block, n) or k % block:
        raise ValueError(f"payload {tuple(payload.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit K={k}, "
                         f"block={block}, packed={packed}")
    want = torch.uint8 if packed else torch.float8_e4m3fn
    if payload.dtype != want:
        raise TypeError(f"the payload must be {want}, got {payload.dtype}")
    if out_scale is not None and out_scale.numel() != 1:
        raise ValueError("out_scale must hold one value")
    if x.dtype not in _X_DTYPES:
        x = x.to(torch.bfloat16)
    if _build.on_cpu(x, payload, scale, out_scale):
        return decode_kn_matvec_plain(x, payload, scale, out_scale,
                                      block=block, packed=packed)
    if m > 32 or n % 16 or block % 4 or (packed and k % (2 * block)):
        raise ValueError(f"the KN kernel takes M <= 32, N % 16 == 0, "
                         f"block % 4 == 0 (and K % (2 * block) == 0 "
                         f"packed), got M={m}, N={n}, block={block}")
    x_code = _build.dtype_code(x, _X_DTYPES)
    scale = scale.to(torch.bfloat16)
    if out_scale is not None:
        out_scale = out_scale.float().reshape(1).contiguous()
    _build.check_aligned(x, payload, scale, out_scale)
    splits = -(-payload.shape[0] // _KN_CHUNK)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch("te_decode_kn_matvec", _build.ptr(x), x_code,
                  _build.ptr(payload), int(packed), _build.ptr(scale),
                  _build.ptr(out_scale), _build.ptr(ws), _build.ptr(out), m,
                  n, k, block, _build.stream(x))
    _build.LAUNCHES["decode_kn_matvec_packed" if packed
                    else "decode_kn_matvec"] += 1
    return out
