"""Low-precision dtype tables (counterpart of transformerengine_tpu/
quantize/dtypes.py, in torch dtypes), and the E8M0 scale encoding of
MXFP8: a scale 2^k is stored as the byte k + 127, its biased exponent, in
a uint8 tensor, as the reference stores it."""
from __future__ import annotations

import torch

float8_e4m3 = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

DTYPE_MAX = {
    float8_e4m3: 448.0,
    float8_e5m2: 57344.0,
}

E8M0_BIAS = 127


def dtype_max(dtype: torch.dtype) -> float:
    """Max representable magnitude of ``dtype``."""
    return DTYPE_MAX[dtype]


def is_fp8_dtype(dtype: torch.dtype) -> bool:
    return dtype in (float8_e4m3, float8_e5m2)


def decode_e8m0(e: torch.Tensor) -> torch.Tensor:
    """Biased-exponent uint8 -> the f32 power of two 2^(e - 127), built
    from its bits (exact): e << 23 for e >= 1, and 2^-127, a subnormal,
    for e == 0."""
    bits = e.to(torch.int32) << 23
    bits = torch.where(e == 0, torch.full_like(bits, 1 << 22), bits)
    return bits.view(torch.float32)
