"""Low-precision dtype tables (counterpart of transformerengine_tpu/
quantize/dtypes.py, in torch dtypes), the E8M0 scale encoding of MXFP8
(a scale 2^k is stored as the byte k + 127, its biased exponent, in a
uint8 tensor, as the reference stores it) and NVFP4's storage: e2m1
values kept one to a byte as the e4m3 bytes of the same values, as the
reference keeps them (exact: every e2m1 value is an e4m3 value). Real
nibble packing happens only in resident prequantized weights
(``quantize/prequant.py``)."""
from __future__ import annotations

import torch

float8_e4m3 = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

DTYPE_MAX = {
    float8_e4m3: 448.0,
    float8_e5m2: 57344.0,
}

E8M0_BIAS = 127

# NVFP4 payloads: e2m1 grid values in e4m3 bytes.
FP4_STORAGE_DTYPE = float8_e4m3
# The 8 non-negative values of FP4 E2M1, and the largest.
FP4_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
FP4_MAX = 6.0


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
