"""Low-precision dtype tables (counterpart of transformerengine_tpu/
quantize/dtypes.py, in torch dtypes)."""
from __future__ import annotations

import torch

float8_e4m3 = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

DTYPE_MAX = {
    float8_e4m3: 448.0,
    float8_e5m2: 57344.0,
}


def dtype_max(dtype: torch.dtype) -> float:
    """Max representable magnitude of ``dtype``."""
    return DTYPE_MAX[dtype]


def is_fp8_dtype(dtype: torch.dtype) -> bool:
    return dtype in (float8_e4m3, float8_e5m2)
