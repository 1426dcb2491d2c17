"""The random Hadamard transform (RHT) of the NVFP4 recipe (counterpart
of transformerengine_tpu/quantize/hadamard.py): a 16 x 16 Hadamard
matrix with a sign per row, normalized by 1/4, applied along the last
axis in runs of 16 before the colwise usage is quantized.

Every product is exact (the entries are +-0.25), so the result depends
only on the order of the 16-term f32 sums. The port fixes that order, as
``csrc/nvfp4_quantize.cu`` does: four partial sums, the one of r summing
the terms i = r, r + 4, r + 8, r + 12 in turn from +0, then
(s0 + s1) + (s2 + s3). It is the order in which the reference's f32 dot
sums on the CPU (XLA), so the rotated values equal the reference's bit
for bit there; it never goes through ``torch.matmul``, whose order on the
card is cuBLAS's to choose."""
from __future__ import annotations

import numpy as np
import torch

RHT_DIM = 16


def hadamard_matrix(dim: int = RHT_DIM) -> np.ndarray:
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < dim:
        h = np.block([[h, h], [h, -h]])
    return h


def rht_matrix_np(sign_mask: int = 0, dim: int = RHT_DIM) -> np.ndarray:
    """The normalized Hadamard matrix with row i negated where bit i of
    ``sign_mask`` is set, so the forward and backward use one rotation."""
    h = hadamard_matrix(dim)
    signs = np.array([-1.0 if (sign_mask >> i) & 1 else 1.0
                      for i in range(dim)], dtype=np.float32)
    return ((signs[:, None] * h) / np.sqrt(dim)).astype(np.float32)


def rht_matrix(sign_mask: int = 0, device=None) -> torch.Tensor:
    """(16, 16) f32 rotation on ``device``, built there (entry (i, j) is
    +-1/4: the sign of (-1)^popcount(i & j), negated where bit i of the
    mask is set), so no host-to-device copy is needed."""
    i = torch.arange(RHT_DIM, device=device)
    ij = i[:, None] & i[None, :]
    parity = sum((ij >> b) & 1 for b in range(4)) & 1
    flip = ((sign_mask >> i) & 1)[:, None]
    return torch.where((parity ^ flip) == 1, -0.25, 0.25).float()


def rotate(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x`` (..., C), C a multiple of 16, times the (16, 16) ``m`` on each
    run of 16 along the last axis, in f32, summed in the module's order."""
    if x.shape[-1] % RHT_DIM:
        raise ValueError(f"the RHT runs along a last dim that is a multiple "
                         f"of {RHT_DIM}, got {tuple(x.shape)}")
    xr = x.float().reshape(*x.shape[:-1], x.shape[-1] // RHT_DIM, RHT_DIM, 1)
    m = m.float().to(x.device)
    parts = []
    for r in range(4):
        acc = torch.zeros_like(xr[..., 0, :].expand(*xr.shape[:-2], RHT_DIM))
        for i in range(r, RHT_DIM, 4):
            acc = acc + xr[..., i, :] * m[i]
        parts.append(acc)
    return ((parts[0] + parts[1]) + (parts[2] + parts[3])).reshape(x.shape)


def apply_rht(x: torch.Tensor, sign_mask: int = 0) -> torch.Tensor:
    """The RHT along the last axis (a multiple of 16), in f32."""
    return rotate(x, rht_matrix(sign_mask, x.device))


def apply_rht_inverse(x: torch.Tensor, sign_mask: int = 0) -> torch.Tensor:
    """The inverse, the transposed matrix (the normalized RHT is
    orthogonal)."""
    return rotate(x, rht_matrix(sign_mask, x.device).t())
