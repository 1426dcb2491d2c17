"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only
when the caller asks for it; with no card they raise instead of quietly
running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raises unless every named tensor lies on ``device``'s type."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(f"{name} lies on {t.device}, expected {device}")
