"""Device resolution shared by every entry point of the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  A
CUDA device with no GPU present raises: nothing silently falls back to
the CPU.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
