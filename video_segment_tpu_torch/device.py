"""Device selection: explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for but absent
    (the port never moves work to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
