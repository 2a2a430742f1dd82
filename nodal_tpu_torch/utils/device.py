"""Where an entry point runs."""

from __future__ import annotations

import torch


def resolve_device(device, who: str = "BatchedSolver") -> torch.device:
    """The device an entry point ``who`` runs on: CUDA, which must be
    available, or the CPU when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}(device='cuda'): CUDA is not available; pass "
                "device='cpu' for the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
