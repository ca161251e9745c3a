"""Device selection for the port's entry points: each defaults to cuda and
raises without one, so a missing card is never a silent CPU run."""

from __future__ import annotations

import torch


def require(device) -> torch.device:
    """``device`` as a torch.device; RuntimeError for cuda without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device
