"""Where an entry point runs: on the card unless the caller says otherwise."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for (the
    default of every entry point) and there is none.  Nothing falls back to
    the CPU on its own: pass ``device="cpu"`` to run on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for and no CUDA device is "
            f"available; pass device='cpu' to run on the host")
    return device
