"""Where an entry point runs: the one check that a CUDA request has a card."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on; a CUDA request with no card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
