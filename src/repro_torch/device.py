"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`, refusing ``cuda`` on a machine
    without a usable card (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card, but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch versions on the CPU")
    return dev
