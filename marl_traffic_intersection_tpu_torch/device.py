"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the first CUDA card, and
    raises when there is none rather than running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
