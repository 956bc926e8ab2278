"""The device the port runs on, shared by the aligner and the LM code."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``None`` means the card, which must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
