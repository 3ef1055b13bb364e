"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when the card is asked for and there is none: the port runs on
    the CPU only when the caller says so (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass device='cpu' to run it on the CPU"
        )
    return dev
