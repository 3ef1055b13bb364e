"""The device the port's entry points run on, and its f32 arithmetic."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def true_f32():
    """cuDNN convolutions and cuBLAS products in true f32 inside the block:
    both may otherwise run in TF32 on the card (cuDNN does by default), and
    the mapping stages' keypoints and points are compared with the JAX
    package's f32 ones. The flags are restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
