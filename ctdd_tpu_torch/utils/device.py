"""Where the port runs: the GPU, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for the CPU; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: pass device="cpu" to run the port on the CPU'
        )
    return dev
