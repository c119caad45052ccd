"""Where the port runs: the GPU, unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for the CPU; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: pass device="cpu" to run the port on the CPU'
        )
    return dev


@contextlib.contextmanager
def tf32(enabled: bool):
    """float32 matmuls and convolutions with TF32 rounding (`enabled`) or
    without it inside the block; the caller's settings come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32_off():
    """`tf32(False)`: float32 without TF32 rounding inside the block."""
    return tf32(False)


@contextlib.contextmanager
def deterministic_cudnn(device):
    """cuDNN's deterministic algorithms, without its autotuner, inside the
    block on a CUDA device, so that two identical train steps give identical
    gradients (PyTorch's defaults pick algorithms that add in another order
    from run to run); the caller's settings come back after it. A no-op on
    the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
