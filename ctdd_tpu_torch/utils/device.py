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
def deterministic_training(device):
    """Inside the block on a CUDA device, two identical train steps give
    identical gradients: cuDNN runs its deterministic algorithms without its
    autotuner (PyTorch's defaults pick algorithms that add in another order
    from run to run), and PyTorch's deterministic algorithms are on, so that
    `F.scaled_dot_product_attention`'s memory-efficient backward adds in a
    fixed order (warn-only mode would leave its atomic adds in place),
    without the NaN fill of fresh tensors that they switch on. The caller's
    settings come back after it. A no-op on the CPU. (The math attention
    backend is deterministic too, but it holds the (B, H, L, L) weights.)"""
    if torch.device(device).type != "cuda":
        yield
        return
    import torch.utils.deterministic as det

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        det.fill_uninitialized_memory = saved[4]
