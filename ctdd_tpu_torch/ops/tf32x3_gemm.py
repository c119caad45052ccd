"""float32 matrix products on the H100's tensor cores at float32 accuracy:
the hand-written 3xTF32 GEMM of `csrc/tf32x3_gemm.cu`.

It replaces no TPU kernel: the JAX package leaves its dense products to XLA.
On the H100, cuBLAS runs a float32 product with TF32 off on the CUDA cores
(FFMA, 66.9 TFLOP/s); single TF32 on the tensor cores keeps 10 bits of
mantissa, a lower precision. The kernel takes each operand as the sum of two
TF32 numbers, v = hi + lo (hi = v rounded to nearest, lo = the rest rounded
again), and each product as lo*hi + hi*lo + hi*hi, in float32 sums; only
lo*lo (2^-22 of the product) is dropped. Its bound is the TF32 peak over
three, 494.7 / 3 = 164.9 TFLOP/s (`csrc/tf32x3_gemm.cu` says what its design
does about it).

- `matmul(a, b)`: a (M, K) @ b (K, N) -> (M, N) float32. Each operand is a
  contiguous matrix or the transpose of one (but not both transposes), so
  a linear layer's forward (x @ w.T), its input's gradient (g @ w) and its
  weight's gradient (g.T @ x) run without a transposed copy. Its launches
  count in `matmul.launches`, their FLOPs (2 M N K each) in `matmul.flops`.
- `matmul_plain(a, b)`: the same arithmetic in PyTorch (the split, three
  float32 products); `matmul` takes it for CPU tensors only, and counts
  nothing. For a CUDA tensor it launches the kernel or raises.
- `linear(x, *weights, kernel_forward=True)`: x @ w.T over the last axis
  for each weight, with a gradient: a `Dense` autograd function. Its input
  gradient and its weight gradient are one launch each over the weights'
  rows; its forward is one launch too, or, with `kernel_forward=False`,
  `F.linear` a weight: cuBLAS's own float32 product and rounding, for a
  product whose output reaches a discrete choice that must match a plain
  float32 model's. On the CPU the same function runs over `matmul_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: `cvt.rna.tf32.f32` for finite values, as the kernel
    computes it (an integer add and a mask)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32 numbers, with v = hi + lo + O(2^-22 |v|)."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it: lo*hi + hi*lo first, then hi*hi,
    each product of TF32 numbers exact in float32, the sums float32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return torch.addmm(torch.addmm(al @ bh, ah, bl), ah, bh)


@functools.lru_cache(maxsize=None)
def _bind():
    from ctdd_tpu_torch.ops import _build

    fn = _build.load("tf32x3_gemm").tf32x3_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _major(name: str, t: torch.Tensor) -> int:
    """1 where the matrix's rows are contiguous (its second axis is the
    inner one), 0 where it is the transpose of such a matrix."""
    rows, cols = t.shape
    if t.stride() == (cols, 1) or cols == 1:
        return 1
    if t.stride() == (1, rows) or rows == 1:
        return 0
    raise ValueError(f"tf32x3 matmul: {name} {tuple(t.shape)} with strides {t.stride()} is "
                     "neither contiguous nor the transpose of a contiguous matrix")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) float32 at float32 accuracy."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tf32x3 matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tf32x3 matmul runs on cpu or on one cuda device, not "
                         f"{a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"tf32x3 matmul takes float32, not {a.dtype} and {b.dtype}")
    (M, K), N = a.shape, b.shape[1]
    a_rows, b_rows = _major("a", a), _major("b", b)
    if not a_rows and not b_rows:
        raise ValueError("tf32x3 matmul: a transposed a with a transposed b is not built "
                         "(a linear layer's products never take it)")
    # TMA reads whole 16-byte units: row pitches and base addresses too
    for name, t, pitch in (("a", a, K if a_rows else M), ("b", b, N if b_rows else K)):
        if pitch % 4 or t.data_ptr() % 16:
            raise ValueError(f"tf32x3 matmul: {name}'s rows are not whole 16-byte units "
                             f"(pitch {pitch} floats)")
    if N % 4:
        raise ValueError(f"tf32x3 matmul: N={N} is not a multiple of 4")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M and N:
        err = _bind()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, a_rows, b_rows,
                      torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"tf32x3 matmul launch failed: CUDA error {err}")
        matmul.launches += 1
        matmul.flops += 2 * M * N * K
    return out


matmul.launches = 0
matmul.flops = 0


class Dense(torch.autograd.Function):
    """(x @ w.T for each weight) over x's last axis. The input gradient is
    g @ cat(weights), the weight gradient g.T @ x, with g the outputs'
    gradients side by side: one `matmul` each. The forward is one `matmul`
    over cat(weights), or `F.linear` a weight where `kernel_forward` is
    false."""

    @staticmethod
    def forward(ctx, x, kernel_forward, *weights):
        ctx.save_for_backward(x, *weights)
        rows = [w.shape[0] for w in weights]
        if not kernel_forward:
            return tuple(F.linear(x, w) for w in weights)
        w = weights[0] if len(weights) == 1 else torch.cat(weights)
        y = matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.t())
        return y.view(*x.shape[:-1], y.shape[-1]).split(rows, dim=-1)

    @staticmethod
    def backward(ctx, *grads):
        x, *weights = ctx.saved_tensors
        g = torch.cat([g.reshape(-1, g.shape[-1]) for g in grads], dim=1) if len(grads) > 1 \
            else grads[0].reshape(-1, grads[0].shape[-1]).contiguous()
        w = weights[0] if len(weights) == 1 else torch.cat(weights)
        dx = matmul(g, w).view(x.shape) if ctx.needs_input_grad[0] else None
        parts = (None,) * len(weights)
        if any(ctx.needs_input_grad[2:]):
            parts = matmul(g.t(), x.reshape(-1, x.shape[-1]).contiguous()).split(
                [wi.shape[0] for wi in weights])
        return (dx, None, *parts)


def linear(x: torch.Tensor, *weights: torch.Tensor,
           kernel_forward: bool = True) -> Tuple[torch.Tensor, ...]:
    """x (..., K) @ w.T -> (..., N_w) for each weight, forward and backward
    through `Dense`."""
    return Dense.apply(x, kernel_forward, *weights)
