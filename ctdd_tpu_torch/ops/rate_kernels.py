"""Reverse rates and the Euler posterior: the two halves of the LBJF step.

Counterpart of ctdd_tpu/ops/pallas_kernels.py. Each function is one CUDA
kernel over (N, D, S) at float32 accuracy (the reverse-rates product runs
on the tensor cores as a 3xTF32 split, big*big + big*small + small*big):

- `reverse_rates` (`csrc/reverse_rates.cu`):
      rate_cols * ((softmax(logits) / qt0_cols) @ qt0),  entry at x zeroed.
  `qt0` is one (S, S) table per sample, (N, S, S), or one table shared by
  the batch, (S, S): the sampler steps share their timestep, and the kernel
  reads the shared table with a batch stride of 0 instead of N copies.
- `euler_posterior` (`csrc/euler_posterior.cu`):
      post0 = rev * (1 - onehot(x));  diag = max(1 - h * sum(post0), 0)
      post  = h * post0 + diag * onehot(x);  log(post / sum(post) + 1e-35)

`reverse_rates_plain` and `euler_posterior_plain` are the plain PyTorch
versions (they mirror `reverse_rates_xla` and `euler_posterior_xla` step by
step). A wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ctdd_tpu_torch.ops.fused_update import MAX_S, _check

LOG_EPS = 1e-35  # a normal float32


def reverse_rates_plain(logits, qt0_cols, qt0, rate_cols, x):
    """R̂ = rate_cols · (softmax(logits) / qt0_cols) @ qt0 with
    R̂[b, d, x[b, d]] = 0. logits/qt0_cols/rate_cols (N, D, S); qt0 (N, S, S)
    or (S, S); x (N, D) int. Returns (N, D, S) float32."""
    N, D, S = logits.shape
    a = torch.softmax(logits, dim=-1) / qt0_cols
    if qt0.dim() == 2:
        ratio = (a.reshape(N * D, S) @ qt0).reshape(N, D, S)
    else:
        ratio = torch.einsum("bds,bsk->bdk", a, qt0)
    rev = rate_cols * ratio
    mask = torch.arange(S, device=logits.device)[None, None, :] == x[:, :, None]
    return torch.where(mask, torch.zeros((), dtype=rev.dtype, device=rev.device),
                       rev)


def euler_posterior_plain(rev_rates, x, h, eps: float = LOG_EPS):
    """LBJF posterior log-probabilities, (N, D, S) float32."""
    S = rev_rates.shape[-1]
    iota = torch.arange(S, device=rev_rates.device)
    xt_onehot = (iota[None, None, :] == x[:, :, None]).to(rev_rates.dtype)
    post0 = rev_rates * (1.0 - xt_onehot)
    off = torch.sum(post0, dim=-1, keepdim=True)
    diag = torch.clamp(1.0 - h * off, min=0.0)
    post = post0 * h + diag * xt_onehot
    return torch.log(post / torch.sum(post, dim=-1, keepdim=True) + eps)


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    from ctdd_tpu_torch.ops import _build

    fn = getattr(_build.load(name), f"{name}_launch")
    if name == "reverse_rates":
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
    fn.restype = ctypes.c_int
    return fn


def _cuda_shape(name, t):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    N, D, S = t.shape
    if not 2 <= S <= MAX_S:
        raise ValueError(f"{name} takes 2 <= S <= {MAX_S}, got {S}")
    return dev, N, D, S


def reverse_rates(logits, qt0_cols, qt0, rate_cols, x):
    """Reverse rates R̂_t(x -> ·) per dim.

    Args:
      logits, qt0_cols, rate_cols: (N, D, S) f32; qt0_cols holds
          q_{t|0}(x | ·) + eps, rate_cols holds R(·, x).
      qt0: (N, S, S) f32, one table per sample, or (S, S) shared.
      x:   (N, D) int32, values in [0, S).
    Returns (N, D, S) f32 with the entry at x exactly 0.
    """
    if logits.device.type == "cpu":
        return reverse_rates_plain(logits, qt0_cols, qt0, rate_cols, x)
    dev, N, D, S = _cuda_shape("reverse_rates", logits)
    _check("logits", logits, (N, D, S), torch.float32, dev)
    _check("qt0_cols", qt0_cols, (N, D, S), torch.float32, dev)
    _check("rate_cols", rate_cols, (N, D, S), torch.float32, dev)
    _check("x", x, (N, D), torch.int32, dev)
    shared = qt0.dim() == 2
    _check("qt0", qt0, (S, S) if shared else (N, S, S), torch.float32, dev)
    out = torch.empty((N, D, S), dtype=torch.float32, device=dev)
    err = _bind("reverse_rates")(
        logits.data_ptr(), qt0_cols.data_ptr(), qt0.data_ptr(),
        rate_cols.data_ptr(), x.data_ptr(), out.data_ptr(),
        N, D, S, 0 if shared else S * S,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"reverse_rates kernel launch failed: CUDA error {err}")
    reverse_rates.launches += 1
    return out


def euler_posterior(rev_rates, x, h):
    """LBJF posterior log-probabilities from reverse rates.

    Args:
      rev_rates: (N, D, S) f32.
      x:         (N, D) int32, values in [0, S).
      h:         python float step size.
    Returns (N, D, S) f32 log(post / sum(post) + 1e-35).
    """
    if rev_rates.device.type == "cpu":
        return euler_posterior_plain(rev_rates, x, h)
    dev, N, D, S = _cuda_shape("euler_posterior", rev_rates)
    _check("rev_rates", rev_rates, (N, D, S), torch.float32, dev)
    _check("x", x, (N, D), torch.int32, dev)
    out = torch.empty((N, D, S), dtype=torch.float32, device=dev)
    err = _bind("euler_posterior")(
        rev_rates.data_ptr(), x.data_ptr(), out.data_ptr(), N * D, S, float(h),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"euler_posterior kernel launch failed: CUDA error {err}")
    euler_posterior.launches += 1
    return out


reverse_rates.launches = 0
euler_posterior.launches = 0
