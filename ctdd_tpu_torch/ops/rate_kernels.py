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
- `euler_posterior_draw`, the same kernel in its draw mode: the LBJF update
  argmax(log-posterior + g) as (N, D) int32, with the Gumbel noise g
  injected or made in the kernel (Philox keyed by a seed and a substep);
  it writes no (N, D, S) array. Its launches count in
  `euler_posterior.launches`.

`reverse_rates_plain`, `euler_posterior_plain` and
`euler_posterior_draw_plain` are the plain PyTorch versions (they mirror
`reverse_rates_xla` and `euler_posterior_xla` step by step; the plain draw
takes its noise as an argument); `philox_gumbel` makes the draw mode's
in-kernel noise in PyTorch. A wrapper takes its plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
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


def euler_posterior_draw_plain(rev_rates, x, h, g):
    """The LBJF update argmax(euler_posterior_plain + g), (N, D) int32."""
    return torch.argmax(euler_posterior_plain(rev_rates, x, h) + g,
                        dim=-1).to(torch.int32)


_MASK32 = 0xFFFFFFFF


def _mulhilo32(a, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors a in [0, 2**32)
    and a 32-bit constant m, without leaving int64: m in 16-bit halves."""
    t_hi, t_lo = a * (m >> 16), a * (m & 0xFFFF)  # each < 2**48
    return (t_hi + (t_lo >> 16)) >> 16, (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit
    counter words and a two-word key; the kernels' generator."""
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo32(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_gumbel(seed: int, substep: int, shape, device):
    """The draw mode's in-kernel Gumbel noise, (N, D, S) float32: entry
    (row, s) of the (N * D, S) rows takes word s % 4 of Philox4x32-10 at
    counter (row, s // 4, substep, row >> 32) under the key (seed's low
    word, high word); u = top 24 bits / 2**24, clamped to float32's tiny,
    g = -log(-log(u)) (`utils/math.py::gumbel_noise`)."""
    N, D, S = shape
    chunks = -(-S // 4)
    seed = int(seed) % 2**64
    row = torch.arange(N * D, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(chunks, dtype=torch.int64, device=device)[None, :]
    zeros = torch.zeros((N * D, chunks), dtype=torch.int64, device=device)
    words = philox4x32_10(zeros + (row & _MASK32), zeros + col, zeros + int(substep),
                          zeros + (row >> 32), seed & _MASK32, seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(N * D, 4 * chunks)[:, :S]
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny))).reshape(N, D, S)


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_ulonglong,
            ctypes.c_uint, ctypes.c_void_p,
        ]
    fn.restype = ctypes.c_int
    return fn


def _device_shape(name, t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
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
    dev, N, D, S = _device_shape("reverse_rates", logits)
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
    return _launch_posterior(rev_rates, x, h, draw=False)


def euler_posterior_draw(rev_rates, x, h, *, seed: int = 0, substep: int = 0, g=None):
    """The LBJF update: a draw from the Euler posterior, in one launch.

    Args:
      rev_rates: (N, D, S) f32, 2 <= S <= 256.
      x:         (N, D) int32, values in [0, S).
      h:         python float step size.
      seed:      int in [0, 2**64): the Philox key (low, high words).
      substep:   int in [0, 2**32): the counter word that tells apart the
                 draws made under one seed (a step's corrector steps).
      g:         optional (N, D, S) f32 Gumbel noise used instead of the
                 Philox stream; required on CPU tensors.
    Returns (N, D) int32 argmax(log(post / sum(post) + 1e-35) + g). The
    inputs are checked on either device. On CPU tensors it runs the plain
    version on the given `g` (`philox_gumbel` makes the kernel's stream).
    """
    if not 0 <= int(substep) < 2**32:
        raise ValueError(f"euler_posterior_draw takes 0 <= substep < 2**32, got {substep}")
    if rev_rates.device.type != "cpu":
        return _launch_posterior(rev_rates, x, h, draw=True, g=g, seed=seed,
                                 substep=substep)
    _posterior_inputs(rev_rates, x, g)
    if g is None:
        raise ValueError("euler_posterior_draw on CPU tensors needs the noise g: the "
                         "CPU's LBJF draws it from its generator")
    return euler_posterior_draw_plain(rev_rates, x, h, g)


def _posterior_inputs(rev_rates, x, g):
    """Device and (N, D, S) of the posterior kernel's inputs, checked."""
    dev, N, D, S = _device_shape("euler_posterior", rev_rates)
    _check("rev_rates", rev_rates, (N, D, S), torch.float32, dev)
    _check("x", x, (N, D), torch.int32, dev)
    if g is not None:
        _check("g", g, (N, D, S), torch.float32, dev)
    return dev, N, D, S


def _launch_posterior(rev_rates, x, h, *, draw: bool, g=None, seed: int = 0,
                      substep: int = 0):
    """One launch of `csrc/euler_posterior.cu`: the (N, D, S) log-probs, or
    with `draw` the (N, D) int32 update (`g` injected, or None for the
    Philox stream keyed by `seed` and `substep`)."""
    dev, N, D, S = _posterior_inputs(rev_rates, x, g)
    out = torch.empty((N, D) if draw else (N, D, S),
                      dtype=torch.int32 if draw else torch.float32, device=dev)
    err = _bind("euler_posterior")(
        rev_rates.data_ptr(), x.data_ptr(), None if g is None else g.data_ptr(),
        None if draw else out.data_ptr(), out.data_ptr() if draw else None,
        N * D, S, float(h), int(seed) % 2**64, int(substep),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"euler_posterior kernel launch failed: CUDA error {err}")
    euler_posterior.launches += 1
    return out


reverse_rates.launches = 0
euler_posterior.launches = 0
