"""Fused tau-leap sampler update: one CUDA kernel per sampler step.

Counterpart of ctdd_tpu/ops/fused_update.py. Unfused, the p0t tau-leap step
is a chain of memory-bound passes over (N*D, S):

    softmax -> gather q_{t|0}(x|.) -> divide -> matmul qt0 -> gather R(.,x)
    -> multiply -> zero-at-x -> poisson(rates*h) -> ordinal jump -> clip

`fused_tau_leap_update` runs the whole chain in one kernel
(`csrc/fused_tau_leap.cu`) that reads the logits once and writes only the
(N, D) int32 state. Both (S, S) tables round to bf16, as in the TPU kernel.

Modes:
- "poisson":  jump counts ~ Poisson(rev * h) by 12-term CDF inversion,
              summed ordinal offset, clip: the TauL step.
- "expected": deterministic drift round(h * sum_s rev * (s - x_g)): the
              MidPointTauL half step.

`x_gather` indexes the tables, the zeroed entry and the state change;
`x_base` is the state the jump is applied to. TauL passes the same tensor.

`fused_tau_leap_update_plain` is the plain PyTorch version with the same
arithmetic (bf16 tables, bf16 `a`, f32 sums, injectable uniforms). The
wrapper takes it for CPU tensors only; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_POISSON_K = 12
MAX_S = 256
_MODES = {"poisson": 0, "expected": 1}


def _poisson_inversion_from_u(u, lam, max_k: int = MAX_POISSON_K):
    """N = #{k : u > P(Poisson(lam) <= k)}, fixed unrolled series (exact up
    to P(N > max_k); see sampling.poisson_inversion)."""
    pmf = torch.exp(-lam)
    cdf = pmf
    n = torch.zeros_like(lam)
    for k in range(1, max_k + 1):
        n = n + (u > cdf).to(lam.dtype)
        pmf = pmf * lam / k
        cdf = cdf + pmf
    return n


def fused_tau_leap_update_plain(
    logits, x_gather, x_base, qt0, rate, h, eps, u=None,
    *, mode: str = "poisson", is_ordinal: bool = True, generator=None,
):
    """Plain PyTorch version of the kernel (mirrors
    ctdd_tpu fused_tau_leap_update_xla step by step).

    `u` (N, D, S) uniforms may be injected; otherwise they are drawn from
    `generator` on the logits' device. Returns (N, D) int32.
    """
    N, D, S = logits.shape
    dev = logits.device
    qt0b = qt0.to(torch.bfloat16)
    rateb = rate.to(torch.bfloat16)
    xg = x_gather.long()
    p = torch.softmax(logits, dim=-1)
    qd = qt0b.t().float()[xg]  # [n, d, s] = qt0[s, x[n, d]]
    fwd = rateb.t().float()[xg]  # R(s, x[n, d])
    a = (p / (qd + eps)).to(torch.bfloat16)
    # bf16 x bf16 products are exact in f32; the sum is f32
    ratio = (a.float().reshape(N * D, S) @ qt0b.float()).reshape(N, D, S)
    iota = torch.arange(S, device=dev)
    oh = (iota == xg[..., None]).float()
    rev = fwd * ratio * (1.0 - oh)
    diff = (iota - xg[..., None]).float()
    if mode == "expected":
        jump = torch.round(h * torch.sum(rev * diff, dim=-1))
    elif mode == "poisson":
        if u is None:
            u = torch.rand(rev.shape, generator=generator, device=dev)
        n = _poisson_inversion_from_u(u, rev * h)
        if not is_ordinal:
            tot = torch.sum(n, dim=-1, keepdim=True)
            n = n * (tot <= 1.0).float()
        jump = torch.sum(n * diff, dim=-1)
    else:
        raise ValueError(mode)
    # |jump| > S clips to the same state; bounding it keeps the int32 sum
    # from overflowing (the kernel does the same)
    jump = jump.clamp(-S, S).to(torch.int32)
    return torch.clamp(x_base.to(torch.int32) + jump, 0, S - 1)


def _seed32(seed: int) -> int:
    """Fold a 64-bit seed into 32 bits with splitmix64's finalizer: the CPU
    generator keeps only a seed's low 32 bits, and the sampler's seeds differ
    in their high word (the step index)."""
    z = (int(seed) + 0x9E3779B97F4A7C15) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    z ^= z >> 31
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _bind():
    from ctdd_tpu_torch.ops import _build

    lib = _build.load("fused_tau_leap")
    fn = lib.fused_tau_leap_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fused_tau_leap_update(
    logits, x_gather, x_base, qt0, rate, h, eps, seed,
    *, mode: str = "poisson", is_ordinal: bool = True, u=None,
):
    """One fused sampler-update step.

    Args:
      logits:   (N, D, S) f32 network output.
      x_gather: (N, D) int32, values in [0, S): indexes tables/mask/change.
      x_base:   (N, D) int32: the state the jump is applied to.
      qt0/rate: (S, S) f32 shared-timestep tables (rounded to bf16 inside).
      h, eps:   python floats.
      seed:     int in [0, 2**64): poisson-mode Philox key (low, high words).
      u:        optional (N, D, S) f32 uniforms used instead of the Philox
                stream (poisson mode).
    Returns (N, D) int32 new state. On CPU tensors it runs the plain
    version, with uniforms from a CPU generator seeded by both words of
    `seed`.
    """
    if mode not in _MODES:
        raise ValueError(mode)
    dev = logits.device
    if dev.type == "cpu":
        gen = None
        if mode == "poisson" and u is None:
            gen = torch.Generator().manual_seed(_seed32(seed))
        return fused_tau_leap_update_plain(
            logits, x_gather, x_base, qt0, rate, h, eps, u,
            mode=mode, is_ordinal=is_ordinal, generator=gen,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_tau_leap_update runs on cpu or cuda, not {dev}")
    N, D, S = logits.shape
    if not 2 <= S <= MAX_S:
        raise ValueError(f"fused_tau_leap_update takes 2 <= S <= {MAX_S}, got {S}")
    _check("logits", logits, (N, D, S), torch.float32, dev)
    _check("x_gather", x_gather, (N, D), torch.int32, dev)
    _check("x_base", x_base, (N, D), torch.int32, dev)
    _check("qt0", qt0, (S, S), torch.float32, dev)
    _check("rate", rate, (S, S), torch.float32, dev)
    if u is not None:
        _check("u", u, (N, D, S), torch.float32, dev)
    qt0b = qt0.to(torch.bfloat16).contiguous()
    qt0Tb = qt0b.t().contiguous()
    rateTb = rate.to(torch.bfloat16).t().contiguous()
    out = torch.empty((N, D), dtype=torch.int32, device=dev)
    launch = _bind()
    err = launch(
        logits.data_ptr(), x_gather.data_ptr(), x_base.data_ptr(),
        qt0b.data_ptr(), qt0Tb.data_ptr(), rateTb.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(),
        N * D, S, float(h), float(eps), int(seed) % 2**64,
        _MODES[mode], int(bool(is_ordinal)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_tau_leap kernel launch failed: CUDA error {err}")
    fused_tau_leap_update.launches += 1
    return out


fused_tau_leap_update.launches = 0
