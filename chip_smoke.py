"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--kernels-only]

`--kernels-only` stops after the phases that build, check and time the
kernels (1-4, 8, 9) and prints no result lines: a quick check of a kernel
change.

Phases (any fault exits non-zero; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA kernel of the port from csrc/, in parallel;
              count the tensor-core MMA ops in each binary
  3. kernels  fused tau-leap kernel vs its plain PyTorch version on the card,
              S in {256, 8, 3, 2}, row counts below and across its tile
  4. timing   kernel, plain version and bound at N=256 and N=16 (D=784,
              S=256): device time from a trace, and a back-to-back loop
  5. unet     full-width logits on the card vs the port's CPU logits, and
              tau-leap and LBJF steps on the card vs the CPU with the same
              injected noise
  6. steps    where a batch-16 TauL step's time goes (torch.profiler)
  7. serving  a seeded full-width checkpoint served over HTTP: two 1000-step
              batches of the flagship sampler with the fused update
  8. rates    reverse-rates and Euler-posterior kernels vs their plain
              versions, per-sample and shared tables, real process tables
  9. timing   both kernels, plain versions and bounds at N=256 and N=16
              (phases 8 and 9 run straight after 4)
 10. steps    where a batch-16 LBJF step's time goes
 11. serving  three more seeded checkpoints over HTTP, each with its exact
              launch counts: the flagship with LBJF and a live corrector
              (1000 steps), tauUnet_mnist_ll (MidPointTauL, fused) and
              tauUnet_maze (LBJF/200)
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 tensor cores
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RATE_ROW_TOL = 2e-5  # reverse rates: share of a row's largest |value|
POST_PROB_TOL = 2e-6  # Euler posterior: probabilities exp(out)
POST_LOG_TOL = 5e-5  # Euler posterior: log-probabilities off the entry at x
MAX_FLIP_FRAC = 1e-3  # kernel vs plain: rounding ties under another sum order
STEP_FLIP_FRAC = 5e-3  # whole steps, card vs CPU: network logits differ too


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    """`ptxas -v` in one line: registers of every kernel instantiation (a
    template gives several), the largest spill, static shared memory."""
    import re

    if not report:
        return "already built"
    regs = re.findall(r"Used (\d+) registers", report)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
    smem = re.findall(r"(\d+) bytes smem", report)
    return (f"ptxas -v: registers {', '.join(regs)}; spill stores at most "
            f"{max(spills, default=0)} bytes; static shared memory "
            f"{', '.join(smem) or '0'} bytes (the rest is dynamic)")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time of one call of `fn`: every kernel it launches, summed from
    a torch.profiler trace and divided by the calls. Unlike `cuda_ms` it
    leaves out the time the card waits for the host between launches, which
    is most of a back-to-back loop at the serving shape (N=16). 0.0 where
    the profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


def timed(kernel, plain, iters: int) -> dict:
    """A kernel's wrapper and its plain version: `loop_ms` is a back-to-back
    loop between CUDA events, `device_ms` the device time alone. `ms` is the
    device time where the profiler traced the card, else the loop's."""
    out = dict(loop_ms=cuda_ms(kernel, iters), device_ms=device_ms(kernel, iters),
               plain_loop_ms=cuda_ms(plain, max(iters // 10, 3)),
               plain_device_ms=device_ms(plain, max(iters // 10, 3)))
    traced = bool(out["device_ms"] and out["plain_device_ms"])
    out.update(ms=out["device_ms" if traced else "loop_ms"],
               plain_ms=out["plain_device_ms" if traced else "plain_loop_ms"],
               timed_by="device trace" if traced else "events around a loop")
    return out


# ---------------------------------------------------------------------------
# phase 3/4 inputs: real GaussianTargetRate tables at one sampler step
# ---------------------------------------------------------------------------


def fused_inputs(N, D, S, step, seed, dev):
    """Tables of the serving path that runs this S, at `step` thousandths
    of its time grid."""
    from ctdd_tpu_torch.sampling.samplers import _shared_mats

    proc, (ts, hs) = rate_process(S, dev)
    step = min(step * len(ts) // 1000, len(ts) - 1)
    qt0, rate = _shared_mats(proc, float(ts[step]))
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 2.0 * torch.randn((N, D, S), generator=g, device=dev)
    x = torch.randint(0, S, (N, D), generator=g, device=dev, dtype=torch.int32)
    u = torch.rand((N, D, S), generator=g, device=dev)
    return logits, x, qt0, rate, u, float(hs[step])


def phase_kernels(dev) -> float:
    """Kernel vs plain version; returns the largest state difference."""
    from ctdd_tpu_torch.ops import fused_update as fu

    worst = 0
    # the serving shape, rows ragged against the kernel's 96-row tile, fewer
    # rows than one warp's 16, and the small state spaces (maze S=3, S=2)
    cases = [(16, 784, 256), (3, 77, 256), (16, 64, 8), (3, 77, 8),
             (1, 5, 256), (1, 5, 8), (16, 225, 3), (1, 5, 3), (5, 32, 2)]
    flipped = 0.0
    for N, D, S in cases:
        for step, h_scale in ((100, 1.0), (500, 1.0), (500, 30.0), (950, 1.0)):
            logits, x, qt0, rate, u, h = fused_inputs(N, D, S, step, N * D + step, dev)
            h *= h_scale
            xg = torch.clamp(x + 1, 0, S - 1).to(torch.int32)  # distinct gather
            for mode, uu, gather in (("expected", None, x), ("expected", None, xg),
                                     ("poisson", u, x)):
                for ordinal in (True, False):
                    k = fu.fused_tau_leap_update(
                        logits, gather, x, qt0, rate, h, 1e-9, 0, mode=mode,
                        is_ordinal=ordinal, u=uu)
                    torch.cuda.synchronize()
                    p = fu.fused_tau_leap_update_plain(
                        logits, gather, x, qt0, rate, h, 1e-9, uu, mode=mode,
                        is_ordinal=ordinal)
                    diff = (k - p).abs()
                    frac = (diff > 0).float().mean().item()
                    worst = max(worst, int(diff.max().item()))
                    flipped = max(flipped, frac)
                    moved = (p != x).float().mean().item()
                    if frac > MAX_FLIP_FRAC or diff.max().item() > 1:
                        raise AssertionError(
                            f"kernel vs plain {mode} N={N} D={D} S={S} step={step}: "
                            f"{frac:.2e} of states differ, max {diff.max().item()}")
            log(f"  N={N} D={D} S={S} step={step} h={h:.3g}: expected/poisson(u) "
                f"agree (moved {moved:.3f})")
        # Philox stream: seeded, and (over enough rows to measure it)
        # distributed as the plain version's draws
        logits, x, qt0, rate, _, h = fused_inputs(N, D, S, 500, 7, dev)
        a = fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 11)
        b = fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 11)
        c = fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 11 | (1 << 32))
        # another key word must change the draws wherever enough states move
        if not torch.equal(a, b) or (torch.equal(a, c) and int((a != x).sum()) >= 8):
            raise AssertionError("Philox stream not a function of the seed")
        if N * D < 10000:
            continue
        jk = jp = 0.0
        for r in range(8):
            jk += (fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, r)
                   - x).abs().float().mean().item()
            gen = torch.Generator(device=dev).manual_seed(r)
            jp += (fu.fused_tau_leap_update_plain(logits, x, x, qt0, rate, h, 1e-9,
                                                  generator=gen)
                   - x).abs().float().mean().item()
        if abs(jk - jp) / max(jp, 1e-9) > 0.15:
            raise AssertionError(f"mean |jump| kernel {jk / 8} vs plain {jp / 8}")
        log(f"  N={N} D={D} S={S} Philox: seeded, mean |jump| kernel "
            f"{jk / 8:.4f} vs plain {jp / 8:.4f}")
    log(f"  largest share of states that differ from the plain version: "
        f"{flipped:.3e} (allowed {MAX_FLIP_FRAC:.0e}), by at most {worst}")
    return float(worst), flipped


def phase_timing(dev) -> dict:
    from ctdd_tpu_torch.ops import fused_update as fu
    from ctdd_tpu_torch.ops import rate_kernels as rk

    out = {}
    for N in (256, 16):
        D, S = 784, 256
        logits, x, qt0, rate, _, h = fused_inputs(N, D, S, 500, 1, dev)
        iters = 20 if N == 256 else 200
        gen = torch.Generator(device=dev).manual_seed(0)
        t = timed(lambda: fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 3),
                  lambda: fu.fused_tau_leap_update_plain(
                      logits, x, x, qt0, rate, h, 1e-9, generator=gen), iters)
        # the "expected" mode has no draws and no Poisson series; how much
        # the series costs depends on the expected jumps per row, sum(rev * h)
        def expected():
            return fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 3,
                                            mode="expected")

        expected_ms = device_ms(expected, iters) or cuda_ms(expected, iters)
        xl = x.long()
        jumps_per_row = h * rk.reverse_rates_plain(
            logits, qt0.t()[xl] + 1e-9, qt0, rate.t()[xl], x).sum(-1).mean().item()
        # each input read once, the output written once; the ratio product
        # at the bf16 tensor-core rate
        nbytes = (logits.numel() * 4 + 2 * x.numel() * 4 + 2 * S * S * 4
                  + x.numel() * 4)
        flops = 2.0 * N * D * S * S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        out[N] = dict(**t, bound_ms=max(bytes_ms, ops_ms),
                      bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                      bytes=nbytes, flops=flops, expected_mode_ms=expected_ms,
                      expected_jumps_per_row=jumps_per_row)
        log(f"  N={N} D={D} S={S}: kernel {t['ms']:.4f} ms by {t['timed_by']} "
            f"({t['loop_ms']:.4f} ms per turn of a loop; mode \"expected\" "
            f"{expected_ms:.4f} ms; {jumps_per_row:.3f} expected jumps per row), "
            f"plain {t['plain_ms']:.4f} ms, "
            f"bound {out[N]['bound_ms'] * 1e3:.1f} us ({out[N]['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return out


# ---------------------------------------------------------------------------
# phases 8/9 inputs: real process tables, a timestep per sample or one shared
# ---------------------------------------------------------------------------


def rate_process(S, dev):
    """The process and (t_k, h_k) grid of the serving path that runs this S."""
    from ctdd_tpu_torch.ops import forward_process as fp
    from ctdd_tpu_torch.sampling.samplers import _time_grid

    if S == 3:  # tauUnet_maze
        return (fp.make_uniform_variant(3, 2.0, "log_sqr", device=dev),
                _time_grid(1.0, 0.001, 200))
    if S == 2:  # mlp_synthetic
        return fp.make_uniform(2, 2.0, device=dev), _time_grid(0.99999, 0.007, 100)
    return (fp.make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0, device=dev),
            _time_grid(1.0, 0.01, 1000))


def rate_inputs(N, D, S, fracs, seed, dev, per_sample):
    """(logits, qt0_cols, qt0, rate_cols, x, h) at the grid positions `fracs`
    (shares of the grid's length): sample n sits at fracs[n % len(fracs)]
    with its own (S, S) table, or the batch shares the table of fracs[0]."""
    from ctdd_tpu_torch.ops import indexing
    from ctdd_tpu_torch.sampling.samplers import _shared_mats

    proc, (ts, hs) = rate_process(S, dev)
    steps = [min(int(f * len(ts)), len(ts) - 1) for f in fracs]
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 2.0 * torch.randn((N, D, S), generator=g, device=dev)
    x = torch.randint(0, S, (N, D), generator=g, device=dev, dtype=torch.int32)
    if per_sample:
        t = torch.tensor([float(ts[steps[n % len(steps)]]) for n in range(N)],
                         dtype=torch.float32, device=dev)
        qt0, rate = proc.transition(t).contiguous(), proc.rate(t)
        qc, rc = indexing.cols(qt0, x) + 1e-9, indexing.cols(rate, x)
    else:
        qt0, rate = _shared_mats(proc, float(ts[steps[0]]))
        qt0 = qt0.contiguous()
        qc, rc = qt0.t()[x.long()] + 1e-9, rate.t()[x.long()]
    return logits, qc.contiguous(), qt0, rc.contiguous(), x, float(hs[steps[0]])


def phase_rate_kernels(dev) -> dict:
    """Reverse-rates and Euler-posterior kernels vs their plain versions.

    Tolerances. Both sides are float32 and sum S terms in another order. The
    reverse rates sum non-negative terms (q_{t|0} >= 0), so a row's error is
    bounded by S * 2^-24 ~ 1.5e-5 of its largest value and is ~1e-6 in
    practice: RATE_ROW_TOL of the row's largest |value|; the entry at x must
    be exactly 0. The posterior is fed the same rates on both sides; its
    probabilities agree to POST_PROB_TOL (two row sums), its log-values off
    the entry at x to POST_LOG_TOL (values reach 80, one ulp there is 8e-6).
    The entry at x is 1 - h * sum, which cancels where h * sum ~ 1, so it is
    held in probability only."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    worst = dict(rate_abs=0.0, rate_row_rel=0.0, post_prob=0.0, post_log=0.0)
    tiny = torch.finfo(torch.float32).tiny
    for N, D, S in [(16, 784, 256), (3, 77, 256), (16, 225, 3), (5, 32, 2), (3, 77, 8),
                    (2, 129, 256), (1, 5, 256), (2, 129, 12)]:
        iota = torch.arange(S, device=dev)
        for per_sample, fracs in ((True, (0.1, 0.5, 0.95)), (False, (0.1,)),
                                  (False, (0.5,)), (False, (0.95,))):
            logits, qc, qt0, rc, x, h = rate_inputs(
                N, D, S, fracs, N * D + int(100 * fracs[0]), dev, per_sample)
            k = rk.reverse_rates(logits, qc, qt0, rc, x)
            torch.cuda.synchronize()
            p = rk.reverse_rates_plain(logits, qc, qt0, rc, x)
            scale = p.abs().amax(-1, keepdim=True).clamp_min(tiny)
            row_rel = ((k - p).abs() / scale).max().item()
            at_x = k.gather(-1, x.long()[..., None])
            what = (f"N={N} D={D} S={S} {'per-sample' if per_sample else 'shared'} "
                    f"tables at {fracs}")
            if not math.isfinite(row_rel) or row_rel > RATE_ROW_TOL:
                raise AssertionError(f"reverse_rates {what}: {row_rel:.3e} of a row's max")
            if bool((at_x != 0).any()):
                raise AssertionError(f"reverse_rates {what}: entry at x not 0")
            worst["rate_abs"] = max(worst["rate_abs"], (k - p).abs().max().item())
            worst["rate_row_rel"] = max(worst["rate_row_rel"], row_rel)

            off = p.sum(-1)
            off_x = iota[None, None, :] != x[:, :, None]
            dead_shares = []
            # the sampler's own h, and one that drives half the rows to diag = 0
            for hh in (h, float(1.0 / off.median())):
                kp = rk.euler_posterior(k, x, hh)
                torch.cuda.synchronize()
                pp = rk.euler_posterior_plain(k, x, hh)
                prob = (kp.exp() - pp.exp()).abs().max().item()
                logd = ((kp - pp).abs() * off_x).max().item()
                if not (math.isfinite(prob) and math.isfinite(logd)) or \
                        prob > POST_PROB_TOL or logd > POST_LOG_TOL:
                    raise AssertionError(
                        f"euler_posterior {what} h={hh:.3g}: probabilities differ "
                        f"by {prob:.3e}, log-values off x by {logd:.3e}")
                worst["post_prob"] = max(worst["post_prob"], prob)
                worst["post_log"] = max(worst["post_log"], logd)
                dead_shares.append((hh * off >= 1).float().mean().item())
            if not dead_shares[1] > 0:
                raise AssertionError(f"euler_posterior {what}: no row with diag = 0")
            log(f"  {what}: rates within {row_rel:.2e} of the row max, 0 at x; "
                f"posterior agrees at h={h:.3g} and with diag=0 in "
                f"{dead_shares[1]:.2f} of the rows")
    return worst


def phase_rate_timing(dev) -> dict:
    """Both kernels at the serving shapes (shared table, mid-grid)."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    out = {"reverse_rates": {}, "euler_posterior": {}}
    D, S = 784, 256
    for N in (256, 16):
        logits, qc, qt0, rc, x, h = rate_inputs(N, D, S, (0.5,), 1, dev, False)
        iters = 20 if N == 256 else 200
        rev = rk.reverse_rates(logits, qc, qt0, rc, x)
        nds = logits.numel()
        cases = {
            # three (N, D, S) inputs, x, the table; one output. The product
            # keeps float32 accuracy on the tensor cores as three TF32
            # products (big*big + big*small + small*big)
            "reverse_rates": (
                lambda: rk.reverse_rates(logits, qc, qt0, rc, x),
                lambda: rk.reverse_rates_plain(logits, qc, qt0, rc, x),
                4 * (3 * nds + x.numel() + S * S + nds),
                3 * 2.0 * N * D * S * S, TF32_FLOP_PER_S, "TF32"),
            # one input, x, one output; ~8 operations per entry
            "euler_posterior": (
                lambda: rk.euler_posterior(rev, x, h),
                lambda: rk.euler_posterior_plain(rev, x, h),
                4 * (nds + x.numel() + nds), 8.0 * nds, F32_FLOP_PER_S, "f32"),
        }
        for name, (kernel, plain, nbytes, flops, rate, rate_name) in cases.items():
            t = timed(kernel, plain, iters)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / rate * 1e3
            out[name][N] = dict(
                **t, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops)
            log(f"  {name} N={N} D={D} S={S}: kernel {t['ms']:.4f} ms by "
                f"{t['timed_by']} ({t['loop_ms']:.4f} ms per turn of a loop), plain "
                f"{t['plain_ms']:.4f} ms, bound {out[name][N]['bound_ms'] * 1e3:.1f} us "
                f"({out[name][N]['bound_by']}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.2f} GFLOP at the {rate_name} rate)")
    return out


def full_cfg(fused: bool, sampler: str = "TauL", preset: str = "tauUnet_mnist"):
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset(preset)
    cfg.sampler.use_fused_update = fused
    if preset == "tauUnet_mnist":
        cfg.sampler.name = sampler
    return cfg


def phase_unet(dev):
    """Full-width logits and tau-leap steps: card vs the port's CPU."""
    # full f32 for the comparison only; serving (phase 7) keeps PyTorch's
    # defaults, TF32 convolutions included
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _unet_vs_cpu(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _unet_vs_cpu(dev):
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    cfg = full_cfg(fused=True)
    torch.manual_seed(0)
    cpu = create_model(cfg, device="cpu")
    cpu.net.eval()
    gpu = create_model(cfg, device=dev)
    gpu.net.load_state_dict(cpu.net.state_dict())
    gpu.net.eval()
    n_params = sum(p.numel() for p in gpu.net.parameters())
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.integers(0, 256, (2, 784)).astype(np.int32))
    t = torch.tensor([0.3, 0.9])
    with torch.inference_mode():
        ref = cpu.apply(cpu.net, x, t)
        got = gpu.apply(gpu.net, x.to(dev), t.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32 on both sides (TF32 off); cuDNN and the CPU sum ~20 conv layers in
    # other orders: allow 1e-4 of the logits' range
    log(f"  UNet {n_params / 1e6:.2f} M params, logits {tuple(got.shape)}: "
        f"max |gpu - cpu| {err:.3e} (max |logit| {scale:.3f})")
    if not math.isfinite(err) or err > 1e-4 * max(scale, 1.0):
        raise AssertionError(f"UNet logits on the card differ by {err}")

    # three fused tau-leap steps at full width with injected uniforms
    sampler = get_sampler(cfg)
    xs = torch.from_numpy(g.integers(100, 156, (2, 784)).astype(np.int32))
    xc, xd = xs.clone(), xs.to(dev)
    flips = 0
    with torch.inference_mode():
        for t_, h_ in ((0.6, 1e-3), (0.3, 1e-3), (0.05, 1e-3)):
            u = torch.from_numpy(g.random((2, 784, 256)).astype(np.float32))
            xc = sampler.step(cpu, cpu.net, xc, t_, h_, u=u)
            xd = sampler.step(gpu, gpu.net, xd, t_, h_, u=u.to(dev))
            flips += int((xd.cpu() != xc).sum())
            xd = xc.to(dev)  # continue both chains from the same state
    moved = (xc != xs).float().mean().item()
    log(f"  3 fused TauL steps at full width, card vs CPU: {flips} of "
        f"{3 * xs.numel()} states differ (moved {moved:.3f})")
    # the logits differ by ~1e-5 between cuDNN and the CPU (above); carried
    # through the bf16 rounding of p / qd they flip a few CDF comparisons
    if flips > STEP_FLIP_FRAC * 3 * xs.numel():
        raise AssertionError(f"{flips} states differ between card and CPU")

    # three LBJF steps at full width with injected Gumbel noise: reverse-rates
    # and Euler-posterior kernels on the card, their plain versions on the CPU
    from ctdd_tpu_torch.ops import rate_kernels as rk

    lbjf = get_sampler(full_cfg(fused=False, sampler="LBJF"))
    before = rk.reverse_rates.launches, rk.euler_posterior.launches
    xc, xd = xs.clone(), xs.to(dev)
    flips = 0
    with torch.inference_mode():
        for t_, h_ in ((0.6, 1e-3), (0.3, 1e-3), (0.05, 1e-3)):
            gn = torch.from_numpy(g.gumbel(size=(2, 784, 256)).astype(np.float32))
            xc = lbjf.step(cpu, cpu.net, xc, t_, h_, g=gn)
            xd = lbjf.step(gpu, gpu.net, xd, t_, h_, g=gn.to(dev))
            flips += int((xd.cpu() != xc).sum())
            xd = xc.to(dev)
    if (rk.reverse_rates.launches, rk.euler_posterior.launches) != (
            before[0] + 3, before[1] + 3):
        raise AssertionError("the LBJF steps on the card did not launch both kernels")
    moved = (xc != xs).float().mean().item()
    log(f"  3 LBJF steps at full width, card vs CPU: {flips} of "
        f"{3 * xs.numel()} states differ (moved {moved:.3f})")
    # the same allowance: logits differing by ~1e-5 move argmax(logp + g)
    # only where two entries tie to that precision
    if flips > STEP_FLIP_FRAC * 3 * xs.numel():
        raise AssertionError(f"{flips} LBJF states differ between card and CPU")
    return n_params


def phase_step_breakdown(dev, cfg, kernel_names, steps: int = 20) -> dict:
    """Where one serving step's time goes at batch 16: the network, the
    hand-written kernels (`kernel_names`: label -> part of the device
    kernel's name), the rest, and the share of the step the card is idle."""
    from torch.profiler import ProfilerActivity, profile

    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    torch.manual_seed(2)
    model = create_model(cfg, device=dev)
    model.net.eval()
    sampler = get_sampler(cfg)
    x = torch.randint(0, 256, (16, 784), device=dev, dtype=torch.int32)
    t = torch.full((16,), 0.5, device=dev)
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: model.apply(model.net, x, t), 20)

        def run():
            xs = x
            for i in range(steps):
                xs = sampler.step(model, model.net, xs, 0.5, 1e-3, seed=i)
            return xs

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    own = {label: sum(e.self_device_time_total for e in kernels
                      if part in e.key) / 1e3 / steps
           for label, part in kernel_names.items()}
    if busy_ms and not all(own.values()):
        raise AssertionError(f"a kernel of the step is missing from the trace: {own}")
    out = dict(sampler=cfg.sampler.name, step_ms=step_ms, unet_ms=unet_ms,
               device_busy_ms=busy_ms, **own,
               idle_share=1.0 - busy_ms / step_ms if busy_ms else None,
               device_kernels_per_step=sum(e.count for e in kernels) / steps)
    log(f"  {cfg.sampler.name} step at batch 16: {step_ms:.3f} ms wall; UNet "
        f"forward {unet_ms:.3f} ms (events); device busy {busy_ms:.3f} ms ("
        + ", ".join(f"{k} {v:.3f} ms" for k, v in own.items()) + ") over "
        f"{out['device_kernels_per_step']:.0f} kernels; idle share "
        + (f"{out['idle_share']:.3f}" if busy_ms else "not measured"))
    return out


def kernel_wrappers() -> dict:
    from ctdd_tpu_torch.ops import fused_update as fu
    from ctdd_tpu_torch.ops import rate_kernels as rk

    return {"fused_tau_leap_update": fu.fused_tau_leap_update,
            "reverse_rates": rk.reverse_rates,
            "euler_posterior": rk.euler_posterior}


def serve_request(dev, tmpdir, label, cfg, n, expected, seed):
    """Seeded checkpoint -> SamplerService -> one /generate?n= request over
    HTTP. The launch counters are set to 0 just before the request and read
    just after; `expected` gives every kernel's exact count per batch."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.serving import SamplerService, run_http_server
    from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint

    torch.manual_seed(seed)
    model = create_model(cfg, device=dev)
    sd = model.net.state_dict()
    n_params = sum(v.numel() for v in sd.values())
    path = save_checkpoint(f"{tmpdir}/{label}.pt", sd, sd, step=0, config=cfg)
    svc = SamplerService(cfg, path, batch=16, device=dev)
    t0 = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    log(f"  {label}: {n_params / 1e6:.2f} M params, {cfg.sampler.name}; warm-up "
        f"batch of 16: {time.perf_counter() - t0:.2f} s")

    wrappers = kernel_wrappers()
    server = run_http_server(svc, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"] or health["batch"] != 16:
            raise AssertionError(f"healthz: {health}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n={n}",
                                    timeout=900) as r:
            payload = json.loads(r.read())
        elapsed = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    D, S = cfg.model.concat_dim, cfg.data.S
    samples = np.asarray(payload["samples"])
    if samples.shape != (n, D) or samples.min() < 0 or samples.max() > S - 1:
        raise AssertionError(f"{label}: bad samples: shape {samples.shape}, "
                             f"range [{samples.min()}, {samples.max()}]")
    batches = -(-n // 16)
    want = {name: batches * expected.get(name, 0) for name in wrappers}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    made = 16 * batches
    log(f"  {label} /generate?n={n}: {elapsed:.2f} s for {batches} batch(es) of 16 "
        f"({n / elapsed:.3f} samples/s served, {made / elapsed:.3f} samples/s "
        f"generated on {torch.cuda.get_device_name(dev)}), launches "
        f"{ {k: v for k, v in launches.items() if v} }, values in "
        f"[{samples.min()}, {samples.max()}]")
    return launches, elapsed


def phase_serving(dev, tmpdir):
    """The flagship with the fused TauL update: two batches of 16."""
    cfg = full_cfg(fused=True)
    return serve_request(dev, tmpdir, "tauUnet_mnist TauL fused", cfg, 20,
                         {"fused_tau_leap_update": cfg.sampler.num_steps}, seed=1)


def phase_serving_slice2(dev, tmpdir):
    """LBJF with a live corrector at full width, MidPointTauL (fused) and
    the maze preset; every expected count comes from the sampler's own time
    grid."""
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    out = {}
    cfg = full_cfg(fused=False, sampler="LBJF")
    cfg.sampler.num_corrector_steps = 2
    cfg.sampler.corrector_entry_time = 0.05
    ts, _ = get_sampler(cfg).time_grid()
    live = int((ts <= np.float32(cfg.sampler.corrector_entry_time)).sum())
    per_batch = len(ts) + cfg.sampler.num_corrector_steps * live
    log(f"  LBJF grid: {len(ts)} steps, {live} at or below the "
        f"corrector's entry time -> {per_batch} launches of each rate kernel")
    out["tauUnet_mnist LBJF corrector"] = serve_request(
        dev, tmpdir, "tauUnet_mnist LBJF corrector", cfg, 16,
        {"reverse_rates": per_batch, "euler_posterior": per_batch}, seed=3)

    cfg = full_cfg(fused=True, preset="tauUnet_mnist_ll")
    n_steps = len(get_sampler(cfg).time_grid()[0])
    out["tauUnet_mnist_ll"] = serve_request(
        dev, tmpdir, "tauUnet_mnist_ll", cfg, 16,
        {"fused_tau_leap_update": 2 * n_steps}, seed=4)

    cfg = full_cfg(fused=False, preset="tauUnet_maze")
    steps = len(get_sampler(cfg).time_grid()[0])
    out["tauUnet_maze"] = serve_request(
        dev, tmpdir, "tauUnet_maze", cfg, 16,
        {"reverse_rates": steps, "euler_posterior": steps}, seed=5)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    from ctdd_tpu_torch.ops import _build

    log("[1] device")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[2] build")
    t0 = time.perf_counter()
    reports = _build.build(["fused_tau_leap", "reverse_rates", "euler_posterior"])
    seconds = time.perf_counter() - t0
    for name, rep in reports.items():
        log(f"  {name}: {ptxas_summary(rep)}")
    log(f"  built in {seconds:.2f} s")
    for name in reports:
        ops = _build.tensor_core_ops(name)
        log(f"  {name}: tensor-core MMA ops in the binary: "
            + ("not checked (no cuobjdump)" if ops is None else
               ", ".join(f"{n} x {op}" for op, n in sorted(ops.items())) or "none"))

    log("[3] fused tau-leap kernel vs plain version")
    max_err, flip_frac = phase_kernels(dev)

    log("[4] timing")
    timing = phase_timing(dev)

    log("[8] reverse-rates and Euler-posterior kernels vs plain versions")
    rate_err = phase_rate_kernels(dev)

    log("[9] timing of the rate kernels")
    rate_timing = phase_rate_timing(dev)

    if "--kernels-only" in sys.argv[1:]:
        log(f"  kernels only: {time.perf_counter() - t_start:.1f} s")
        return 0

    log("[5] UNet, tau-leap and LBJF steps, card vs CPU")
    phase_unet(dev)

    log("[6] TauL step breakdown")
    breakdown = phase_step_breakdown(
        dev, full_cfg(fused=True), {"fused_kernel_ms": "fused_tau_leap"})

    log("[10] LBJF step breakdown")
    lbjf_breakdown = phase_step_breakdown(
        dev, full_cfg(fused=False, sampler="LBJF"),
        {"reverse_rates_kernel_ms": "reverse_rates_kernel",
         "euler_posterior_kernel_ms": "euler_posterior_kernel"})

    with tempfile.TemporaryDirectory() as tmpdir:
        log("[7] serving: the flagship, fused TauL")
        launches, elapsed = phase_serving(dev, tmpdir)
        log("[11] serving: LBJF with a corrector, MidPointTauL, maze")
        served = phase_serving_slice2(dev, tmpdir)

    by_request = {"tauUnet_mnist TauL fused n=20": launches,
                  **{label: counts for label, (counts, _) in served.items()}}

    # device time of one launch inside a batch-16 step (torch.profiler),
    # where the kernel's input is what the network has just written
    in_step = {"fused_tau_leap_update": breakdown["fused_kernel_ms"],
               "reverse_rates": lbjf_breakdown["reverse_rates_kernel_ms"],
               "euler_posterior": lbjf_breakdown["euler_posterior_kernel_ms"]}

    def entry(name, source, replaces, err, big, small, **extra):
        counts = {label: c[name] for label, c in by_request.items() if c[name]}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts.values()), "launches_by_request": counts,
            "max_abs_err": err, "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": None, "shape": [256, 784, 256],
            "timed_by": big["timed_by"], "loop_ms": big["loop_ms"],
            "serving_shape": [16, 784, 256], "serving_ms": small["ms"],
            "serving_loop_ms": small["loop_ms"],
            "serving_plain_ms": small["plain_ms"],
            "serving_bound_ms": small["bound_ms"],
            "serving_bound_by": small["bound_by"],
            "serving_step_device_ms": in_step[name], **extra,
        }

    rr, ep = rate_timing["reverse_rates"], rate_timing["euler_posterior"]
    record = {"kernels": [
        entry("fused_tau_leap_update", "ctdd_tpu_torch/csrc/fused_tau_leap.cu",
              "ctdd_tpu/ops/fused_update.py:170", max_err, timing[256], timing[16],
              max_flip_frac=flip_frac,
              expected_mode_ms=timing[256]["expected_mode_ms"],
              expected_jumps_per_row=timing[256]["expected_jumps_per_row"]),
        entry("reverse_rates", "ctdd_tpu_torch/csrc/reverse_rates.cu",
              "ctdd_tpu/ops/pallas_kernels.py:81", rate_err["rate_abs"],
              rr[256], rr[16], max_row_rel_err=rate_err["rate_row_rel"]),
        entry("euler_posterior", "ctdd_tpu_torch/csrc/euler_posterior.cu",
              "ctdd_tpu/ops/pallas_kernels.py:137", rate_err["post_prob"],
              ep[256], ep[16], max_log_err=rate_err["post_log"]),
    ]}
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"no served request launched {k['name']}")
    log("serving: " + json.dumps({
        "samples_per_s": 32 / elapsed, "batch": 16, "steps": 1000,
        **breakdown}))
    log("serving_lbjf: " + json.dumps({
        "samples_per_s": 16 / served["tauUnet_mnist LBJF corrector"][1],
        "batch": 16, "steps": 1000, "corrector_steps": 2, **lbjf_breakdown}))
    log("serving_other: " + json.dumps({
        label: {"samples_per_s": 16 / secs, "seconds": secs}
        for label, (_, secs) in served.items()}))
    for k in record["kernels"]:
        log(f"kernels {k['name']}: launches {k['launches']}, max diff "
            f"{k['max_abs_err']:.3g}, {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}) at N=256; "
            f"{k['serving_ms']:.4f} ms ({k['serving_loop_ms']:.4f} ms per turn of a loop), "
            f"plain {k['serving_plain_ms']:.4f} ms, bound "
            f"{k['serving_bound_ms'] * 1e3:.1f} us ({k['serving_bound_by']}) at N=16, "
            f"{k['serving_step_device_ms']:.4f} ms of device time inside a step; "
            f"times by {k['timed_by']}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
