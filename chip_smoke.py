"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--kernels-only]

`--kernels-only` stops after the phases that build, check and time the
kernels (1-4, 8, 9, 20) and prints no result lines but kernel 4's: a quick
check of a kernel change.

Phases (any fault exits non-zero; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA kernel of the port from csrc/, in parallel;
              count the tensor-core MMA ops in each binary
  3. kernels  fused tau-leap kernel vs its plain PyTorch version on the card,
              S in {256, 21, 9, 8, 3, 2}, row counts below and across its tile
  4. timing   kernel, plain version and bound at N=256 and N=16 (D=784,
              S=256): device time from a trace, and a back-to-back loop
  5. unet     full-width logits on the card vs the port's CPU logits, and
              tau-leap and LBJF steps on the card vs the CPU with the same
              injected noise
  6. steps    where a batch-16 TauL step's time goes (torch.profiler)
  7. serving  a seeded full-width checkpoint served over HTTP: one 1000-step
              batch of the flagship sampler with the fused update
  8. rates    reverse-rates and Euler-posterior kernels vs their plain
              versions, per-sample and shared tables, real process tables
              (S up to 256; sudoku's S=9, hollow_protein's S=21,
              pianoroll_cond's (64, 224, 129) and the EBM's (256, 32, 2) too);
              the posterior's draw mode (the LBJF update in one launch) vs
              the plain draw on injected and on keyed noise (near-ties
              apart), keyed repeatability, and its histograms at S = 2, 9,
              129, 256 against exp(logp)
  9. timing   both kernels, plain versions and bounds at N=256 and N=16
              (and at sudoku's sampling shape N=256, D=81, S=9,
              pianoroll_cond's (64, 224, 129) and the EBM's (256, 32, 2));
              the draw mode keyed and injected beside its bound and the
              chain it replaces (log-probs, noise, add, argmax, cast)
              (phases 8, 9 and 20 run straight after 4)
 10. steps    where a batch-16 LBJF step's time goes, and its kernels per
              step
 11. serving  three more seeded checkpoints over HTTP (no warm-up batch),
              each with its exact launch counts: the flagship with LBJF and
              a live corrector (500 steps), tauUnet_mnist_ll (MidPointTauL/500,
              fused) and tauUnet_maze (LBJF/200)
 12. training the flagship at full width on a seeded MNIST-shaped stand-in:
              (a) one B=4 step, card vs CPU, held to the CPU's own float32
              error against a float64 step, and a control with TF32 on
              that must fail; the same step twice on the card, which
              gradient leaves differ bit for bit, with the defaults and with
              cudnn.deterministic (measurement only); (b) train() for 100
              B=64 steps
              with one in-loop grid (1000 fused launches), a falling loss,
              steps/s, peak memory and a step breakdown, and 50 steps of
              tauUnet_mnist_ll; (c) a fresh train() from (b)'s checkpoint
              at step 50, 50 more steps, against (b)'s 100, and a control
              resumed with Adam's moments zeroed that must fail; (d) the
              trained checkpoint served over
              HTTP (1000 launches)
 13. scoring  through the CLIs a user runs (`python -m ctdd_tpu_torch.*`):
              (a) InceptionV3 from a seeded random npz, card vs CPU, and its
              time per batch of 128 at 299x299; (b) mlp_synthetic trained 300
              steps, both rate kernels vs plain at N=4096, then its MMD at the
              reference protocol (25 x 4096, LBJF/100; 2500 launches of each)
              between data vs data and uniform bits; (c) FIDs of [12]'s
              checkpoint (256 fused TauL/250 samples against 2048 real
              images, 250 launches per eval) with trained, lenet and
              Inception features; (d) the bench at
              50 sampler steps (its bf16 train step included)
 14. hollow   the SDDM hollow family at full width: (a) holvisual_mnist
              (D=784, S=256, 2 x 6 layers, attention readout) logits card vs
              CPU, and one B=4 CatRM step held as (12a); (b) train() 50
              B=64 steps, peak memory and the step's device split; (c) its
              checkpoint served over HTTP (LBJF/1000: exactly 1000
              Euler-posterior launches, none of the reverse rates); (d)
              hollow_synthetic (ScoreElbo) and bert_synthetic (CTElbo)
              trained 300 steps by the train CLI and scored by the eval
              CLI's MMD (1 x 4096) with exact launch counts; (e) the
              flagship's bf16 logits vs float32 on the card, and its bf16
              train step
 15. maze     the maze, sudoku and protein presets at full width: (a) the
              port's C++ generators built from csrc/datagen.cpp, the
              presets' Maze3S (6400) and SudokuDataset (12800) pools timed
              and held solved, regenerate(epoch) seeded; (b) sudoku and
              protein_maze logits card vs CPU and one B=4 step each, held
              as (12a); (c) sudoku trained 401 steps by the train CLI
              across its async pool swap at step 400 (the pool held equal
              to regenerate(4)), its sudoku_acc by the eval CLI (LBJF/1000:
              exactly 1000 launches of each rate kernel); (d) tauUnet_maze
              the same across its synchronous swap at 100, maze_acc with
              LBJF/200; (e) hollow_maze trained 25 steps and served
              (LBJF/750 on the ratio path), hollow_protein (S=21) trained
              25 steps and sampled (LBJF/100), four more presets 5 steps
              each
 16. slice 8  the rest of the samplers, the EBM and the prefix-conditional
              path at the presets' widths: (a) pianoroll_cond
              (SequenceTransformer, L=256, S=129) trained 200 steps by the
              train CLI, its bare B=64 step timed, cond_mmd by the eval CLI
              (n=64, ConditionalTauLeaping/1000: exactly 1000 reverse-rates
              launches) and one ConditionalLBJF batch (1000 of each kernel);
              (b) ebm_synthetic (binary transformer EBM, D=32) trained 300
              steps by the train CLI (its loss falls), MMD at 3 x 256 by the
              eval CLI: with CRMebmLBJF/750 (2250 posterior launches at S=2)
              between data vs data and the mean of uniform random bits over
              20 eval seeds, with ExactSampling/100 (no kernel) between data
              vs data and 3 std above that mean; (c) PCTauL and TAULStepSize
              (100 steps) on the flagship with a live corrector, exact
              launch counts and finite traces; (d) card vs
              CPU: the sequence transformer's and the EBM's outputs, one
              CondCTElbo, CondNLL (key head) and BinEBMAux step, K steps of
              PCTauL, ExactSampling and ConditionalTauLeaping with injected
              noise; (e) two train() runs bit-identical for the flagship,
              sudoku, hollow_maze and pianoroll_cond (train() runs PyTorch's
              deterministic algorithms)
 17. slice 9  the DiT, U-ViT and CIFAR10 image presets at full width, on
              seeded MNIST- and CIFAR10-layout stand-ins: (a) card vs CPU
              logits at B=2 (DiT with labels, both U-ViTs, the CIFAR10 UNet,
              the tau-UNet at tauUnet_cifar10's width) and DiT's guided
              logits at cfg_scale 0, 1, 1.5, each with a TF32 control; (b)
              tauUnet_cifar10 through train() at B=64 (two 20-step runs
              bit-identical, steps/s, peak memory, the step's device split),
              served over HTTP (TauL/500: exactly 500 reverse-rates
              launches at (16, 3072, 256)), and 3 fused steps against plain
              at D=3072; (c) dit_mnist: two 20-step runs bit-identical, its
              label table bit-equal to its start under NLL (params and EMA)
              and moved under NLLOriginal, one guided batch of 16 (labels
              arange % 10, cfg_scale 1.5, TauL/100: 100 reverse-rates
              launches, two forwards a step) and one /generate?label=...
              request; (d) uvit_mnist, uvit_cifar10 and dit_mnist's B=64
              steps; (e) bin_mnist_hollow trained 30 steps, LBJF/500 at
              batch 16 (exactly 500 posterior launches at (16, 784, 2));
              (f) the kernels against plain and timed at these shapes; (g)
              the eval CLI's lenet FID of (b)'s checkpoint (32 samples,
              TauL/500)
 18. d3pm     the D3PM baseline at full width and on-device augmentation:
              (a) each preset's tables on the card bit-equal to the host's;
              at B=2, t = (T-1, 0), the posterior logits (both branches),
              p_logits and the kl, cross-entropy and hybrid losses with
              injected noise, card vs CPU, with a TF32 control; (b)
              mnist_d3pm twice through train() (20 steps at B=64,
              bit-identical), one run with its in-loop TauL grid (100 steps,
              on the ratio rate path as in JAX: no kernel); synthetic_d3pm 300 steps
              (its loss falls), protein_maze_d3pm 20 steps through its fresh
              pool, both printing the no-grid line; (c) the eval CLI,
              ancestral: synthetic_d3pm's MMD (1 x 4096, T=500) between data
              vs data and uniform bits, protein_maze_d3pm's maze_acc (64,
              T=1000), one mnist_d3pm batch of 16 (T=1000); (d) rotation and
              flip card vs CPU, and tauUnet_cifar10 and dit_mnist trained 10
              steps with data.use_augm; (e) an mnist_d3pm ancestral step's
              breakdown at batch 16
 19. parallel data parallelism, the loggers and the loop's figures at the
              flagship's full width: (a) on a one-rank NCCL group, the DP
              steps (host batches and the dataset on the device) 5 steps at
              B=64 bit-identical to the single-device steps, and a control
              (one gradient leaf scaled before the reduction) that must
              break that; (b) two processes sharing the card over gloo run
              train()'s DP branch 10 steps at global B=64: parameters
              bit-identical after every step, the last loss the mean of the
              shard losses recomputed here (1e-6), rank 0's checkpoints
              alone, steps/s; (c) the DP sampler at one rank, N=16, fused
              TauL/100: exactly 100 launches, samples bit-identical to
              sampler.sample; (d) denoisingImages (full width) and
              ConditionalDenoisingNoteSeq (pianoroll_cond's L=256, S=129) on
              the card with the numpy writer and no matplotlib, each PNG read
              back equal to its panels; train() 20 steps with its in-loop
              grid (TauL/100: 100 launches), samples_20.png beside the .npy,
              the loss-curve line; (e) the dry run of 2 processes on the CPU,
              and mnist_d3pm's host table build alone
 20. dense    the 3xTF32 GEMM at the SDAR cell's shapes (forward, input
              gradient and weight gradient of q, k and v as one product, o
              and the head, and a shape off every tile): the first and last
              256 rows vs float64, at most 4x cuBLAS float32's error and
              more than 100x below single TF32's; device time beside its
              bound (FLOPs at 494.7/3 TFLOP/s), cuBLAS float32 and the
              plain version
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
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


def within_bound(t: dict) -> dict:
    """`timed`'s record with its bound: a traced time below the bound means
    the trace lost launches (seen once at (256, 3072, 256)), so the loop's
    times stand in for it."""
    if t["ms"] < t["bound_ms"]:
        t.update(ms=t["loop_ms"], plain_ms=t["plain_loop_ms"],
                 timed_by="events around a loop (the trace read below the bound)")
    return t


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
             (1, 5, 256), (1, 5, 8), (16, 225, 3), (1, 5, 3), (5, 32, 2),
             (16, 81, 9), (3, 81, 9), (16, 48, 21), (3, 48, 21)]
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


def fused_timing(N: int, D: int, S: int, dev) -> dict:
    """The fused kernel, its plain version and its bound at (N, D, S),
    mid-grid."""
    from ctdd_tpu_torch.ops import fused_update as fu
    from ctdd_tpu_torch.ops import rate_kernels as rk

    logits, x, qt0, rate, _, h = fused_inputs(N, D, S, 500, 1, dev)
    iters = 20 if N * D > 50000 else 200
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
    out = within_bound(dict(**t, bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            bytes=nbytes, flops=flops, expected_mode_ms=expected_ms,
                            expected_jumps_per_row=jumps_per_row, shape=[N, D, S]))
    log(f"  N={N} D={D} S={S}: kernel {out['ms']:.4f} ms by {out['timed_by']} "
        f"({t['loop_ms']:.4f} ms per turn of a loop; mode \"expected\" "
        f"{expected_ms:.4f} ms; {jumps_per_row:.3f} expected jumps per row), "
        f"plain {out['plain_ms']:.4f} ms, "
        f"bound {out['bound_ms'] * 1e3:.1f} us ({out['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return out


def phase_timing(dev) -> dict:
    return {N: fused_timing(N, 784, 256, dev) for N in (256, 16)}


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
    if S == 9:  # sudoku
        return (fp.make_uniform_variant(9, 0.35, "sqrt_cos", device=dev),
                _time_grid(0.99, 0.001, 1000))
    if S == 21:  # hollow_protein
        return fp.make_uniform(21, 0.33, device=dev), _time_grid(0.99999, 0.01, 100)
    if S == 2:  # mlp_synthetic
        return fp.make_uniform(2, 2.0, device=dev), _time_grid(0.99999, 0.007, 100)
    if S == 129:  # pianoroll_cond
        return fp.make_uniform(129, 0.03, device=dev), _time_grid(1.0, 0.01, 1000)
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
    worst = dict(rate_abs=0.0, rate_row_rel=0.0, post_prob=0.0, post_log=0.0)
    for N, D, S in [(16, 784, 256), (3, 77, 256), (16, 225, 3), (5, 32, 2), (3, 77, 8),
                    (2, 129, 256), (1, 5, 256), (2, 129, 12), (16, 81, 9), (3, 81, 9),
                    (16, 48, 21), (3, 48, 21), (64, 224, 129), (3, 224, 129),
                    (256, 32, 2)]:
        for per_sample, fracs in ((True, (0.1, 0.5, 0.95)), (False, (0.1,)),
                                  (False, (0.5,)), (False, (0.95,))):
            logits, qc, qt0, rc, x, h = rate_inputs(
                N, D, S, fracs, N * D + int(100 * fracs[0]), dev, per_sample)
            hold_rate_kernels(f"N={N} D={D} S={S} {'per-sample' if per_sample else 'shared'} "
                              f"tables at {fracs}", logits, qc, qt0, rc, x, h, worst)
    log(f"  draw mode, injected and keyed noise: {worst['draw_differ']} of "
        f"{worst['draw_rows']} rows differ from the plain draw, all among its "
        f"{worst['draw_near_ties']} near-ties (top two of logp + g within "
        f"{2 * POST_LOG_TOL:.0e})")
    worst["draw_statistics"] = hold_draw_statistics(dev)
    return worst


def hold_rate_kernels(what, logits, qc, qt0, rc, x, h, worst):
    """Both rate kernels on one input vs their plain versions (tolerances in
    `phase_rate_kernels`); the posterior at `h` and at an h that drives half
    the rows to diag = 0. Raises on a miss; `worst` keeps the largest
    differences."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    tiny = torch.finfo(torch.float32).tiny
    k = rk.reverse_rates(logits, qc, qt0, rc, x)
    torch.cuda.synchronize()
    p = rk.reverse_rates_plain(logits, qc, qt0, rc, x)
    scale = p.abs().amax(-1, keepdim=True).clamp_min(tiny)
    row_rel = ((k - p).abs() / scale).max().item()
    at_x = k.gather(-1, x.long()[..., None])
    if not math.isfinite(row_rel) or row_rel > RATE_ROW_TOL:
        raise AssertionError(f"reverse_rates {what}: {row_rel:.3e} of a row's max")
    if bool((at_x != 0).any()):
        raise AssertionError(f"reverse_rates {what}: entry at x not 0")
    worst["rate_abs"] = max(worst["rate_abs"], (k - p).abs().max().item())
    worst["rate_row_rel"] = max(worst["rate_row_rel"], row_rel)

    hold_posterior(what, k, x, h, worst,
                   f"rates within {row_rel:.2e} of the row max, 0 at x; ")


def hold_posterior(what, rev, x, h, worst, prefix=""):
    """The Euler-posterior kernel on the rates `rev` vs its plain version
    (tolerances in `phase_rate_kernels`), at `h` and at an h that drives
    half the rows to diag = 0, in both modes (`hold_draw`). Raises on a
    miss; `worst` keeps the largest differences and the draw's counts."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    off = rev.sum(-1)
    off_x = torch.arange(rev.shape[-1], device=rev.device)[None, None, :] != x[:, :, None]
    dead_shares = []
    draws = []
    # the sampler's own h, and one that drives half the rows to diag = 0
    for hh in (h, float(1.0 / off.median())):
        kp = rk.euler_posterior(rev, x, hh)
        torch.cuda.synchronize()
        pp = rk.euler_posterior_plain(rev, x, hh)
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
        draws.append(hold_draw(f"{what} h={hh:.3g}", rev, x, hh, pp, worst))
    if not dead_shares[1] > 0:
        raise AssertionError(f"euler_posterior {what}: no row with diag = 0")
    log(f"  {what}: {prefix}posterior agrees at h={h:.3g} and with diag=0 in "
        f"{dead_shares[1]:.2f} of the rows; draw mode: " + "; ".join(draws))


def hold_draw(what, rev, x, h, logp_plain, worst) -> str:
    """The posterior kernel's draw mode on one input, injected and keyed.
    Injected noise (`gumbel_noise`): equal to `euler_posterior_draw_plain`
    on every row but those where the plain version's top two values of
    logp + g lie within 2 * POST_LOG_TOL (the log-probs may differ by
    POST_LOG_TOL each). Keyed: held the same way against the plain draw on
    `philox_gumbel`, the same Philox stream made in PyTorch (its noise
    within ~6e-6 of the kernel's, whose outer log is `__logf`); one key
    gives the same states twice, and another seed or substep other states
    wherever enough states move. Raises on a miss; adds the rows, near-ties and mismatches
    to `worst`."""
    from ctdd_tpu_torch.ops import rate_kernels as rk
    from ctdd_tpu_torch.utils.math import gumbel_noise

    gen = torch.Generator(device=rev.device).manual_seed(rev.numel() % 9973)
    key = (11 | (3 << 32), 0)
    counts = []
    for kind, g, got in (
            ("injected", gumbel_noise(gen, rev.shape, rev.device), None),
            ("keyed", rk.philox_gumbel(*key, rev.shape, rev.device),
             rk.euler_posterior_draw(rev, x, h, seed=key[0], substep=key[1]))):
        if got is None:
            got = rk.euler_posterior_draw(rev, x, h, g=g)
        torch.cuda.synchronize()
        want = rk.euler_posterior_draw_plain(rev, x, h, g)
        top2 = (logp_plain + g).topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= 2 * POST_LOG_TOL
        differ = got != want
        far = int((differ & ~near).sum())
        if far or got.dtype != torch.int32 or got.shape != x.shape:
            raise AssertionError(f"euler_posterior draw {what}, {kind}: {far} rows differ "
                                 f"from the plain draw away from a near-tie ({got.dtype}, "
                                 f"{tuple(got.shape)})")
        worst["draw_rows"] = worst.get("draw_rows", 0) + x.numel()
        worst["draw_near_ties"] = worst.get("draw_near_ties", 0) + int(near.sum())
        worst["draw_differ"] = worst.get("draw_differ", 0) + int(differ.sum())
        counts.append(f"{kind} {int(differ.sum())} of {x.numel()} rows differ, "
                      f"{int(near.sum())} near-ties")

    a = rk.euler_posterior_draw(rev, x, h, seed=key[0], substep=key[1])
    c = rk.euler_posterior_draw(rev, x, h, seed=key[0], substep=1)
    d = rk.euler_posterior_draw(rev, x, h, seed=key[0] + 1, substep=0)
    moved = int((a != x).sum())
    if not torch.equal(a, got):
        raise AssertionError(f"euler_posterior draw {what}: one key, two results")
    if moved >= 8 and (torch.equal(a, c) or torch.equal(a, d)):
        raise AssertionError(f"euler_posterior draw {what}: another key, the same "
                             f"{moved} moves")
    return "; ".join(counts) + f"; keyed repeats, {moved} moved"


def hold_draw_statistics(dev) -> dict:
    """The keyed draw mode's histograms against exp(logp): at S = 2, 9, 129
    and 256, 2^16 identical rows of each of two kinds, one with diag = 0 and
    one where staying put is likely (p_x = 0.7), drawn in one launch; every
    entry's count within 5 binomial standard deviations of n * p. The
    entries of p ~ 1e-35 (x in the diag = 0 row) must never be drawn."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    n = 1 << 16
    out = {}
    for S in (2, 9, 129, 256):
        gen = torch.Generator(device=dev).manual_seed(S)
        r = torch.exp(torch.randn((2, S), generator=gen, device=dev))
        x = torch.tensor([[S // 3], [S - 1]], dtype=torch.int32, device=dev)
        r.scatter_(1, x.long(), 0.0)
        # h = 1: the first row's rates sum to 2 (diag = 0), the second's to 0.3
        r = r * torch.tensor([[2.0], [0.3]], device=dev) / r.sum(-1, keepdim=True)
        rev = r[:, None, :].expand(2, n, S).contiguous()
        xs = x.expand(2, n).contiguous()
        draws = rk.euler_posterior_draw(rev, xs, 1.0, seed=S | (7 << 32), substep=2)
        torch.cuda.synchronize()
        p = rk.euler_posterior_plain(rev[:, :1], xs[:, :1], 1.0)[:, 0].exp().double()
        counts = torch.stack([torch.bincount(draws[k].long(), minlength=S)
                              for k in range(2)]).double()
        sd = (n * p * (1 - p)).clamp_min(0).sqrt()
        z = ((counts - n * p).abs() / sd.clamp_min(1e-30)).where(sd > 0,
                                                             (counts - n * p).abs() * 1e30)
        worst_z = z.max().item()
        if not worst_z <= 5.0:
            raise AssertionError(f"euler_posterior draw S={S}: a count is {worst_z:.2f} "
                                 f"binomial standard deviations from n * p")
        out[S] = dict(max_z=worst_z, stay_share=counts[1, S - 1].item() / n,
                      stay_p=p[1, S - 1].item())
        log(f"  keyed draw S={S}: 2 x {n} rows, every count within {worst_z:.2f} "
            f"binomial sd of n * p (diag = 0 row never stays: "
            f"{int(counts[0, S // 3].item())} draws of x; stay row {out[S]['stay_share']:.4f} "
            f"vs p {out[S]['stay_p']:.4f})")
    return out


def rate_timing(N: int, D: int, S: int, dev) -> dict:
    """Both rate kernels, their plain versions and bounds at (N, D, S) with
    a shared table, mid-grid: {kernel name: timings}."""
    from ctdd_tpu_torch.ops import rate_kernels as rk

    out = {}
    logits, qc, qt0, rc, x, h = rate_inputs(N, D, S, (0.5,), 1, dev, False)
    iters = 20 if N * D * S > 10**6 else 200
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
        out[name] = within_bound(dict(
            **t, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, shape=[N, D, S]))
        log(f"  {name} N={N} D={D} S={S}: kernel {out[name]['ms']:.4f} ms by "
            f"{out[name]['timed_by']} ({t['loop_ms']:.4f} ms per turn of a loop), plain "
            f"{out[name]['plain_ms']:.4f} ms, bound {out[name]['bound_ms'] * 1e3:.2f} us "
            f"({out[name]['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP at the {rate_name} rate)")
    out["euler_posterior"].update(draw_timing(rev, x, h, iters))
    return out


def draw_timing(rev, x, h, iters: int) -> dict:
    """The posterior kernel's draw mode at one shape: keyed (the sampler's
    path) beside its plain version, with injected noise, and the chain it
    replaces (`unfused`), each with its bound. Returns
    `draw_*`, `draw_injected_*` and `unfused_*` fields."""
    from ctdd_tpu_torch.ops import rate_kernels as rk
    from ctdd_tpu_torch.utils.math import gumbel_noise

    N, D, S = rev.shape
    nds, nd = rev.numel(), x.numel()
    gen = torch.Generator(device=rev.device).manual_seed(0)
    g = gumbel_noise(gen, rev.shape, rev.device)

    def injected():
        return rk.euler_posterior_draw(rev, x, h, g=g)

    def unfused():
        """The LBJF update as the sampler launched it before the draw mode:
        the log-prob kernel, `gumbel_noise`, the add, the argmax, the cast."""
        logp = rk.euler_posterior(rev, x, h)
        return torch.argmax(logp + gumbel_noise(gen, logp.shape, logp.device),
                            dim=-1).to(torch.int32)

    # the plain version of the keyed draw: its noise made in PyTorch, then
    # the plain log-probs, the add and the argmax
    t = timed(lambda: rk.euler_posterior_draw(rev, x, h, seed=5, substep=0),
              lambda: rk.euler_posterior_draw_plain(
                  rev, x, h, rk.philox_gumbel(5, 0, rev.shape, rev.device)), iters)
    # the rates and x read once, the state written; ~13 f32 operations per
    # entry (the posterior's 8, the noise's two logs and clamp, the add and
    # the compare); the Philox rounds are integer work
    nbytes = 4 * (nds + 2 * nd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 13.0 * nds / F32_FLOP_PER_S * 1e3
    draw = within_bound(dict(**t, bound_ms=max(bytes_ms, ops_ms),
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
    inj_bound = (nbytes + 4 * nds) / HBM_BYTES_PER_S * 1e3
    inj_loop = cuda_ms(injected, iters)
    inj_dev = device_ms(injected, iters)
    unf_loop = cuda_ms(unfused, max(iters // 4, 3))
    unf_dev = device_ms(unfused, max(iters // 4, 3))
    # the chain's launches, counted once in a trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        unfused()
        torch.cuda.synchronize()
    chain_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {f"draw_{k}": v for k, v in draw.items()
           if k in ("ms", "loop_ms", "device_ms", "plain_ms", "plain_loop_ms", "bound_ms",
                    "bound_by", "timed_by")}
    out.update(draw_bytes=nbytes,
               draw_injected_ms=inj_dev if inj_dev >= inj_bound else inj_loop,
               draw_injected_loop_ms=inj_loop, draw_injected_bound_ms=inj_bound,
               unfused_ms=unf_dev or unf_loop, unfused_loop_ms=unf_loop,
               unfused_timed_by="device trace" if unf_dev else "events around a loop",
               unfused_kernels=chain_kernels or None)  # None: the trace lost them
    log(f"  euler_posterior draw N={N} D={D} S={S}: keyed {out['draw_ms']:.4f} ms by "
        f"{out['draw_timed_by']} ({out['draw_loop_ms']:.4f} ms per turn of a loop), "
        f"bound {out['draw_bound_ms'] * 1e3:.2f} us ({out['draw_bound_by']}: "
        f"{nbytes / 1e6:.2f} MB), {out['draw_ms'] / out['draw_bound_ms']:.2f}x bound; "
        f"injected g {out['draw_injected_ms']:.4f} ms (bound "
        f"{inj_bound * 1e3:.2f} us); plain draw {out['draw_plain_ms']:.4f} ms; the "
        f"chain it replaces {out['unfused_ms']:.4f} ms by {out['unfused_timed_by']} "
        f"({unf_loop:.4f} ms per turn of a loop, "
        + (f"{chain_kernels} kernels)" if chain_kernels else "kernels not traced)"))
    return out


def draw_first(t: dict) -> dict:
    """The posterior's timings at one shape (`rate_timing`'s entry) with
    the draw mode keyed, the sampler's path, in the headline fields and
    the log-prob mode's under `logprob_*`; the injected-noise draw and the
    replaced chain keep their `draw_injected_*` and `unfused_*` fields."""
    out = {"shape": t["shape"]}
    for field in ("ms", "loop_ms", "device_ms", "plain_ms", "plain_loop_ms", "bound_ms",
                  "bound_by", "timed_by", "bytes"):
        out[field], out[f"logprob_{field}"] = t[f"draw_{field}"], t[field]
    out.update({f: v for f, v in t.items() if f.startswith(("draw_injected_", "unfused_"))})
    return out


def phase_rate_timing(dev) -> dict:
    """Both kernels at the serving shapes (shared table, mid-grid)."""
    out = {"reverse_rates": {}, "euler_posterior": {}}
    # the flagship's shapes; sudoku's sampling shape (the eval's 256 boards,
    # S=9), pianoroll_cond's (cond_mmd's 64 suffixes of 224, S=129) and the
    # EBM's (256 rows of 32 bits), keyed by name
    for key, shape in ((256, (256, 784, 256)), (16, (16, 784, 256)),
                       ("sudoku", (256, 81, 9)), ("pianoroll", (64, 224, 129)),
                       ("ebm", (256, 32, 2))):
        for name, t in rate_timing(*shape, dev).items():
            out[name][key] = t
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
    from ctdd_tpu_torch.utils.device import tf32_off

    with tf32_off():
        return _unet_vs_cpu(dev)


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
    own_launches = {label: sum(e.count for e in kernels if part in e.key) / steps
                    for label, part in kernel_names.items()}
    out = dict(sampler=cfg.sampler.name, step_ms=step_ms, unet_ms=unet_ms,
               device_busy_ms=busy_ms, **own, launches_per_step=own_launches,
               idle_share=1.0 - busy_ms / step_ms if busy_ms else None,
               device_kernels_per_step=sum(e.count for e in kernels) / steps)
    log(f"  {cfg.sampler.name} step at batch 16: {step_ms:.3f} ms wall; UNet "
        f"forward {unet_ms:.3f} ms (events); device busy {busy_ms:.3f} ms ("
        + ", ".join(f"{k} {v:.3f} ms, {own_launches[k]:g} a step" for k, v in own.items())
        + f") over {out['device_kernels_per_step']:.0f} kernels per step; idle share "
        + (f"{out['idle_share']:.3f}" if busy_ms else "not measured"))
    return out


def serve_request(dev, tmpdir, label, cfg, n, expected, seed, warmup=True):
    """Seeded checkpoint -> SamplerService -> one /generate?n= request over
    HTTP (`serve_checkpoint`), after a warm-up batch unless `warmup` is off."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint

    torch.manual_seed(seed)
    model = create_model(cfg, device=dev)
    sd = model.net.state_dict()
    path = save_checkpoint(f"{tmpdir}/{label}.pt", sd, sd, step=0, config=cfg)
    return serve_checkpoint(dev, label, cfg, path, n, expected, warmup=warmup)


def serve_checkpoint(dev, label, cfg, path, n, expected, warmup, query: str = ""):
    """Checkpoint file -> SamplerService -> one /generate?n= request over
    HTTP (`query` appended to it). The launch counters are set to 0 just
    before the request and read just after; `expected` gives every
    kernel's exact count per batch."""
    from ctdd_tpu_torch.ops import kernel_wrappers
    from ctdd_tpu_torch.serving import SamplerService, run_http_server

    svc = SamplerService(cfg, path, batch=16, device=dev)
    n_params = sum(v.numel() for v in svc.model.net.state_dict().values())
    line = f"  {label}: {n_params / 1e6:.2f} M params, {cfg.sampler.name}, step {svc.step}"
    if warmup:
        t0 = time.perf_counter()
        svc.warmup()
        torch.cuda.synchronize()
        line += f"; warm-up batch of 16: {time.perf_counter() - t0:.2f} s"
    log(line)

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
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n={n}{query}",
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
    """The flagship with the fused TauL update: one batch of 16 (two before
    phase [13] came; cut for time)."""
    cfg = full_cfg(fused=True)
    return serve_request(dev, tmpdir, "tauUnet_mnist TauL fused", cfg, 16,
                         {"fused_tau_leap_update": cfg.sampler.num_steps}, seed=1)


def phase_serving_slice2(dev, tmpdir):
    """LBJF with a live corrector at full width, MidPointTauL (fused) and
    the maze preset; every expected count comes from the sampler's own time
    grid. No warm-up batch (cut for time when phase [13] came: the kernels
    and the network's layers are warm from [7])."""
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    out = {}
    cfg = full_cfg(fused=False, sampler="LBJF")
    cfg.sampler.num_steps = SERVE_CUT_STEPS
    cfg.sampler.num_corrector_steps = 2
    cfg.sampler.corrector_entry_time = 0.05
    ts, _ = get_sampler(cfg).time_grid()
    live = int((ts <= np.float32(cfg.sampler.corrector_entry_time)).sum())
    per_batch = len(ts) + cfg.sampler.num_corrector_steps * live
    log(f"  LBJF grid: {len(ts)} steps, {live} at or below the "
        f"corrector's entry time -> {per_batch} launches of each rate kernel")
    out["tauUnet_mnist LBJF corrector"] = serve_request(
        dev, tmpdir, "tauUnet_mnist LBJF corrector", cfg, 16,
        {"reverse_rates": per_batch, "euler_posterior": per_batch}, seed=3, warmup=False)

    cfg = full_cfg(fused=True, preset="tauUnet_mnist_ll")
    cfg.sampler.num_steps = SERVE_CUT_STEPS
    n_steps = len(get_sampler(cfg).time_grid()[0])
    out["tauUnet_mnist_ll"] = serve_request(
        dev, tmpdir, "tauUnet_mnist_ll", cfg, 16,
        {"fused_tau_leap_update": 2 * n_steps}, seed=4, warmup=False)

    cfg = full_cfg(fused=False, preset="tauUnet_maze")
    steps = len(get_sampler(cfg).time_grid()[0])
    out["tauUnet_maze"] = serve_request(
        dev, tmpdir, "tauUnet_maze", cfg, 16,
        {"reverse_rates": steps, "euler_posterior": steps}, seed=5, warmup=False)
    return out


# ---------------------------------------------------------------------------
# phase 12: training the flagship, and serving what it trained
# ---------------------------------------------------------------------------

TABLE_TOL = 1e-7  # (a) process tables, card vs CPU (float32, spectral form)
TRAIN_LOSS_RTOL = 1e-4  # (a) the loss, card vs CPU, float32 with TF32 off
GRAD_FLOOR_MULT = 6.0  # (a) gradients: cuDNN's conv algorithms (Winograd,
# implicit GEMM) round otherwise than the CPU's; allowed in units of the
# CPU's own float32 error against float64
FLOAT64_GRAD_TOL = 1e-9  # [16](d): the steps in float64, card vs CPU (read 4e-13-4.5e-12)
FLOOR_MULT = 4.0  # (a) updates: allowed, in units of their floor
MOVED_BY = 0.1  # (a): "moved otherwise" = updates that differ by > 0.1 lr
MOVED_SHARE_ABS = 1e-4  # (a): ... plus this share of the entries
RESUME_TOL = 2e-3  # (c): resumed vs uninterrupted, share of the distance trained
# phase [13](d): the bench's sampler steps (its protocol's 1000; 100 until phase [17] came)
BENCH_STEPS = 50
# phase [13](c): the FID evals' TauL steps (the preset's 1000 until phase [17] came,
# 500 until phase [19] came: cut for time)
FID_STEPS = 250
# phase [11]: LBJF with a corrector and tauUnet_mnist_ll (1000 until phase [17] came)
SERVE_CUT_STEPS = 500


def mnist_like(path: str, n: int = 8192, seed: int = 0) -> str:
    """A seeded stand-in in MNIST's layout: uint8 (n, 28, 28) images, a
    zero background and four bright strokes each, as `x_train`/`y_train`;
    an image's label is the decile of its mean intensity (for the trained
    FID features of phase [13])."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    rows = np.arange(n)[:, None]
    along = np.linspace(0.0, 1.0, 24)
    for _ in range(4):
        p0, p1 = rng.uniform(5, 22, (n, 2)), rng.uniform(5, 22, (n, 2))
        val = rng.integers(160, 256, (n, 1)).astype(np.uint8)
        pts = p0[:, None, :] + (p1 - p0)[:, None, :] * along[None, :, None]
        for dy in (0, 1):
            for dx in (0, 1):
                r = np.clip(np.rint(pts[..., 0]).astype(int) + dy, 0, 27)
                c = np.clip(np.rint(pts[..., 1]).astype(int) + dx, 0, 27)
                imgs[rows, r, c] = np.maximum(imgs[rows, r, c], val)
    ink = imgs.reshape(n, -1).mean(axis=1)
    labels = np.searchsorted(np.quantile(ink, np.linspace(0.1, 0.9, 9)), ink)
    np.savez(path, x_train=imgs, y_train=labels.astype(np.int64))
    return path


def train_cfg(tmpdir: str, data_path: str, run: str, preset: str = "tauUnet_mnist"):
    """A preset at full width on the stand-in data, fused grids."""
    cfg = full_cfg(fused=True, preset=preset)
    cfg.data.location = data_path
    cfg.save_location = f"{tmpdir}/{run}"
    cfg.sampler.sample_freq = 100
    cfg.saving.checkpoint_freq = 50
    return cfg


class OnTables:
    """`model`'s network over the process tables of `tables` (a model on the
    CPU), cast to `dtype` and moved to `model`'s device. The ELBO divides by
    q_{t|0} + 1e-9, so entries near 1e-9, which float32 rounds differently
    on two devices, would move the loss by itself; both sides of the step
    comparison therefore use the CPU's tables, and phase [12] compares the
    tables apart."""

    def __init__(self, model, tables, dtype=torch.float32):
        self.model, self.tables, self.dtype = model, tables, dtype

    def transition(self, t):
        return self.tables.transition(t.cpu().float()).to(self.model.device, self.dtype)

    def rate(self, t):
        return self.tables.rate(t.cpu().float()).to(self.model.device, self.dtype)

    def apply(self, params, x, t, train=False, **kwargs):
        return self.model.apply(params, x, t.to(self.dtype), train=train, **kwargs)


def ctelbo_loss(cfg):
    """The flagship's loss on injected (x_t, x̃), dropout off."""
    from ctdd_tpu_torch.losses.losses import _ctelbo_terms
    from ctdd_tpu_torch.utils.math import mean_cross_entropy

    def fn(model, p, x0, ts, draws):
        neg_elbo, logits = _ctelbo_terms(model, p, None, x0, ts, cfg.loss.eps_ratio,
                                         cfg.loss.one_forward_pass, False, samples=draws)
        return neg_elbo + cfg.loss.nll_weight * mean_cross_entropy(logits, x0)
    return fn


def catrm_loss(cfg):
    """CatRM (`cfg.loss.loss_type`) on an injected x_t, dropout off."""
    from ctdd_tpu_torch.losses.losses import _catrm_comp_loss
    from ctdd_tpu_torch.ops.logprob import logprob_with_logits

    def fn(model, p, x0, ts, draws):
        (xt,) = draws
        logits = model.apply(p, xt, ts)
        ll_all, ll_xt = logprob_with_logits(cfg.loss.logit_type, model, xt, ts, logits)
        loss = _catrm_comp_loss(cfg, model, xt, ts, ll_all, ll_xt)
        return torch.sum(loss * (1.0 - cfg.loss.ce_coeff)) / x0.shape[0]
    return fn


def one_train_step(model, params, tx, cfg, loss_fn, x0, ts, draws):
    """One step of `loss_fn` on injected times and draws: (loss, grads,
    state after the step)."""
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import apply_update, value_and_grad

    state = create_train_state(params, tx)
    value, grads = value_and_grad(lambda p: loss_fn(model, p, x0, ts, draws), state.params)
    state, _ = apply_update(state, value, grads, tx, float(cfg.model.ema_decay))
    return float(value), {k: g.cpu().double() for k, g in grads.items()}, state


def phase_train_step(dev, data_path) -> dict:
    """(a) The flagship's step (`hold_train_step`), x̃ and x_t drawn once on
    the CPU; and where the card's step differs from itself (`determinism`)."""
    from ctdd_tpu_torch.losses.losses import sample_xt_xtilde
    from ctdd_tpu_torch.models.base import create_model

    cfg = full_cfg(fused=True)
    torch.manual_seed(0)
    cpu = create_model(cfg, device="cpu")
    gpu = create_model(cfg, device=dev)
    x0 = torch.from_numpy(np.load(data_path)["x_train"][:4].reshape(4, -1).astype(np.int32))
    ts = torch.tensor([0.02, 0.1, 0.3, 0.6])
    draws = sample_xt_xtilde(torch.Generator().manual_seed(0), cpu.transition(ts),
                             cpu.rate(ts), x0)
    out = hold_train_step(cfg, cpu, gpu, ctelbo_loss(cfg), x0, ts, draws)
    out["determinism"] = determinism(dev, cfg, cpu, gpu, ctelbo_loss(cfg), x0, ts, draws)
    return out


def hold_train_step(cfg, cpu, gpu, loss_fn, x0, ts, draws, ulp_draws: int = 0,
                    hold_tables: bool = True, invariant: tuple = (),
                    float64_tol: float = None) -> dict:
    """One step at batch 4, card vs CPU, TF32 off on the card, both on the
    CPU's process tables (`OnTables`); the tables themselves agree to
    TABLE_TOL. The ELBO's gradient carries 1/q_{t|0} factors up to 1e9, so
    the card is held against the CPU's own float32 error, measured against a
    float64 step on the CPU: per leaf, the largest |card - CPU| over the
    leaf's largest |g| (the network's, for a key bias) must stay within
    GRAD_FLOOR_MULT times the worst leaf's |CPU - float64|. After the step, an Adam update moves a weight by
    about lr · sign(g): the share of weights (and EMA entries) whose update
    differs by more than MOVED_BY · lr must stay within FLOOR_MULT times the
    float32-vs-float64 share plus MOVED_SHARE_ABS. A control repeats the
    card's side with TF32 on: its tables and gradients must fail their
    limits. `gpu` gets `cpu`'s weights. With `ulp_draws`, the CPU's own
    float32 error is also taken as the largest change of its gradient when
    each time moves by one float32 ulp up or down (that many seeded draws):
    through the sinusoid's ~1000 rad arguments that moves the activations
    by as much as float32 rounding does, and a gradient through ReLU gates
    (the hollow family's) changes discretely where a gate flips, which one
    float64 run does not show. A leaf whose float64 gradient is exactly 0
    (a frozen weight the forward detaches) must be exactly 0 on every side.
    With `hold_tables` off the tables' card-vs-CPU error is reported, not
    held (both sides of the step run on the CPU's tables either way), and
    the TF32 control is held on the gradients alone. `invariant` names more
    leaves (by suffix) whose gradient is 0 in exact arithmetic. With
    `float64_tol` the step is also held in float64 on both sides: the
    card's gradient within `float64_tol` of the CPU's, per leaf on the same
    scale, and the card's float32 gradient against the CPU's float64, the
    control, must exceed it. Where the float32 limit has little room against
    TF32 (a loss with 1/q_{t|0} factors up to 1e9 makes both errors large),
    this holds the card's arithmetic to the CPU's without float32 rounding
    in the way."""
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.utils.device import tf32

    dev = gpu.device
    gpu.net.load_state_dict(cpu.net.state_dict())
    tx = get_optimizer(cfg)
    lr = float(cfg.optimizer.lr)
    weights = dict(cpu.net.named_parameters())

    def on_card(enabled: bool):
        """(tables' error against the CPU's, loss, grads, state after the
        step) on the card; the step updates its params in place, so it
        starts from a copy."""
        with tf32(enabled):
            table_err = max(
                (gpu.transition(ts.to(dev)).cpu() - cpu.transition(ts)).abs().max().item(),
                ((gpu.rate(ts.to(dev)).cpu() - cpu.rate(ts)).abs()
                 / cpu.rate(ts).abs().amax(-1, keepdim=True)).max().item())
            return (table_err, *one_train_step(
                OnTables(gpu, cpu), {k: v.detach().clone().to(dev) for k, v in weights.items()},
                tx, cfg, loss_fn, x0.to(dev), ts.to(dev), tuple(d.to(dev) for d in draws)))

    table_err, l_gpu, g_gpu, s_gpu = on_card(enabled=False)
    table_tf32, _, g_tf32, _ = on_card(enabled=True)
    l_cpu, g_cpu, s_cpu = one_train_step(
        cpu, {k: v.detach().clone() for k, v in weights.items()}, tx, cfg, loss_fn, x0, ts,
        draws)
    l_64, g_64, s_64 = one_train_step(
        OnTables(cpu, cpu, torch.float64), {k: v.double() for k, v in weights.items()},
        tx, cfg, loss_fn, x0, ts.double(), draws)

    # the hollow family's key biases and the sudoku network's attention-bias
    # bias have a zero gradient in exact arithmetic (the softmax over keys is
    # invariant to them): those leaves hold rounding noise on every side and
    # are scaled by the largest |g|
    top = max(g.abs().max().item() for g in g_64.values())
    scale = {k: top if k.endswith(("key.bias", "CrossAttention_0.Dense_1.bias",
                                   "BiasedSelfAttention_0.Dense_1.bias", *invariant))
             else g.abs().max().item() for k, g in g_64.items()}

    def leaf_err(a, b, k):
        if scale[k] == 0.0:  # a detached leaf: exactly 0 everywhere
            return 0.0 if not (a[k].any() or b[k].any()) else math.inf
        return (a[k] - b[k]).abs().max().item() / scale[k]

    def grad_err(a, b):
        return max(leaf_err(a, b, k) for k in g_64)

    grad_card, grad_f64 = grad_err(g_gpu, g_cpu), grad_err(g_cpu, g_64)
    gen = torch.Generator().manual_seed(1)

    def ts_ulp_off():
        up = torch.rand(ts.shape, generator=gen) < 0.5
        return torch.nextafter(ts, torch.where(up, torch.inf, -torch.inf))

    grad_ulp = max((grad_err(one_train_step(
        cpu, {k: v.detach().clone() for k, v in weights.items()}, tx, cfg, loss_fn, x0,
        ts_ulp_off(), draws)[1], g_cpu) for _ in range(ulp_draws)), default=0.0)
    grad_floor = max(grad_f64, grad_ulp)
    # measurement only: the same step in float64 on the card
    _, g_card64, _ = one_train_step(
        OnTables(gpu, cpu, torch.float64),
        {k: v.detach().double().to(dev) for k, v in weights.items()}, tx, cfg, loss_fn,
        x0.to(dev), ts.double().to(dev), tuple(d.to(dev) for d in draws))
    grad_float64_devices = grad_err(g_card64, g_64)

    def moved_otherwise(a, b):
        n = sum(v.numel() for v in a.values())
        return sum(int(((a[k].detach().cpu().double() - b[k].detach().cpu().double()).abs()
                        > MOVED_BY * lr).sum()) for k in a) / n

    out = dict(
        table_err=table_err, table_tol=TABLE_TOL,
        loss_card=l_gpu, loss_cpu=l_cpu, loss_float64=l_64,
        loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu), loss_tol=TRAIN_LOSS_RTOL,
        grad_err=grad_card, grad_floor=grad_floor, grad_vs_float64=grad_f64,
        grad_ulp_spread=grad_ulp, grad_tol=GRAD_FLOOR_MULT * grad_floor,
        grad_float64_card_vs_cpu=grad_float64_devices,
        params_moved_otherwise=moved_otherwise(s_gpu.params, s_cpu.params),
        params_floor=moved_otherwise(s_cpu.params, s_64.params),
        ema_moved_otherwise=moved_otherwise(s_gpu.ema_params, s_cpu.ema_params),
        ema_floor=moved_otherwise(s_cpu.ema_params, s_64.ema_params),
        control_tf32_table_err=table_tf32, control_tf32_grad_err=grad_err(g_tf32, g_cpu))
    if float64_tol is not None:
        out.update(grad_float64_tol=float64_tol,
                   control_float32_vs_float64=grad_err(g_gpu, g_64))
    out["params_tol"] = FLOOR_MULT * out["params_floor"] + MOVED_SHARE_ABS
    out["ema_tol"] = FLOOR_MULT * out["ema_floor"] + MOVED_SHARE_ABS
    log(f"  process tables at the step's times, card vs CPU: {table_err:.3e} (q_{{t|0}} "
        f"absolute, rates over their row's largest; tol {TABLE_TOL:.0e})")
    log(f"  loss: card {l_gpu:.6f}, CPU {l_cpu:.6f}, float64 {l_64:.6f}; card vs CPU "
        f"{out['loss_rel_err']:.3e} (tol {TRAIN_LOSS_RTOL:.0e})")
    log(f"  grads, worst leaf, share of its largest |g|: card vs CPU {grad_card:.3e} "
        f"(tol {out['grad_tol']:.3e} = {GRAD_FLOOR_MULT:g} x the CPU's float32 error "
        f"{grad_floor:.3e}: against float64 {grad_f64:.3e}"
        + (f", with the times one ulp off ({ulp_draws} draws) {grad_ulp:.3e})"
           if ulp_draws else ")")
        + f"; in float64 on both, card vs CPU {grad_float64_devices:.3e} "
        + ("(not held)" if float64_tol is None else
           f"(tol {float64_tol:.0e}; control, the card's float32 against the CPU's "
           f"float64: {out['control_float32_vs_float64']:.3e}, must exceed the tol)"))
    for what in ("params", "ema"):
        log(f"  {what} after the step, share whose update differs by > {MOVED_BY:g} lr: "
            f"card vs CPU {out[what + '_moved_otherwise']:.3e} (tol {out[what + '_tol']:.3e}; "
            f"CPU vs float64 {out[what + '_floor']:.3e})")
    log(f"  control, TF32 on: tables {table_tf32:.3e}, grads {out['control_tf32_grad_err']:.3e} "
        "(each must exceed its tol)")
    if s_gpu.step != 1 or s_gpu.opt_state.count != 1 or s_gpu.ema_num_updates != 1:
        raise AssertionError("the step on the card did not advance its counters")
    out["tables_held"] = hold_tables
    if not ((table_err <= TABLE_TOL or not hold_tables)
            and out["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and grad_card <= out["grad_tol"]
            and out["params_moved_otherwise"] <= out["params_tol"]
            and out["ema_moved_otherwise"] <= out["ema_tol"]
            and (float64_tol is None or grad_float64_devices <= float64_tol)):
        raise AssertionError(f"train step on the card differs from the CPU: {out}")
    if not ((table_tf32 > TABLE_TOL or not hold_tables)
            and out["control_tf32_grad_err"] > out["grad_tol"]
            and (float64_tol is None or out["control_float32_vs_float64"] > float64_tol)):
        raise AssertionError(f"the limits pass a step with TF32 on: {out}")
    return out


def determinism(dev, cfg, cpu, gpu, loss_fn, x0, ts, draws) -> dict:
    """Measurement only (nothing is held): the card's step taken twice from
    the same state with PyTorch's defaults, which gradient leaves differ bit
    for bit; the same with `torch.backends.cudnn.deterministic` on, scoped to
    this block; the ops PyTorch itself names non-deterministic on this step
    (`use_deterministic_algorithms(warn_only=True)`, scoped); and the cost of
    cuDNN's deterministic algorithms on the network's forward and backward
    at the preset's batch (turns: default, deterministic, deterministic,
    default)."""
    import warnings

    from ctdd_tpu_torch.training.optimizers import get_optimizer

    tx = get_optimizer(cfg)
    weights = {k: v.detach().to(dev) for k, v in cpu.net.named_parameters()}
    args = (x0.to(dev), ts.to(dev), tuple(d.to(dev) for d in draws))

    def grads():
        return one_train_step(OnTables(gpu, cpu), {k: v.clone() for k, v in weights.items()},
                              tx, cfg, loss_fn, *args)[1]

    def differing():
        a, b = grads(), grads()
        return sorted(k for k in a if not torch.equal(a[k], b[k]))

    saved = torch.backends.cudnn.deterministic
    default = differing()
    try:
        torch.backends.cudnn.deterministic = True
        with_cudnn_det = differing()
    finally:
        torch.backends.cudnn.deterministic = saved
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            grads()
    finally:
        torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split(" does not have")[0].strip()[:100]
                    for w in caught if "deterministic" in str(w.message)})

    B = cfg.data.batch_size
    D, S = cfg.model.concat_dim, cfg.data.S
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, S, (B, D), generator=g, device=dev, dtype=torch.int32)
    t = torch.rand(B, generator=g, device=dev) * 0.99 + 0.01
    plist = list(weights.values())
    for v in plist:
        v.requires_grad_(True)
    g_out = torch.randn((B, D, S), generator=g, device=dev)

    def fwd_bwd():
        torch.autograd.grad(gpu.apply(weights, x, t, train=True), plist, grad_outputs=g_out,
                            allow_unused=True)

    times = {False: [], True: []}
    try:
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            times[det].append(cuda_ms(fwd_bwd, 5))
    finally:
        torch.backends.cudnn.deterministic = saved
    out = dict(leaves=len(weights), differ_default=default,
               differ_cudnn_deterministic=with_cudnn_det, named_nondeterministic_ops=named,
               fwd_bwd_ms_default=float(np.mean(times[False])),
               fwd_bwd_ms_cudnn_deterministic=float(np.mean(times[True])), batch=B)
    log(f"  determinism: the same step twice on the card, leaves that differ bit for bit: "
        f"{len(default)} of {len(weights)} with the defaults, {len(with_cudnn_det)} with "
        f"cudnn.deterministic; ops PyTorch names non-deterministic: {named}; network "
        f"forward+backward at B={B}: {out['fwd_bwd_ms_default']:.3f} ms default, "
        f"{out['fwd_bwd_ms_cudnn_deterministic']:.3f} ms with cudnn.deterministic")
    log(f"    differ with the defaults: {default[:12]}{' ...' if len(default) > 12 else ''}")
    log(f"    differ with cudnn.deterministic: {with_cudnn_det[:12]}"
        f"{' ...' if len(with_cudnn_det) > 12 else ''}")
    return out


def train_step_breakdown(dev, cfg, data_path, steps: int = 10) -> dict:
    """Where one train step's time goes at the config's batch: wall time,
    device time of the whole step (torch.profiler), of the network's forward
    and backward alone and of the optimizer and EMA alone (each traced alone
    on the same inputs); the loss is the rest of the step's device time.
    `data_path` is an MNIST-layout npz, or the (N, D) pool itself."""
    from torch.profiler import ProfilerActivity, profile

    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import (
        apply_update, make_device_data_step, value_and_grad,
    )

    torch.manual_seed(5)
    model = create_model(cfg, device=dev)
    tx = get_optimizer(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    pool = np.load(data_path)["x_train"] if isinstance(data_path, str) else data_path
    data = torch.from_numpy(pool.reshape(-1, cfg.model.concat_dim).astype(np.int32)).to(dev)
    B = cfg.data.batch_size
    decay = float(cfg.model.ema_decay)
    step = make_device_data_step(model, get_loss(cfg), tx, B, ema_decay=decay)
    for _ in range(3):
        state, _ = step(state, data, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, data, 0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(5):
            state, _ = step(state, data, 0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 5

    x, t = data[:B], torch.rand(B, device=dev) * 0.99 + 0.01
    plist = list(state.params.values())
    g_out = torch.randn((B, cfg.model.concat_dim, cfg.data.S), device=dev)

    def net_fwd_bwd():
        torch.autograd.grad(model.apply(state.params, x, t, train=True), plist,
                            grad_outputs=g_out, allow_unused=True)

    value, grads = value_and_grad(
        lambda p: model.apply(p, x, t, train=True).float().square().mean(), state.params)
    net_ms = device_ms(net_fwd_bwd, 5)
    opt_ms = device_ms(lambda: apply_update(state, value, grads, tx, decay), 5)
    out = dict(batch=B, step_ms=step_ms, steps_per_s=1e3 / step_ms,
               device_busy_ms=busy_ms, network_fwd_bwd_ms=net_ms,
               optimizer_ema_ms=opt_ms,
               loss_ms=busy_ms - net_ms - opt_ms if busy_ms else None,
               idle_share=1.0 - busy_ms / step_ms if busy_ms else None,
               device_kernels_per_step=sum(e.count for e in kernels) / 5)
    log(f"  B={B} train step: {step_ms:.3f} ms wall ({out['steps_per_s']:.2f} steps/s); "
        f"device busy {busy_ms:.3f} ms: network forward+backward {net_ms:.3f} ms, "
        f"optimizer+EMA {opt_ms:.3f} ms, loss (the rest) "
        + (f"{out['loss_ms']:.3f} ms" if busy_ms else "not measured")
        + f"; {out['device_kernels_per_step']:.0f} device kernels per step; idle share "
        + (f"{out['idle_share']:.3f}" if busy_ms else "not measured"))
    return out


def start_weights(cfg, dev) -> dict:
    """The weights train(seed=0) starts from."""
    from ctdd_tpu_torch.models.base import create_model

    net = create_model(cfg, device="cpu").net
    net.init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach().to(dev) for k, v in net.named_parameters()}


@torch.no_grad()
def held_out_loss(model, cfg, data_path, params) -> float:
    """The preset's loss on the first 64 images with fixed draws (times, x_t,
    x̃ from one seed) and dropout off: noise-free, unlike the step losses,
    whose times differ from step to step."""
    from ctdd_tpu_torch.losses.losses import get_loss

    x0 = torch.from_numpy(np.load(data_path)["x_train"][:64].reshape(64, -1).astype(np.int32))
    gen = torch.Generator(device=model.device).manual_seed(123)
    return float(get_loss(cfg).calc_loss(model, params, gen, x0.to(model.device),
                                         train=False))


def check_losses(label, losses, first, last):
    if not np.isfinite(losses).all() or losses.max() >= 1e9:
        raise AssertionError(f"{label}: non-finite or skipped losses: {losses.tolist()}")
    if not last < first:
        raise AssertionError(f"{label}: the loss did not fall: first 10 {first}, last 10 {last}")


def rel_distance(a, b, origin) -> float:
    """||a - b|| / ||b - origin|| over all entries: how far apart two
    trajectories end, in units of how far training moved the weights."""
    num = sum(float((a[k].detach().double() - b[k].detach().double()).square().sum())
              for k in b)
    den = sum(float((b[k].detach().double() - origin[k].double()).square().sum())
              for k in b)
    return math.sqrt(num / den)


def phase_training(dev, tmpdir, data_path) -> dict:
    """(b) 100 full-width steps through train() with the in-loop grid, and
    50 of the twin preset; (c) 50 more steps from (b)'s checkpoint at 50, in
    a fresh train(), against (b)'s 100 within RESUME_TOL, and the same from
    that checkpoint with Adam's moments zeroed, which must exceed it; (d)
    the trained checkpoint served over HTTP."""
    from ctdd_tpu_torch.config.base import Config
    from ctdd_tpu_torch.ops import kernel_wrappers
    from ctdd_tpu_torch.training.loop import train
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

    wrappers = kernel_wrappers()
    cfg = train_cfg(tmpdir, data_path, "run")
    start = start_weights(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    state, info = train(cfg, n_iters=100, seed=0, device=dev, log_every=25)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grid_launches = {name: w.launches for name, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = np.asarray(info["step_losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    grid = np.load(f"{info['paths']['pngs']}/samples_100.npy")
    held = {k: held_out_loss(info["model"], cfg, data_path, w)
            for k, w in (("start", start), ("trained", state.params))}
    log(f"  100 steps at B={cfg.data.batch_size} in {seconds:.1f} s with one grid of 16 "
        f"samples: {info['steps_per_sec']:.3f} steps/s steady (first step, grid and "
        f"checkpoint saves left out); peak device memory {peak_gb:.2f} GB; mean loss of "
        f"the first 10 steps {first:.1f}, last 10 {last:.1f}; on a fixed batch with "
        f"fixed draws {held['start']:.1f} at the start, {held['trained']:.1f} after; "
        f"grid launches { {k: v for k, v in grid_launches.items() if v} }")
    check_losses("tauUnet_mnist", losses, first, last)
    if not held["trained"] < held["start"]:
        raise AssertionError(f"the loss on a fixed batch did not fall: {held}")

    # the twin preset's loss (NLLOriginal), 50 steps without a grid
    twin = train_cfg(tmpdir, data_path, "twin", preset="tauUnet_mnist_ll")
    twin.sampler.sample_freq = 0
    _, twin_info = train(twin, n_iters=50, seed=0, device=dev, log_every=50)
    twin_losses = np.asarray(twin_info["step_losses"])
    twin_first, twin_last = float(twin_losses[:10].mean()), float(twin_losses[-10:].mean())
    log(f"  tauUnet_mnist_ll (NLLOriginal) 50 steps: {twin_info['steps_per_sec']:.3f} "
        f"steps/s; mean loss of the first 10 steps {twin_first:.4f}, last 10 {twin_last:.4f}")
    check_losses("tauUnet_mnist_ll", twin_losses, twin_first, twin_last)
    if grid_launches != {"fused_tau_leap_update": cfg.sampler.num_steps,
                         "reverse_rates": 0, "euler_posterior": 0}:
        raise AssertionError(f"in-loop grid launches {grid_launches}")
    if grid.shape != (16, 784) or grid.min() < 0 or grid.max() > 255:
        raise AssertionError(f"bad in-loop grid {grid.shape}")

    log("  step breakdown")
    breakdown = train_step_breakdown(dev, cfg, data_path)

    # (c) the checkpoint (b) wrote after 50 steps, a fresh train() from it,
    # 50 more; and, as a control that must fail, the same with Adam's
    # moments zeroed in that checkpoint (count kept)
    cfg_r = train_cfg(tmpdir, data_path, "resume")
    cfg_r.sampler.sample_freq = 0
    at50 = torch.load(f"{info['paths']['checkpoints']}/50.pt", weights_only=True)
    for sub, ckpt in (("at50", at50), ("at50_zeroed", {**at50, "opt_state": {
            **at50["opt_state"], **{m: {k: torch.zeros_like(v) for k, v in
                                        at50["opt_state"][m].items()} for m in ("mu", "nu")}}})):
        os.makedirs(f"{tmpdir}/{sub}")
        torch.save(ckpt, f"{tmpdir}/{sub}/50.pt")
    resumed, _ = train(cfg_r, n_iters=100, seed=0, device=dev, log_every=50,
                       resume_from=f"{tmpdir}/at50")
    zeroed, _ = train(cfg_r, n_iters=100, seed=0, device=dev, log_every=50,
                      resume_from=f"{tmpdir}/at50_zeroed")
    res = {}
    for what in ("params", "ema_params"):
        full = getattr(state, what)
        res[what] = dict(resumed=rel_distance(getattr(resumed, what), full, start),
                         control_zeroed_moments=rel_distance(getattr(zeroed, what), full, start),
                         tol=RESUME_TOL,
                         identical=all(torch.equal(getattr(resumed, what)[k], full[k])
                                       for k in full))
        log(f"  resume, {what}: ||resumed - uninterrupted|| / ||uninterrupted - start|| "
            f"{res[what]['resumed']:.3e} (tol {RESUME_TOL:.0e}; control with Adam's "
            f"moments zeroed {res[what]['control_zeroed_moments']:.3e}, must exceed it); "
            f"bit-identical: {res[what]['identical']}")
    counts = dict(step=(resumed.step, state.step),
                  count=(resumed.opt_state.count, state.opt_state.count),
                  ema_num_updates=(resumed.ema_num_updates, state.ema_num_updates))
    if any(a != b or a != 100 for a, b in counts.values()):
        raise AssertionError(f"resumed counters differ: {counts}")
    if any(r["resumed"] > RESUME_TOL for r in res.values()):
        raise AssertionError(f"the resumed run left the uninterrupted one: {res}")
    if not res["params"]["control_zeroed_moments"] > RESUME_TOL:
        raise AssertionError(f"the resume limit passes zeroed moments: {res}")

    # (d) the trained checkpoint, as the trainer wrote it, over HTTP
    path = f"{info['paths']['checkpoints']}/100.pt"
    served_cfg = Config(load_checkpoint(path)["config"])
    launches, elapsed = serve_checkpoint(
        dev, "tauUnet_mnist trained 100 steps", served_cfg, path, 16,
        {"fused_tau_leap_update": served_cfg.sampler.num_steps}, warmup=False)
    return dict(
        checkpoints=info["paths"]["checkpoints"],
        grid_launches=grid_launches, served_launches=launches, served_seconds=elapsed,
        record=dict(steps=100, seconds=seconds,
                    steps_per_s_loop=info["steps_per_sec"], peak_memory_gb=peak_gb,
                    loss_first10=first, loss_last10=last,
                    held_out_loss_start=held["start"], held_out_loss_trained=held["trained"],
                    twin_steps_per_s_loop=twin_info["steps_per_sec"],
                    twin_loss_first10=twin_first, twin_loss_last10=twin_last, **breakdown,
                    resume={k: v for k, v in res.items()},
                    served_samples_per_s=16 / elapsed))

# ---------------------------------------------------------------------------
# phase 13: scoring what the port trains, through the CLIs a user runs
# ---------------------------------------------------------------------------

INCEPTION_TOL = 1e-5  # (a) features, card (f32, TF32 off) vs CPU, share of the largest |feature|
# (c) sampled images (one batch), real images (4096 until phase [18] came: cut for time)
FID_SAMPLES, FID_REAL = 256, 2048
ROOT = os.path.dirname(os.path.abspath(__file__))


def run_cli(module: str, *args, env=None, timeout: int = 900) -> list:
    """`python -m ctdd_tpu_torch.<module> args` from the checkout's root;
    its stdout lines. Raises with its stderr if it fails."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"ctdd_tpu_torch.{module}", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, **(env or {})})
    if out.returncode != 0:
        raise AssertionError(f"python -m ctdd_tpu_torch.{module} {' '.join(args)} exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    lines = out.stdout.strip().splitlines()
    log(f"  python -m ctdd_tpu_torch.{module} {' '.join(args)}: "
        f"{time.perf_counter() - t0:.1f} s")
    return lines


def random_inception_npz(path: str, seed: int = 0) -> str:
    """Seeded random InceptionV3 weights in torchvision's layout, marked
    `_family="pytorch-fid"` as the converter marks its npz: He-scaled convs,
    BatchNorm near identity (activations stay of order 1 over 94 layers)."""
    from ctdd_tpu_torch.metrics.inception import InceptionV3Features

    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in InceptionV3Features().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("conv.weight"):
            a = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith("bn.running_var"):
            a = 1.0 + 0.2 * np.abs(rng.standard_normal(shape))
        else:  # bn.bias, bn.running_mean
            a = 0.1 * rng.standard_normal(shape)
        arrays[k] = a.astype(np.float32)
    np.savez(path, _family=np.asarray("pytorch-fid"),
             _source=np.asarray(f"random weights from seed {seed}"), **arrays)
    return path


def phase_inception(dev, npz: str, data_path: str) -> dict:
    """(a) InceptionV3 from the strict npz loader on both devices: features
    of 8 stand-in images (28x28, resized to 299) on the card in float32 with
    TF32 off against the CPU's, within INCEPTION_TOL of the largest
    |feature| (read 6.4e-7 on an H100); the control, the same with TF32 on
    (read 6.3e-4), must exceed it; the device time of one batch of 128 at
    299x299."""
    from ctdd_tpu_torch.metrics.fid import preprocess_images
    from ctdd_tpu_torch.metrics.inception import (
        inception_network, inception_pool3_features, resize_299,
    )
    from ctdd_tpu_torch.utils.device import tf32, tf32_off

    imgs = preprocess_images(np.load(data_path)["x_train"][:8])
    ref = inception_pool3_features(npz, device="cpu")(imgs)
    got = inception_pool3_features(npz, device=dev)(imgs)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale
    net = inception_network(npz, device=dev)
    x = resize_299(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    with torch.no_grad(), tf32(True):
        tf32_feats = net(x).cpu().numpy()
    tf32_err = float(np.abs(tf32_feats - ref).max()) / scale
    big = torch.rand((128, 3, 299, 299), generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    with torch.no_grad(), tf32_off():
        batch_ms = device_ms(lambda: net(big), 3)
        batch_loop_ms = cuda_ms(lambda: net(big), 3, warmup=1)
    out = dict(features=list(got.shape), max_abs_feature=scale, rel_err=err, tol=INCEPTION_TOL,
               tf32_on_rel_err=tf32_err, batch128_device_ms=batch_ms,
               batch128_loop_ms=batch_loop_ms)
    log(f"  features {tuple(got.shape)}, card (f32, TF32 off) vs CPU: {err:.3e} of the largest "
        f"|feature| {scale:.3f} (tol {INCEPTION_TOL:.0e}); control, TF32 on: {tf32_err:.3e} "
        "(must exceed the tol)")
    log(f"  one batch of 128 at 299x299 (f32, TF32 off): {batch_ms:.3f} ms device time "
        f"({batch_loop_ms:.3f} ms between CUDA events)")
    if not (got.shape == (8, 2048) and np.isfinite(got).all() and err <= INCEPTION_TOL):
        raise AssertionError(f"Inception features on the card differ from the CPU's: {out}")
    if not tf32_err > INCEPTION_TOL:
        raise AssertionError(f"the Inception limit passes TF32 features: {out}")
    return out


def last_json(lines: list) -> dict:
    return json.loads(lines[-1])


def phase_mmd(dev, tmpdir: str) -> dict:
    """(b) `mlp_synthetic` through the CLIs at the reference protocol (25
    rounds x 4096 samples, LBJF/100): `cli_mmd`."""
    return cli_mmd(dev, tmpdir, "mlp_synthetic", rounds=25)


def train_cli(tmpdir: str, preset: str, steps: int = 300, *sets) -> tuple:
    """`preset` trained `steps` steps by the train CLI (with `sets`, more
    `--set` pairs): (its steps/s, its checkpoint directory)."""
    import re

    lines = run_cli("train", "--preset", preset, "--iters", str(steps), "--set",
                    f"save_location={tmpdir}/{preset}",
                    f"saving.checkpoint_freq={steps // 2}", *sets)
    m = re.search(r"steps/sec=(\S+) run=(\S+)$", lines[-1])
    log(f"  {lines[-1]}")
    return float(m.group(1)), f"{m.group(2)}/checkpoints"


def cli_mmd(dev, tmpdir: str, preset: str, rounds: int, trained: tuple = None) -> dict:
    """`preset` trained 300 steps by the train CLI (`train_cli`, or its
    result `trained`); on three steps of its sampler's grid at N=4096, the
    rate kernels of its path against their plain versions on the step's own
    inputs (the reverse rates and the posterior on the p0t path; the
    posterior on the ratio path, whose rates are plain torch); then the
    eval CLI's MMD (`rounds` x 4096 samples, EMA
    weights, the preset's sampler, all at once) with its exact launch
    counts; held between data vs data and uniform random bits vs data."""
    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_sampler
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

    train_rate, ckpt_dir = trained or train_cli(tmpdir, preset)

    cfg = get_preset(preset)
    model = create_model(cfg, device=dev)
    model.net.load_state_dict(load_checkpoint(f"{ckpt_dir}/300.pt", map_location=dev)["ema_params"])
    model.net.eval()
    sampler = get_sampler(cfg)
    ts, hs = sampler.time_grid()
    N, D = 4096, cfg.model.concat_dim
    x = torch.randint(0, 2, (N, D), generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev, dtype=torch.int32)
    worst = dict(rate_abs=0.0, rate_row_rel=0.0, post_prob=0.0, post_log=0.0)
    with torch.inference_mode():
        for i in (0, len(ts) // 2, len(ts) - 1):
            what = f"trained {preset} N={N} D={D} S=2 step {i} of the grid"
            if sampler.rate_param == "p0t":
                hold_rate_kernels(what, *sampler._rev_rates_inputs(
                    model, model.net, x, float(ts[i])), x, float(hs[i]), worst)
            else:
                hold_posterior(what, sampler._rev_rates(model, model.net, x, float(ts[i])),
                               x, float(hs[i]), worst, "ratio rates (plain torch); ")

    samples = 4096
    res = last_json(run_cli("eval", "--preset", preset, "--ckpt", ckpt_dir,
                            "--metric", "mmd", "--batch", "0", "--rounds", str(rounds)))
    per_round = len(ts) + sampler.num_corrector_steps * int(
        (ts <= np.float32(sampler.corrector_entry_time)).sum())
    want = {"fused_tau_leap_update": 0,
            "reverse_rates": rounds * per_round if sampler.rate_param == "p0t" else 0,
            "euler_posterior": rounds * per_round}
    uniform, data = mmd_levels(cfg, dev, rounds, samples)
    out = dict(preset=preset, loss=cfg.loss.name, rate_param=sampler.rate_param,
               mmd=res["value"], uniform_bits_mmd=uniform, data_vs_data_mmd=data,
               rounds=rounds, samples=samples, sampler_steps=len(ts),
               train_steps_per_s=train_rate,
               kernel_launches=res["kernel_launches"], expected_launches=want,
               kernels_vs_plain=worst, device=res["device"])
    log(f"  {preset}: MMD of the trained model {res['value']:.6f}; uniform random bits "
        f"{uniform:.6f}; data vs data {data:.3e}; launches {res['kernel_launches']} "
        f"(expected {want}: {rounds} rounds x {per_round} steps)")
    if res["kernel_launches"] != want:
        raise AssertionError(f"eval mmd {preset} launches {res['kernel_launches']}, "
                             f"expected {want}")
    if not (math.isfinite(res["value"]) and data < res["value"] < uniform):
        raise AssertionError(f"the MMD is not between data vs data and uniform bits: {out}")
    return out


def phase_fid(ckpt_dir: str, data_path: str, npz: str) -> dict:
    """(c) The eval CLI's FID of [12]'s trained flagship: 256 samples in one
    batch of fused TauL/FID_STEPS (that many launches per eval) against FID_REAL
    stand-in images, with trained and lenet features, each above real vs real (256
    other stand-in images) and below seeded uniform noise, both levels taken
    by the same eval in the same features (`--fid-levels`); then with
    Inception on (a)'s random-weight npz (a check of the pipeline at 299,
    no quality number). The three evals run at once, as three processes
    sharing the card (one after another until phase [15] came; cut for
    time): their wall times are not figures, their values and launch
    counts are each process's own."""
    from concurrent.futures import ThreadPoolExecutor

    common = ["--preset", "tauUnet_mnist", "--ckpt", ckpt_dir, "--metric", "fid",
              "--samples", str(FID_SAMPLES), "--batch", str(FID_SAMPLES), "--n-real",
              str(FID_REAL), "--fid-levels", "--set", "sampler.use_fused_update=True",
              f"sampler.num_steps={FID_STEPS}", f"data.location={data_path}"]
    want = {"fused_tau_leap_update": FID_STEPS, "reverse_rates": 0, "euler_posterior": 0}
    out = {}
    kinds = ("trained", "lenet", "inception")
    with ThreadPoolExecutor(len(kinds)) as pool:
        runs = {kind: pool.submit(run_cli, "eval", *common, "--features", kind,
                                  *(["--inception-weights", npz] if kind == "inception" else []))
                for kind in kinds}
    for kind in kinds:
        res = last_json(runs[kind].result())
        out[kind] = dict(fid=res["value"], real_vs_real=res["real_vs_real"], noise=res["noise"],
                         kernel_launches=res["kernel_launches"], step=res["step"])
        log(f"  FID ({kind}) of the model trained {res['step']} steps: {res['value']:.4f}; "
            f"real vs real {res['real_vs_real']:.4f}; uniform noise {res['noise']:.4f}; "
            f"launches {res['kernel_launches']}")
        if res["kernel_launches"] != want:
            raise AssertionError(f"eval fid {kind} launches {res['kernel_launches']}, "
                                 f"expected {want}")
        if not math.isfinite(res["value"]):
            raise AssertionError(f"FID ({kind}) is not finite: {res}")
        if kind != "inception" and not (res["real_vs_real"] < res["value"]
                                        and res["real_vs_real"] < res["noise"]):
            raise AssertionError(f"FID ({kind}) does not order real, model and noise: "
                                 f"{out[kind]}")
    return out


def phase_bench(steps: int) -> dict:
    """(d) The bench CLI at `steps` sampler steps (the protocol's 1000 cut
    for time): its JSON line parses, every rate is positive (the bf16 train
    step's too, with its MFU), and the kernels launched as its runs imply."""
    res = last_json(run_cli("bench", "--set", f"sampler.num_steps={steps}"))
    ex = res["extras"]
    rates = {k: ex[k] for k in ("plain_samples_per_sec", "ctelbo_train_steps_per_sec",
                                "fused_samples_per_sec", "bf16_train_steps_per_sec",
                                "bf16_train_mfu")}
    # a warm-up and three runs of each sampler; one plain step under the FLOP counter
    want = {"fused_tau_leap_update": 4 * steps, "reverse_rates": 4 * steps + 1,
            "euler_posterior": 0}
    log("  bench: " + json.dumps(res))
    if not (res["metric"] == "mnist_taul_samples_per_sec" and res["value"] > 0
            and all(v and v > 0 for v in rates.values())
            and ex["sampler_steps"] == steps):
        raise AssertionError(f"bad bench line: {res}")
    if ex["kernel_launches"] != want:
        raise AssertionError(f"bench launches {ex['kernel_launches']}, expected {want}")
    return res


# ---------------------------------------------------------------------------
# phase 14: the SDDM hollow family, and the flagship's bf16 compute
# ---------------------------------------------------------------------------

LOGIT_FLOOR_MULT = 6.0  # (a) hollow logits, card vs CPU, in units of the CPU's float32 error
HOLLOW_TRAIN_STEPS = 50  # (b)
# (d) and [18](c): MMD rounds of 4096 samples: the protocol's 25; 5 until phase [15]
# came, 3 until [16], 2 until [18]
SYNTH_ROUNDS = 1  # cut for time
BF16_FLOOR_MULT = 2.0  # (e) card bf16 vs f32 logits, in units of the CPU's own bf16 vs f32
BF16_CONTROL_NOISE = 0.01  # (e) the control: weights perturbed by this relative noise


def hollow_cfg(tmpdir: str, data_path: str):
    """`holvisual_mnist` at its full width on the stand-in data."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset("holvisual_mnist")
    cfg.data.location = data_path
    cfg.save_location = f"{tmpdir}/holvisual"
    cfg.sampler.sample_freq = 0
    cfg.saving.checkpoint_freq = HOLLOW_TRAIN_STEPS
    return cfg


def hollow_vs_cpu(dev, cfg, data_path) -> dict:
    """(a) Full-width logits at B=2, card (TF32 off) vs the port's CPU, held
    as [12](a) holds gradients: within LOGIT_FLOOR_MULT times the CPU's own
    float32 error against float64 (share of the largest |logit|). The time
    embedding's sinusoid reaches ~1000 rad at this preset's time scale, so
    float32 rounding there (and the card's exp and sin, ulps apart from the
    CPU's) moves the logits by ~1e-5: the float64 reference computes the
    embedding in float64 too. The same logits with TF32 on are the control
    that must fail. Then one B=4 CatRM step held as [12](a) holds the
    flagship's (`hold_train_step`), x_t drawn once on the CPU."""
    from ctdd_tpu_torch.losses.losses import sample_xt
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.utils.device import tf32, tf32_off

    cpu = create_model(cfg, device="cpu")
    cpu.net.init_weights(torch.Generator().manual_seed(0))
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
        ref64 = OnTables(cpu, cpu, torch.float64).apply(
            {k: v.double() for k, v in cpu.net.state_dict().items()}, x, t)
        with tf32_off():
            got = gpu.apply(gpu.net, x.to(dev), t.to(dev)).cpu()
        with tf32(True):
            got_tf32 = gpu.apply(gpu.net, x.to(dev), t.to(dev)).cpu()
    scale = ref64.abs().max().item()
    floor = (ref.double() - ref64).abs().max().item() / scale
    err = (got - ref).abs().max().item() / scale
    err_tf32 = (got_tf32 - ref).abs().max().item() / scale
    tol = LOGIT_FLOOR_MULT * floor
    log(f"  holvisual_mnist {n_params / 1e6:.3f} M params, logits {tuple(got.shape)}, share "
        f"of the largest |logit| {scale:.3f}: card vs CPU {err:.3e} (tol {tol:.3e} = "
        f"{LOGIT_FLOOR_MULT:g} x the CPU's float32 error {floor:.3e} against float64); "
        f"control, TF32 on: {err_tf32:.3e} (must exceed the tol)")
    if not (got.shape == (2, 784, 256) and math.isfinite(err) and err <= tol):
        raise AssertionError(f"hollow logits on the card differ from the CPU's by {err}")
    if not err_tf32 > tol:
        raise AssertionError(f"the hollow logit limit {tol} passes TF32 logits {err_tf32}")

    x0 = torch.from_numpy(np.load(data_path)["x_train"][:4].reshape(4, -1).astype(np.int32))
    ts = torch.tensor([0.02, 0.1, 0.3, 0.6])
    xt = sample_xt(torch.Generator().manual_seed(0), cpu.transition(ts), x0)
    log(f"  one B=4 {cfg.loss.name} ({cfg.loss.loss_type}, {cfg.loss.logit_type}) step, "
        "card vs CPU")
    step = hold_train_step(cfg, cpu, gpu, catrm_loss(cfg), x0, ts, (xt,), ulp_draws=4)
    return dict(params=n_params, logits_rel_err=err, logits_floor=floor, logits_tol=tol,
                logits_tf32_rel_err=err_tf32, step_vs_cpu=step)


def hollow_training(dev, cfg, data_path) -> dict:
    """(b) HOLLOW_TRAIN_STEPS B=64 steps through train(): a finite loss at
    every step, steps/s, peak memory, and the step's device split."""
    from ctdd_tpu_torch.training.loop import train

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, info = train(cfg, n_iters=HOLLOW_TRAIN_STEPS, seed=0, device=dev, log_every=25)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = np.asarray(info["step_losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    log(f"  {HOLLOW_TRAIN_STEPS} steps at B={cfg.data.batch_size} in {seconds:.1f} s: "
        f"{info['steps_per_sec']:.3f} steps/s steady (first step and checkpoint saves left "
        f"out); peak device memory {peak_gb:.2f} GB; mean loss of the first 10 steps "
        f"{first:.4f}, last 10 {last:.4f}")
    if not np.isfinite(losses).all() or losses.max() >= 1e9:
        raise AssertionError(f"holvisual_mnist: non-finite or skipped losses: {losses.tolist()}")
    log("  step breakdown")
    breakdown = train_step_breakdown(dev, cfg, data_path)
    return dict(checkpoint=f"{info['paths']['checkpoints']}/{HOLLOW_TRAIN_STEPS}.pt",
                record=dict(steps=HOLLOW_TRAIN_STEPS, seconds=seconds,
                            steps_per_s_loop=info["steps_per_sec"], peak_memory_gb=peak_gb,
                            loss_first10=first, loss_last10=last, **breakdown))


def hollow_serving(dev, path: str) -> dict:
    """(c) The trained checkpoint served over HTTP, one batch of 16 (no
    warm-up batch since phase [15] came; cut for time): the preset's CRMLBJF (= LBJF, 1000 steps, the corrector
    off below min_t), so exactly 1000 Euler-posterior launches and none of
    the reverse-rates kernel (the ratio rates are plain torch). First the
    posterior kernel against its plain version on three steps' own inputs."""
    from ctdd_tpu_torch.config.base import Config
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_initial_samples, get_sampler
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

    ckpt = load_checkpoint(path, map_location=dev)
    cfg = Config(ckpt["config"])
    model = create_model(cfg, device=dev)
    model.net.load_state_dict(ckpt["ema_params"])
    model.net.eval()
    sampler = get_sampler(cfg)
    ts, hs = sampler.time_grid()
    steps = len(ts) + sampler.num_corrector_steps * int(
        (ts <= np.float32(sampler.corrector_entry_time)).sum())
    if steps != 1000 or sampler.rate_param != "ratio":
        raise AssertionError(f"holvisual_mnist's sampler: {steps} launches, "
                             f"{sampler.rate_param} rates")
    x = get_initial_samples(torch.Generator(device=dev).manual_seed(0), 16, 784, 256,
                            cfg.sampler.initial_dist, cfg.model.Q_sigma, device=dev)
    worst = dict(post_prob=0.0, post_log=0.0)
    with torch.inference_mode():
        for i in (0, 500, 999):
            hold_posterior(f"holvisual_mnist N=16 step {i} of the grid",
                           sampler._rev_rates(model, model.net, x, float(ts[i])), x,
                           float(hs[i]), worst, "ratio rates (plain torch); ")
    launches, elapsed = serve_checkpoint(
        dev, f"holvisual_mnist trained {HOLLOW_TRAIN_STEPS} steps", cfg, path, 16,
        {"euler_posterior": steps}, warmup=False)
    return dict(launches=launches, seconds=elapsed, samples_per_s=16 / elapsed, warm=False,
                posterior_vs_plain=worst)


def _full_scale_unet(cfg, dev):
    """The flagship with its init, but the 1e-10 convolutions and the zero
    attention projection drawn at full scale, so every layer moves the
    logits (at the init they would be ~0)."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.networks.unet import _vs_uniform_

    model = create_model(cfg, device=dev)
    gen = torch.Generator().manual_seed(0)
    model.net.init_weights(gen)
    unet = model.net.unet
    with torch.no_grad():
        for w in [b.conv_1.weight for b in unet.res_blocks] + [unet.conv_1.weight] + \
                [a.proj.weight for a in unet.attns]:
            draw = torch.empty(w.shape)
            _vs_uniform_(draw, gen)
            w.copy_(draw)
    model.net.eval()
    return model


def bf16_check(dev, data_path, f32_breakdown) -> dict:
    """(e) The flagship's bf16 logits against its float32 logits on the
    card, on the same full-scale weights and four stand-in images: within
    BF16_FLOOR_MULT times the CPU's own bf16 vs float32 distance on the same
    weights and inputs (the CPU's bf16 path is held to JAX's in
    tests/test_torch_unet.py); the control, float32 logits of the weights
    perturbed by BF16_CONTROL_NOISE relative noise, must exceed it. Then the
    bf16 train step's breakdown at B=64 beside [12](b)'s float32 one."""
    from ctdd_tpu_torch.config.base import Config
    from ctdd_tpu_torch.utils.device import tf32_off

    cfg32 = full_cfg(fused=True)
    cfg16 = Config(cfg32.to_dict())
    cfg16.model.compute_dtype = "bfloat16"
    x = torch.from_numpy(np.load(data_path)["x_train"][:4].reshape(4, -1).astype(np.int32))
    t = torch.tensor([0.1, 0.3, 0.6, 0.9])
    logits = {}
    for where in ("cpu", dev):
        m32 = _full_scale_unet(cfg32, where)
        m16 = _full_scale_unet(cfg16, where)
        with torch.inference_mode(), tf32_off():
            logits[str(where), 32] = m32.apply(m32.net, x.to(where), t.to(where)).cpu()
            logits[str(where), 16] = m16.apply(m16.net, x.to(where), t.to(where)).cpu()
            if where != "cpu":
                gen = torch.Generator(device=dev).manual_seed(1)
                noisy = {k: v * (1 + BF16_CONTROL_NOISE * torch.randn(
                    v.shape, generator=gen, device=dev)) for k, v in m32.net.state_dict().items()}
                logits["control"] = m32.apply(noisy, x.to(dev), t.to(dev)).cpu()
    card, ref = logits[str(dev), 32], logits[str(dev), 16]
    scale = card.abs().max().item()
    cpu_gap = (logits["cpu", 16] - logits["cpu", 32]).abs().max().item() / scale
    card_gap = (ref - card).abs().max().item() / scale
    control = (logits["control"] - card).abs().max().item() / scale
    f32_cards = (card - logits["cpu", 32]).abs().max().item() / scale
    tol = BF16_FLOOR_MULT * cpu_gap
    log(f"  bf16 vs float32 logits, share of the largest |logit| {scale:.3f}: card "
        f"{card_gap:.3e} (tol {tol:.3e} = {BF16_FLOOR_MULT:g} x the CPU's {cpu_gap:.3e}); "
        f"control, float32 with the weights {BF16_CONTROL_NOISE:g} off: {control:.3e} (must "
        f"exceed the tol); float32 card vs CPU {f32_cards:.3e}")
    if not (torch.isfinite(ref).all() and card_gap <= tol and card_gap > 0):
        raise AssertionError(f"bf16 logits on the card: {card_gap} (tol {tol})")
    if not control > tol:
        raise AssertionError(f"the bf16 limit {tol} passes the control {control}")
    log("  bf16 train step breakdown (B=64)")
    breakdown = train_step_breakdown(dev, cfg16, data_path)
    return dict(card_bf16_vs_f32=card_gap, cpu_bf16_vs_f32=cpu_gap, tol=tol,
                control=control, control_noise=BF16_CONTROL_NOISE, f32_card_vs_cpu=f32_cards,
                train_step_bf16=breakdown,
                train_step_f32={k: f32_breakdown[k] for k in (
                    "step_ms", "steps_per_s", "device_busy_ms", "network_fwd_bwd_ms",
                    "loss_ms", "optimizer_ema_ms", "idle_share")})


def phase_hollow(dev, tmpdir: str, data_path: str, f32_breakdown: dict) -> dict:
    """Phase [14]: (a)-(c) `holvisual_mnist` at full width, (d) the
    synthetic hollow and Bert presets through the CLIs, (e) bf16."""
    t0 = time.perf_counter()
    cfg = hollow_cfg(tmpdir, data_path)
    log("  (a) holvisual_mnist, card vs CPU")
    vs_cpu = hollow_vs_cpu(dev, cfg, data_path)
    log(f"  (b) train() {HOLLOW_TRAIN_STEPS} steps")
    trained = hollow_training(dev, cfg, data_path)
    log("  (c) serving the trained checkpoint")
    served = hollow_serving(dev, trained["checkpoint"])
    log(f"  (d) hollow_synthetic and bert_synthetic through the CLIs, MMD at "
        f"{SYNTH_ROUNDS} x 4096 (both train CLIs at once, then both evals, sharing the "
        "card: cut for time, so their steps/s are not figures)")
    from concurrent.futures import ThreadPoolExecutor

    presets = ("hollow_synthetic", "bert_synthetic")
    with ThreadPoolExecutor(len(presets)) as pool:
        runs = {p: pool.submit(train_cli, tmpdir, p) for p in presets}
        # the two evals at once too (since phase [16] came)
        synthetic = {p: pool.submit(cli_mmd, dev, tmpdir, p, rounds=SYNTH_ROUNDS,
                                    trained=runs[p].result()) for p in presets}
        synthetic = {p: r.result() for p, r in synthetic.items()}
    log("  (e) bf16 compute of the flagship")
    bf16 = bf16_check(dev, data_path, f32_breakdown)
    seconds = time.perf_counter() - t0
    log(f"  phase [14]: {seconds:.1f} s")
    return dict(vs_cpu=vs_cpu, training=trained["record"], serving=served,
                synthetic=synthetic, bf16=bf16, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 15: the maze, sudoku and protein presets
# ---------------------------------------------------------------------------

SUDOKU_TRAIN_STEPS = 101  # (c): 100 steps an epoch: the async swap at 100
# (c): a pool every epoch, generated on the background thread (the preset's
# every 4 epochs, with the swap at step 400, until phase [16] came: cut for time)
SUDOKU_STREAM = ("data.stream_refresh_period=1", "data.stream_async=True")
MAZE_TRAIN_STEPS = 101  # (d): 100 steps an epoch: the synchronous swap at 100
FAMILY_STEPS = 25  # (e) hollow_maze and hollow_protein (50 until phase [17] came)
SHORT_STEPS = 5  # (e) protein_maze, bert_maze, hollow_maze_distr
MASKED_STEPS = 2  # (e) bert_mazemasked, 225 masked passes a step (5 until [16] came)
DETERMINISM_STEPS = 20  # [16](e)


def pool_digest(pool) -> str:
    """The digest the training loop prints for a pool it swaps in."""
    import hashlib

    flat = np.asarray(pool).reshape(len(pool), -1).astype(np.int32)
    return hashlib.sha256(flat.tobytes()).hexdigest()[:16]


def data_pools() -> dict:
    """(a) The port's C++ generators built from ctdd_tpu_torch/csrc/
    datagen.cpp on this host; Maze3S's 6400-maze and SudokuDataset's
    12800-board pools of the presets, timed; every maze its own shortest
    path and every board a valid solution; `regenerate(1)` differs from pool
    0, and a second instance's `regenerate(1)` equals the first's."""
    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.data import native
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.data.maze import maze_acc
    from ctdd_tpu_torch.data.sudoku import sudoku_acc

    t0 = time.perf_counter()
    lib = native.build()
    log(f"  {lib.name} built from {native.SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    out, datasets = {}, {}
    for preset, acc in (("tauUnet_maze", maze_acc), ("sudoku", sudoku_acc)):
        cfg = get_preset(preset)
        t0 = time.perf_counter()
        ds = get_dataset(cfg)
        gen_s = time.perf_counter() - t0
        pool0 = ds.data.copy()
        t0 = time.perf_counter()
        value = acc(pool0)
        acc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool1 = ds.regenerate(1).copy()
        regen_s = time.perf_counter() - t0
        again = get_dataset(cfg).regenerate(1)
        out[preset] = dict(dataset=cfg.data.name, shape=list(pool0.shape),
                           pool_seconds=gen_s, regenerate_seconds=regen_s,
                           accuracy=value, accuracy_seconds=acc_s)
        log(f"  {cfg.data.name} ({preset}): pool {tuple(pool0.shape)} in {gen_s:.3f} s, "
            f"regenerate(1) {regen_s:.3f} s; {acc.__name__} {value} ({acc_s:.2f} s)")
        if value != 1.0:
            raise AssertionError(f"{cfg.data.name}: {acc.__name__} of the pool is {value}")
        if np.array_equal(pool1, pool0) or not np.array_equal(again, pool1):
            raise AssertionError(f"{cfg.data.name}: regenerate(1) is pool 0, or not seeded")
        datasets[preset] = ds
    return dict(record=out, datasets=datasets)


def nll_loss(cfg):
    """NLLOriginal on an injected x_t, dropout off."""
    from ctdd_tpu_torch.utils.math import mean_cross_entropy

    def fn(model, p, x0, ts, draws):
        (xt,) = draws
        return mean_cross_entropy(model.apply(p, xt, ts), x0)
    return fn


def ddsm_vs_cpu(dev, preset: str, x0: np.ndarray) -> dict:
    """(b) Full-width logits at B=4, card (TF32 off) vs the port's CPU, held
    as [14](a) holds the hollow logits (LOGIT_FLOOR_MULT times the CPU's own
    float32 error against a float64 copy of the network), with TF32 on as
    the control that must fail; then one B=4 step of the preset's loss
    (NLLOriginal for sudoku, CTElbo for protein_maze) on draws made once on
    the CPU, held as [12](a) holds the flagship's (`hold_train_step`, the
    times one ulp off in 4 draws; the Fourier projection's arguments reach
    hundreds of rad). The tables are reported, not held: both sides of the
    step run on the CPU's."""
    import copy

    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.losses.losses import sample_xt, sample_xt_xtilde
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.utils.device import tf32, tf32_off

    cfg = get_preset(preset)
    cpu = create_model(cfg, device="cpu")
    cpu.net.init_weights(torch.Generator().manual_seed(0))
    cpu.net.eval()
    gpu = create_model(cfg, device=dev)
    gpu.net.load_state_dict(cpu.net.state_dict())
    gpu.net.eval()
    net64 = copy.deepcopy(cpu.net).double()
    n_params = sum(p.numel() for p in gpu.net.parameters())
    D, S = cfg.model.concat_dim, cfg.data.S
    x = torch.from_numpy(np.random.default_rng(0).integers(0, S, (4, D)).astype(np.int32))
    t = torch.tensor([0.05, 0.3, 0.6, 0.95])
    with torch.inference_mode():
        ref = cpu.apply(cpu.net, x, t)
        ref64 = net64(x, t.double())
        with tf32_off():
            got = gpu.apply(gpu.net, x.to(dev), t.to(dev)).cpu()
        with tf32(True):
            got_tf32 = gpu.apply(gpu.net, x.to(dev), t.to(dev)).cpu()
    scale = ref64.abs().max().item()
    floor = (ref.double() - ref64).abs().max().item() / scale
    err = (got - ref).abs().max().item() / scale
    err_tf32 = (got_tf32 - ref).abs().max().item() / scale
    tol = LOGIT_FLOOR_MULT * floor
    log(f"  {preset} ({type(gpu.net).__name__}, embed {cfg.model.embed_dim}, D={D}, S={S}) "
        f"{n_params / 1e6:.3f} M params, logits {tuple(got.shape)}, share of the largest "
        f"|logit| {scale:.3f}: card vs CPU {err:.3e} (tol {tol:.3e} = {LOGIT_FLOOR_MULT:g} x "
        f"the CPU's float32 error {floor:.3e}); control, TF32 on: {err_tf32:.3e} (must "
        f"exceed the tol)")
    if not (got.shape == (4, D, S) and math.isfinite(err) and err <= tol):
        raise AssertionError(f"{preset} logits on the card differ from the CPU's by {err}")
    if not err_tf32 > tol:
        raise AssertionError(f"the {preset} logit limit {tol} passes TF32 logits {err_tf32}")

    x0 = torch.from_numpy(np.asarray(x0[:4]).reshape(4, -1).astype(np.int32))
    ts = torch.tensor([0.02, 0.1, 0.3, 0.6])
    gen = torch.Generator().manual_seed(0)
    if cfg.loss.name == "NLLOriginal":
        loss_fn, draws = nll_loss(cfg), (sample_xt(gen, cpu.transition(ts), x0),)
    else:
        loss_fn = ctelbo_loss(cfg)
        draws = sample_xt_xtilde(gen, cpu.transition(ts), cpu.rate(ts), x0)
    log(f"  one B=4 {cfg.loss.name} step, card vs CPU")
    step = hold_train_step(cfg, cpu, gpu, loss_fn, x0, ts, draws, ulp_draws=4,
                           hold_tables=False)
    return dict(params=n_params, logits_rel_err=err, logits_floor=floor, logits_tol=tol,
                logits_tf32_rel_err=err_tf32, step_vs_cpu=step)


def swap_line(lines: list, epoch: int, step: int) -> dict:
    """The training loop's line for the pool of `epoch` swapped in at
    `step`: the seconds it waited for the generator and the pool's digest."""
    import re

    for line in lines:
        m = re.match(rf"pool of epoch {epoch} from step {step}: waited (\S+) s for the "
                     r"generator, sha256 (\w+)$", line)
        if m:
            return dict(epoch=epoch, step=step, waited_s=float(m.group(1)),
                        digest=m.group(2))
    raise AssertionError(f"no swap to the pool of epoch {epoch} at step {step}")


def cli_train_and_score(dev, tmpdir: str, preset: str, steps: int, pool_ds, epoch: int,
                        metric: str, samples: int, *sets) -> dict:
    """`preset` trained `steps` steps by the train CLI at the preset's batch
    (with `sets`, more `--set` pairs), across the pool swap of `epoch`
    (every `data.stream_refresh_period` epochs): the pool trained on after it must be
    `pool_ds.regenerate(epoch)` (digest printed by the loop); then the eval
    CLI's `metric` on `samples` samples of the preset's sampler (EMA
    weights, one batch), with its exact launch counts."""
    import re

    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    cfg = get_preset(preset)
    lines = run_cli("train", "--preset", preset, "--iters", str(steps), "--set",
                    f"save_location={tmpdir}/{preset}_cli", *sets)
    m = re.search(r"steps/sec=(\S+) run=(\S+)$", lines[-1])
    train_rate, ckpt_dir = float(m.group(1)), f"{m.group(2)}/checkpoints"
    boundary = epoch * (cfg.data.num_samples // cfg.data.batch_size)
    swap = swap_line(lines, epoch, boundary)
    want_digest = pool_digest(pool_ds.regenerate(epoch))
    log(f"  {lines[-1]}; the pool of epoch {epoch} swapped in at step {boundary} after "
        f"waiting {swap['waited_s']:.3f} s for the generator; digest {swap['digest']} "
        f"(regenerate({epoch}): {want_digest})")
    if swap["digest"] != want_digest:
        raise AssertionError(f"{preset}: the pool trained on from step {boundary} is not "
                             f"regenerate({epoch})")
    sampler = get_sampler(cfg)
    ts, _ = sampler.time_grid()
    per_batch = len(ts) + sampler.num_corrector_steps * int(
        (ts <= np.float32(sampler.corrector_entry_time)).sum())
    res = last_json(run_cli("eval", "--preset", preset, "--ckpt", ckpt_dir, "--metric",
                            metric, "--samples", str(samples)))
    want = {"fused_tau_leap_update": 0,
            "reverse_rates": per_batch if sampler.rate_param == "p0t" else 0,
            "euler_posterior": per_batch}
    log(f"  {preset}: {metric} of {samples} samples after {steps} steps {res['value']:.4f}; "
        f"launches {res['kernel_launches']} (expected {want})")
    if res["kernel_launches"] != want:
        raise AssertionError(f"eval {metric} {preset} launches {res['kernel_launches']}, "
                             f"expected {want}")
    if not 0.0 <= res["value"] <= 1.0:
        raise AssertionError(f"eval {metric} {preset}: {res['value']}")
    return dict(preset=preset, steps=steps, train_steps_per_s=train_rate, swap=swap,
                metric=metric, value=res["value"], samples=samples, sampler=cfg.sampler.name,
                sampler_steps=len(ts), kernel_launches=res["kernel_launches"],
                expected_launches=want)


def family_cfg(tmpdir: str, preset: str):
    """`preset` at its full width and batch, no in-loop grid, its protein
    pool the seeded stand-in."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset(preset)
    cfg.save_location = f"{tmpdir}/{preset}"
    cfg.sampler.sample_freq = 0
    cfg.saving.checkpoint_freq = FAMILY_STEPS
    if cfg.data.name.startswith("Protein"):
        cfg.data.location = f"{tmpdir}/absent_grampa.npy"
    if cfg.data.name == "LakhPianoroll":
        cfg.data.location = f"{tmpdir}/absent_lakh.npy"
    return cfg


def train_family(dev, tmpdir: str, preset: str, steps: int) -> tuple:
    """`steps` steps of `preset` through train(): finite losses, steps/s,
    peak memory."""
    from ctdd_tpu_torch.training.loop import train

    cfg = family_cfg(tmpdir, preset)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, info = train(cfg, n_iters=steps, seed=0, device=dev, log_every=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = np.asarray(info["step_losses"])
    rec = dict(preset=preset, loss=cfg.loss.name, batch=cfg.data.batch_size, steps=steps,
               seconds=seconds, steps_per_s_loop=info["steps_per_sec"],
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               params=sum(v.numel() for v in state.params.values()),
               loss_first=float(losses[0]), loss_last=float(losses[-1]))
    log(f"  {preset} ({cfg.model.name}, {cfg.loss.name}, {rec['params'] / 1e6:.2f} M params) "
        f"{steps} steps at B={cfg.data.batch_size} in {seconds:.1f} s: "
        f"{info['steps_per_sec']:.2f} steps/s; peak {rec['peak_memory_gb']:.2f} GB; loss "
        f"{rec['loss_first']:.4f} -> {rec['loss_last']:.4f}")
    if not np.isfinite(losses).all() or losses.max() >= 1e9:
        raise AssertionError(f"{preset}: non-finite or skipped losses: {losses.tolist()}")
    return cfg, state, info, rec


def family(dev, tmpdir: str) -> dict:
    """(e) hollow_maze (ScoreElbo, ratio path) trained FAMILY_STEPS steps and
    its checkpoint served over HTTP (LBJF/750: exactly 750 posterior
    launches, none of the reverse rates); hollow_protein (CatRM, S=21, D=48)
    trained FAMILY_STEPS steps and one batch of 16 sampled (LBJF/100:
    exactly 100 posterior launches at S=21); four more presets SHORT_STEPS
    steps each at full width."""
    from ctdd_tpu_torch.ops import kernel_wrappers
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    out = {}
    cfg, _, info, out["hollow_maze"] = train_family(dev, tmpdir, "hollow_maze", FAMILY_STEPS)
    steps = len(get_sampler(cfg).time_grid()[0])
    launches, elapsed = serve_checkpoint(
        dev, f"hollow_maze trained {FAMILY_STEPS} steps", cfg,
        f"{info['paths']['checkpoints']}/{FAMILY_STEPS}.pt", 16, {"euler_posterior": steps},
        warmup=False)
    out["hollow_maze"].update(served_launches=launches, served_seconds=elapsed,
                              served_samples_per_s=16 / elapsed, sampler_steps=steps)

    cfg, state, info, out["hollow_protein"] = train_family(dev, tmpdir, "hollow_protein",
                                                           FAMILY_STEPS)
    sampler = get_sampler(cfg)
    steps = len(sampler.time_grid()[0])
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    samples, _ = sampler.sample(info["model"], state.ema_params,
                                torch.Generator(device=dev).manual_seed(0), 16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    want = {"fused_tau_leap_update": 0, "reverse_rates": 0, "euler_posterior": steps}
    log(f"  hollow_protein: one batch of 16, {cfg.sampler.name}/{steps} at S={cfg.data.S}, "
        f"in {seconds:.2f} s; launches {launches} (expected {want}); values in "
        f"[{samples.min()}, {samples.max()}]")
    if launches != want or samples.shape != (16, 48) or samples.min() < 0 \
            or samples.max() >= cfg.data.S:
        raise AssertionError(f"hollow_protein sampling: launches {launches}, samples "
                             f"{samples.shape} in [{samples.min()}, {samples.max()}]")
    out["hollow_protein"].update(sampled_launches=launches, sample_seconds=seconds,
                                 sampler_steps=steps)
    for preset in ("protein_maze", "bert_maze", "bert_mazemasked", "hollow_maze_distr"):
        out[preset] = train_family(dev, tmpdir, preset,
                                   MASKED_STEPS if preset == "bert_mazemasked" else SHORT_STEPS)[3]
    return out


def named_nondeterministic(dev, cfg, pool) -> list:
    """The ops PyTorch names non-deterministic in one train step of `cfg`
    (`use_deterministic_algorithms(warn_only=True)`, scoped)."""
    import warnings

    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import make_device_data_step

    model = create_model(cfg, device=dev)
    model.net.init_weights(torch.Generator().manual_seed(0))
    tx = get_optimizer(cfg)
    state = create_train_state(dict(model.net.named_parameters()), tx)
    step = make_device_data_step(model, get_loss(cfg), tx, cfg.data.batch_size,
                                 ema_decay=float(cfg.model.ema_decay))
    data = torch.from_numpy(np.asarray(pool).reshape(len(pool), -1).astype(np.int32)).to(dev)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, data, 0)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0].strip()[:100]
                   for w in caught if "deterministic" in str(w.message)})


def determinism_runs(dev, tmpdir: str, data_path: str, pools: dict) -> dict:
    """[16](e) Two train() runs from one seed, DETERMINISM_STEPS steps each,
    must end with every parameter bit-identical: the flagship, sudoku,
    hollow_maze (memory-efficient attention, whose backward added with
    atomics until train() ran PyTorch's deterministic algorithms) and
    pianoroll_cond (the sequence transformer); each run's steps/s (beside
    [16]'s evals: not figures). Where they differ, the ops PyTorch names
    non-deterministic in their step."""
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.training.loop import train

    out = {}
    for preset in ("tauUnet_mnist", "sudoku", "hollow_maze", "pianoroll_cond"):
        ends, rates = [], []
        for run in ("a", "b"):
            if preset == "tauUnet_mnist":
                cfg = train_cfg(tmpdir, data_path, f"det_{run}")
                cfg.sampler.sample_freq = 0
            else:
                cfg = family_cfg(tmpdir, preset)
                cfg.save_location = f"{tmpdir}/det_{preset}_{run}"
            state, info = train(cfg, n_iters=DETERMINISM_STEPS, seed=0, device=dev,
                                log_every=DETERMINISM_STEPS)
            ends.append(state.params)
            rates.append(info["steps_per_sec"])
        differ = sorted(k for k in ends[0] if not torch.equal(ends[0][k], ends[1][k]))
        named = []
        if differ:
            pool = pools["sudoku"].data if preset == "sudoku" else \
                pools["tauUnet_maze"].data if preset == "hollow_maze" else \
                np.load(data_path)["x_train"] if preset == "tauUnet_mnist" else \
                get_dataset(cfg).data
            named = named_nondeterministic(dev, cfg, pool)
        out[preset] = dict(steps=DETERMINISM_STEPS, batch=cfg.data.batch_size,
                           leaves=len(ends[0]), differ_count=len(differ),
                           differ_first=differ[:6], named_nondeterministic_ops=named,
                           steps_per_s=rates)
        log(f"  {preset}: two train() runs of {DETERMINISM_STEPS} steps from seed 0 at "
            f"B={cfg.data.batch_size} ({rates[0]:.2f} and {rates[1]:.2f} steps/s), leaves "
            f"that differ bit for bit: {len(differ)} of {len(ends[0])}"
            + (f" ({differ[:6]}{' ...' if len(differ) > 6 else ''}; ops PyTorch names "
               f"non-deterministic: {named})" if differ else ""))
    bad = {p: r["differ_count"] for p, r in out.items() if r["differ_count"]}
    if bad:
        raise AssertionError(f"two train() runs differ: {bad}")
    return out


def phase_maze_sudoku(dev, tmpdir: str, data_path: str) -> dict:
    """Phase [15]: (a) the data generators and pools, (b) the DDSM networks
    card vs CPU, (c) sudoku and (d) tauUnet_maze through the train and eval
    CLIs across a pool swap, (e) the rest of the family. Returns the record
    and the pools' datasets (for [16](e))."""
    t0 = time.perf_counter()
    log("  (a) the C++ generators and the pools")
    pools = data_pools()
    log("  (b) the DDSM networks, card vs CPU")
    vs_cpu = {"sudoku": ddsm_vs_cpu(dev, "sudoku", pools["datasets"]["sudoku"].data),
              "protein_maze": ddsm_vs_cpu(dev, "protein_maze",
                                          pools["datasets"]["tauUnet_maze"].data)}
    from concurrent.futures import ThreadPoolExecutor

    from ctdd_tpu_torch.config.presets import get_preset

    log(f"  (c) sudoku: the train CLI {SUDOKU_TRAIN_STEPS} steps, the eval CLI's "
        f"sudoku_acc; (d) tauUnet_maze: the train CLI {MAZE_TRAIN_STEPS} steps, the eval "
        "CLI's maze_acc (both at once, sharing the card since phase [16] came: their CLI "
        "steps/s are not figures)")
    with ThreadPoolExecutor(2) as pool:
        sudoku = pool.submit(cli_train_and_score, dev, tmpdir, "sudoku", SUDOKU_TRAIN_STEPS,
                             pools["datasets"]["sudoku"], 1, "sudoku_acc", 256,
                             *SUDOKU_STREAM)
        maze = pool.submit(cli_train_and_score, dev, tmpdir, "tauUnet_maze",
                           MAZE_TRAIN_STEPS, pools["datasets"]["tauUnet_maze"], 1,
                           "maze_acc", 64)
        sudoku, maze = sudoku.result(), maze.result()
    log("  sudoku step breakdown")
    sudoku["train_step"] = train_step_breakdown(dev, get_preset("sudoku"),
                                                pools["datasets"]["sudoku"].data)
    log("  (e) the rest of the family")
    rest = family(dev, tmpdir)
    seconds = time.perf_counter() - t0
    log(f"  phase [15]: {seconds:.1f} s")
    return dict(data=pools["record"], vs_cpu=vs_cpu, sudoku=sudoku, maze=maze, family=rest,
                seconds=seconds), pools["datasets"]


# ---------------------------------------------------------------------------
# phase 16: the rest of the samplers, the EBM and the prefix-conditional path
# ---------------------------------------------------------------------------

COND_TRAIN_STEPS = 200  # (a): pianoroll_cond by the train CLI (the preset's 20000, cut)
COND_SAMPLES = 64  # (a): cond_mmd's n, ConditionalTauLeaping/1000
COND_LBJF_BATCH = 16  # (a): one ConditionalLBJF batch
EBM_TRAIN_STEPS = 300  # (b): ebm_synthetic by the train CLI (the preset's 3000, cut)
EBM_ROUNDS, EBM_SAMPLES = 3, 256  # (b): the JAX README's EBM protocol (the reference's 25 x 4096)
UNIFORM_SEEDS = 20  # (b): the uniform-bits level, mean and std over this many eval seeds
UNIFORM_SPREAD = 3.0  # (b): ExactSampling's ceiling, in std above the uniform-bits mean
# (b): ExactSampling's eval, 100 of the preset's 750 steps (750 until phase [17] came)
EXACT_STEPS = 100
PC_STEPS = 100  # (c): PCTauL and TAULStepSize on the flagship (1000; 200 before [17])
PC_ENTRY, PC_CORRECTOR_STEPS = 0.1, 2  # (c): a live corrector
# (d): the EBM readout's bias: the loss sees energy differences only
EBM_INVARIANT = ("MaskedTransformer_0.MLP_0.Dense_1.bias",)


def counted(fn):
    """(fn()'s result, each kernel's launches during it): every counter is
    set to 0 just before and read just after."""
    from ctdd_tpu_torch.ops import kernel_wrappers

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def seeded_pair(cfg, dev, with64: bool = True):
    """The preset's model on the CPU and on the card with the weights
    train(seed=0) starts from, eval mode; and a float64 copy of the CPU's
    network (`with64`, else None)."""
    import copy

    from ctdd_tpu_torch.models.base import create_model

    cpu = create_model(cfg, device="cpu")
    cpu.net.init_weights(torch.Generator().manual_seed(0))
    cpu.net.eval()
    gpu = create_model(cfg, device=dev)
    gpu.net.load_state_dict(cpu.net.state_dict())
    gpu.net.eval()
    return cpu, gpu, copy.deepcopy(cpu.net).double() if with64 else None


def hold_vs_cpu(label: str, run) -> dict:
    """`run(where, dtype)` -> a CPU tensor: the CPU in float32 and float64,
    the card in float32 with TF32 off, held as [14](a) holds the hollow
    logits (within LOGIT_FLOOR_MULT times the CPU's own float32 error
    against float64, as shares of the largest |value|); the card with TF32
    on is the control that must fail."""
    from ctdd_tpu_torch.utils.device import tf32, tf32_off

    with torch.inference_mode():
        ref, ref64 = run("cpu", torch.float32), run("cpu", torch.float64)
        with tf32_off():
            got = run("cuda", torch.float32)
        with tf32(True):
            got_tf32 = run("cuda", torch.float32)
    scale = ref64.abs().max().item()
    floor = (ref.double() - ref64).abs().max().item() / scale
    err = (got - ref).abs().max().item() / scale
    err_tf32 = (got_tf32 - ref).abs().max().item() / scale
    tol = LOGIT_FLOOR_MULT * floor
    log(f"  {label} {tuple(got.shape)}, share of the largest |value| {scale:.3f}: card vs "
        f"CPU {err:.3e} (tol {tol:.3e} = {LOGIT_FLOOR_MULT:g} x the CPU's float32 error "
        f"{floor:.3e}); control, TF32 on: {err_tf32:.3e} (must exceed the tol)")
    if not (got.shape == ref.shape and math.isfinite(err) and err <= tol):
        raise AssertionError(f"{label}: card vs CPU {err} above {tol}")
    if not err_tf32 > tol:
        raise AssertionError(f"{label}: the limit {tol} passes TF32 values {err_tf32}")
    return dict(rel_err=err, floor=floor, tol=tol, tf32_rel_err=err_tf32)


def hold_steps(label: str, step, x0, noises, others, launches: dict) -> dict:
    """`step(where, x, i, noise)` -> the next state: K steps from x0 on the
    CPU and on the card (TF32 off) with the same injected noise, each card
    step from the CPU's state. The states that differ stay within
    STEP_FLIP_FRAC (ties under the logits' ~1e-6 card-vs-CPU difference);
    the control, the card's steps with the noise `others` of another draw,
    must differ by more. `launches` is each kernel's exact count over the
    card's K steps."""
    from ctdd_tpu_torch.utils.device import tf32_off

    xc, flips, control, moved = x0.clone(), 0, 0, 0
    got = {}
    with torch.inference_mode(), tf32_off():
        for i in range(len(noises)):
            nxt = step("cpu", xc, i, noises[i])
            (xd, counts) = counted(lambda: step("cuda", xc, i, noises[i]))
            for k, v in counts.items():
                got[k] = got.get(k, 0) + v
            xo = step("cuda", xc, i, others[i])
            flips += int((xd.cpu() != nxt).sum())
            control += int((xo.cpu() != nxt).sum())
            moved += int((nxt != xc).sum())
            xc = nxt
    n = len(noises) * x0.numel()
    out = dict(states=n, differ=flips, control_differ=control, moved=moved / n,
               tol=STEP_FLIP_FRAC * n, launches=got)
    log(f"  {label}: {len(noises)} steps card vs CPU, {flips} of {n} states differ (tol "
        f"{out['tol']:.1f}; moved {out['moved']:.3f}); control, other noise: {control} "
        f"differ (must exceed the tol); card launches {got} (expected {launches})")
    if flips > out["tol"] or not control > out["tol"]:
        raise AssertionError(f"{label}: {out}")
    if got != launches:
        raise AssertionError(f"{label}: launches {got}, expected {launches}")
    return out


def injected_loss(cfg):
    """The preset's loss on injected times and draws, dropout off."""
    from ctdd_tpu_torch.losses.losses import get_loss

    loss = get_loss(cfg)

    def fn(model, p, x0, ts, draws):
        return loss.calc_loss(model, p, None, x0, train=False, ts=ts, samples=draws)
    return fn


def slice8_vs_cpu(dev) -> dict:
    """(d) Card against CPU: the sequence transformer's logits and key logits
    at pianoroll_cond's width; the EBM's energies and both mutation
    enumerators' logits at ebm_synthetic's (`hold_vs_cpu`); one step of
    CondCTElbo, CondNLL with the key head and BinEBMAux (`hold_train_step`,
    the times one ulp off in 2 draws); K steps of PCTauL (the flagship,
    with its corrector), ExactSampling (the EBM) and ConditionalTauLeaping
    (pianoroll_cond) with injected noise (`hold_steps`)."""
    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.data.pianoroll import generate_standin
    from ctdd_tpu_torch.losses.losses import (
        bin_ebm_flip_logits, ebm_all_mutation_logits, sample_xt, sample_xt_xtilde,
    )
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    out = {}
    g = np.random.default_rng(16)
    pcfg = get_preset("pianoroll_cond")
    pcfg.model.aux_key_classes, pcfg.loss.aux_key_weight = 12, 0.5
    L, P, S = pcfg.data.shape[0], pcfg.sampler.condition_dim, pcfg.data.S
    cpu, gpu, net64 = seeded_pair(pcfg, dev)
    seqs = torch.from_numpy(generate_standin(4, L, seed=1))
    x, t = seqs[:2], torch.tensor([0.3, 0.9])
    n_params = sum(p.numel() for p in gpu.net.parameters())
    log(f"  pianoroll_cond SequenceTransformer with the key head: {n_params / 1e6:.3f} M "
        "params")

    def seq(part):
        def run(where, dtype):
            if where == "cpu":
                net = cpu.net if dtype == torch.float32 else net64
                return net(x, t.to(dtype), return_aux=True)[part]
            return gpu.net(x.to(dev), t.to(dev), return_aux=True)[part].cpu()
        return run

    out["sequence_logits"] = hold_vs_cpu("sequence transformer logits", seq(0))
    out["sequence_key_logits"] = hold_vs_cpu("sequence transformer key logits", seq(1))
    ts = torch.tensor([0.1, 0.6])
    draws = sample_xt_xtilde(torch.Generator().manual_seed(0), cpu.transition(ts),
                             cpu.rate(ts), seqs[2:, P:])
    for name in ("CondCTElbo", "CondNLL"):
        pcfg.loss.name = name
        log(f"  one B=2 {name} step{' with the key head' if name == 'CondNLL' else ''}, "
            "card vs CPU")
        out[f"{name}_step"] = hold_train_step(pcfg, cpu, gpu, injected_loss(pcfg), seqs[2:],
                                              ts, draws, ulp_draws=2, hold_tables=False,
                                              float64_tol=FLOAT64_GRAD_TOL)

    ecfg = get_preset("ebm_synthetic")
    ED = ecfg.model.concat_dim
    ecpu, egpu, enet64 = seeded_pair(ecfg, dev)
    bits = torch.from_numpy(g.integers(0, 2, (4, ED)).astype(np.int32))
    et = torch.tensor([0.05, 0.3, 0.6, 0.95])
    log(f"  ebm_synthetic BinaryTransformerScoreFunc: "
        f"{sum(p.numel() for p in egpu.net.parameters()) / 1e6:.3f} M params")

    def ebm(fn):
        def run(where, dtype):
            if where == "cpu":
                net = ecpu.net if dtype == torch.float32 else enet64
                return fn(ecpu, net, bits, et.to(dtype))
            return fn(egpu, egpu.net, bits.to(dev), et.to(dev)).cpu()
        return run

    out["ebm_energies"] = hold_vs_cpu("EBM energies", ebm(
        lambda m, net, xx, tt: m.apply(net, xx, tt)))
    out["ebm_all_mutation_logits"] = hold_vs_cpu("EBM all-mutation logits", ebm(
        lambda m, net, xx, tt: ebm_all_mutation_logits(m, net, xx, tt, 2)))
    out["ebm_bit_flip_logits"] = hold_vs_cpu("EBM bit-flip logits", ebm(
        lambda m, net, xx, tt: bin_ebm_flip_logits(m, net, xx, tt)))
    ets = torch.tensor([0.02, 0.1, 0.3, 0.6])
    log("  one B=4 BinEBMAux step, card vs CPU")
    out["BinEBMAux_step"] = hold_train_step(
        ecfg, ecpu, egpu, injected_loss(ecfg), bits, ets,
        (sample_xt(torch.Generator().manual_seed(0), ecpu.transition(ets), bits),),
        ulp_draws=2, hold_tables=False, invariant=EBM_INVARIANT,
        float64_tol=FLOAT64_GRAD_TOL)

    # K steps with injected noise
    K = 3

    def uniforms(shape, n=K):
        return [torch.from_numpy(g.random(shape).astype(np.float32)) for _ in range(n)]

    def gumbels(shape, n=K):
        return [torch.from_numpy(g.gumbel(size=shape).astype(np.float32)) for _ in range(n)]

    fcfg = full_cfg(fused=False, sampler="PCTauL")
    fcpu, fgpu, _ = seeded_pair(fcfg, dev, with64=False)
    pc = get_sampler(fcfg)
    models = {"cpu": fcpu, "cuda": fgpu}

    def pc_step(where, xx, i, noise):
        # [5]'s times at half its step: at random weights the flagship's
        # reverse rates are large (most states move in a step of 1e-3), and
        # a step here runs two rate passes (the predictor, and the corrector
        # over 1.5 h), so twice the CDF comparisons that a ~1e-6 difference
        # of the rates can flip
        m, grid = models[where], ((0.6, 5e-4), (0.3, 5e-4), (0.05, 5e-4))[i]
        u1, u2 = (u.to(m.device) for u in noise)
        xx = pc.step(m, m.net, xx.to(m.device), *grid, u=u1)
        return pc.corrector_step(m, m.net, xx, *grid, u=u2).cpu()

    FD, FS = fcfg.model.concat_dim, fcfg.data.S
    fx = torch.from_numpy(g.integers(FS * 2 // 5, FS * 3 // 5, (2, FD)).astype(np.int32))
    shape = (2, FD, FS)
    out["PCTauL_steps"] = hold_steps(
        "PCTauL (flagship, predictor and corrector)", pc_step, fx,
        list(zip(uniforms(shape), uniforms(shape))), list(zip(uniforms(shape), uniforms(shape))),
        {"fused_tau_leap_update": 0, "reverse_rates": 2 * K, "euler_posterior": 0})

    exact = get_sampler(ecfg)
    emodels = {"cpu": ecpu, "cuda": egpu}

    def exact_step(where, xx, i, noise):
        m = emodels[where]
        return exact.step(m, m.net, xx.to(m.device), (0.9, 0.5, 0.1)[i], 0.05,
                          g=noise.to(m.device)).cpu()

    ex = torch.from_numpy(g.integers(0, 2, (8, ED)).astype(np.int32))
    out["ExactSampling_steps"] = hold_steps(
        "ExactSampling (ebm_synthetic)", exact_step, ex, gumbels((8, ED, 2)),
        gumbels((8, ED, 2)), {"fused_tau_leap_update": 0, "reverse_rates": 0,
                              "euler_posterior": 0})

    cond = get_sampler(pcfg)
    cmodels = {"cpu": cpu, "cuda": gpu}
    prefix = seqs[:2, :P]

    def cond_step(where, xx, i, noise):
        m = cmodels[where]
        return cond.step(m, m.net, prefix.to(m.device), xx.to(m.device), (0.9, 0.5, 0.1)[i],
                         0.05, u=noise.to(m.device)).cpu()

    cx = torch.from_numpy(g.integers(0, S, (2, L - P)).astype(np.int32))
    out["ConditionalTauLeaping_steps"] = hold_steps(
        "ConditionalTauLeaping (pianoroll_cond)", cond_step, cx, uniforms((2, L - P, S)),
        uniforms((2, L - P, S)), {"fused_tau_leap_update": 0, "reverse_rates": K,
                                  "euler_posterior": 0})
    return out


def pc_samplers(dev) -> dict:
    """(c) PCTauL and TAULStepSize on the flagship at full width, one batch
    of 16 each with a live corrector (PC_CORRECTOR_STEPS steps at t <=
    PC_ENTRY), PC_STEPS steps: exact reverse-rates launches (PCTauL's
    num_steps - 1 predictor steps, TAULStepSize's num_steps, plus the
    corrector's), TAULStepSize's traces finite with frac_clipped <=
    frac_jumped."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    out = {}
    for name in ("PCTauL", "TAULStepSize"):
        cfg = full_cfg(fused=False, sampler=name)
        cfg.sampler.num_steps = PC_STEPS
        cfg.sampler.corrector_entry_time = PC_ENTRY
        cfg.sampler.num_corrector_steps = PC_CORRECTOR_STEPS
        model = create_model(cfg, device=dev)
        model.net.init_weights(torch.Generator().manual_seed(0))
        model.net.eval()
        sampler = get_sampler(cfg)
        ts, _ = sampler.time_grid()
        corrected = int((ts <= np.float32(PC_ENTRY)).sum())
        want = {"fused_tau_leap_update": 0,
                "reverse_rates": len(ts) + PC_CORRECTOR_STEPS * corrected,
                "euler_posterior": 0}
        t0 = time.perf_counter()
        (x, traces), launches = counted(lambda: sampler.sample(
            model, model.net, torch.Generator(device=dev).manual_seed(0), 16))
        seconds = time.perf_counter() - t0
        rec = dict(steps=len(ts), corrected_steps=corrected, seconds=seconds,
                   launches=launches, expected=want)
        log(f"  {name}: {len(ts)} steps ({corrected} with {PC_CORRECTOR_STEPS} corrector "
            f"steps) at N=16 in {seconds:.2f} s; launches {launches} (expected {want}); "
            f"values in [{x.min()}, {x.max()}]")
        if launches != want or x.shape != (16, cfg.model.concat_dim) or x.min() < 0 \
                or x.max() >= cfg.data.S:
            raise AssertionError(f"{name}: {rec}, samples {x.shape}")
        if name == "TAULStepSize":
            tr = {k: np.asarray(v) for k, v in traces.items()}
            ok = (set(tr) == {"frac_jumped", "frac_multi", "frac_clipped"}
                  and all(v.shape == (len(ts),) and np.isfinite(v).all() for v in tr.values())
                  and (tr["frac_clipped"] <= tr["frac_jumped"]).all())
            rec["traces"] = {k: dict(mean=float(v.mean()), max=float(v.max()))
                             for k, v in tr.items()}
            log(f"  TAULStepSize traces over {len(ts)} steps: " + ", ".join(
                f"{k} mean {v['mean']:.4f} max {v['max']:.4f}" for k, v in rec["traces"].items()))
            if not ok:
                raise AssertionError(f"TAULStepSize traces: {rec['traces']}")
        out[name] = rec
    return out


def ebm_levels(dev, cfg) -> dict:
    """MMD at the EBM protocol of data vs data (eval seed 0, the samplers'
    ground truth) and of uniform random bits: at seed 0, and their mean and
    std over eval seeds 0 .. UNIFORM_SEEDS - 1 (one draw of the uniform
    level spreads by ~7% of it)."""
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.metrics.mmd import eval_mmd

    dataset = get_dataset(cfg)
    D = cfg.model.concat_dim
    uniform = [eval_mmd(cfg, lambda g, n: torch.randint(0, 2, (n, D), generator=g, device=dev),
                        dataset, EBM_ROUNDS, EBM_SAMPLES, seed=seed, device=dev)
               for seed in range(UNIFORM_SEEDS)]
    return dict(
        uniform=uniform[0], uniform_mean=float(np.mean(uniform)),
        uniform_std=float(np.std(uniform, ddof=1)),
        data=eval_mmd(cfg, lambda g, n: dataset.data[torch.randint(
            0, len(dataset), (n,), generator=g, device=dev).cpu().numpy()],
            dataset, EBM_ROUNDS, EBM_SAMPLES, device=dev))


def trained_model(cfg, dev, ckpt_dir: str, steps: int, ema: bool = True):
    """The model of `cfg` with the EMA (or raw) weights of `<steps>.pt`."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint

    model = create_model(cfg, device=dev)
    ck = load_checkpoint(f"{ckpt_dir}/{steps}.pt", map_location=dev)
    model.net.load_state_dict(ck["ema_params" if ema else "params"])
    model.net.eval()
    return model


def one_batch(what, cfg, model, n, want, **kw) -> dict:
    """One batch of `n` from `model` with the config's sampler, its exact
    launch counts."""
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    sampler = get_sampler(cfg)
    t0 = time.perf_counter()
    out, launches = counted(lambda: sampler.sample(
        model, model.net, torch.Generator(device=model.device).manual_seed(0), n, **kw))
    seconds = time.perf_counter() - t0
    samples = out[0] if isinstance(out, tuple) else out
    log(f"  {what}: one batch of {n}, {cfg.sampler.name}, in {seconds:.2f} s; launches "
        f"{launches} (expected {want}); values in [{samples.min()}, {samples.max()}]")
    if launches != want or samples.min() < 0 or samples.max() >= cfg.data.S:
        raise AssertionError(f"{what}: launches {launches}, samples in "
                             f"[{samples.min()}, {samples.max()}]")
    return dict(n=n, sampler=cfg.sampler.name, seconds=seconds, launches=launches,
                samples=samples)


def phase_slice8(dev, tmpdir: str, data_path: str, pools: dict) -> dict:
    """Phase [16]. (a) pianoroll_cond and (b) ebm_synthetic trained by the
    train CLI (both at once, sharing the card: their CLI steps/s are not
    figures); pianoroll_cond's bare B=64 step alone (steps/s, idle share,
    peak memory); then the eval CLI (cond_mmd with
    ConditionalTauLeaping/1000; MMD at 3 x 256 with ExactSampling/750 and
    with CRMebmLBJF/750), the evals at once and beside this process's
    checks, whose times are not figures: one ConditionalLBJF batch, the
    EBM's MMD levels and loss, (d) card vs CPU, (c) PCTauL and TAULStepSize
    on the flagship and (e) two train() runs bit-identical; each with exact
    launch counts. The EBM's LBJF MMD must lie between data vs data and the
    uniform-bits mean; ExactSampling's (the preset's sampler, which reads at
    the uniform level even after the recipe's 3000 steps) between data vs
    data and UNIFORM_SPREAD std above that mean."""
    from concurrent.futures import ThreadPoolExecutor

    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.data.pianoroll import generate_standin, scale_consistency
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.utils.device import deterministic_training

    t0 = time.perf_counter()
    lakh = f"data.location={tmpdir}/absent_lakh.npy"
    log(f"  (a), (b) pianoroll_cond {COND_TRAIN_STEPS} and ebm_synthetic {EBM_TRAIN_STEPS} "
        "steps by the train CLI, at once")
    with ThreadPoolExecutor(2) as pool:
        p_run = pool.submit(train_cli, tmpdir, "pianoroll_cond", COND_TRAIN_STEPS, lakh)
        e_run = pool.submit(train_cli, tmpdir, "ebm_synthetic", EBM_TRAIN_STEPS)
        (p_rate, p_ckpt), (e_rate, e_ckpt) = p_run.result(), e_run.result()

    pcfg = get_preset("pianoroll_cond")
    pcfg.data.location = f"{tmpdir}/absent_lakh.npy"
    log("  (a) pianoroll_cond: the bare B=64 train step, alone, deterministic as train()")
    torch.cuda.reset_peak_memory_stats(dev)
    with deterministic_training(dev):
        step = train_step_breakdown(dev, pcfg, generate_standin(1024, pcfg.data.shape[0]))
    step["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory {step['peak_memory_gb']:.2f} GB")

    ecfg = get_preset("ebm_synthetic")
    log(f"  (a), (b) the evals at once: cond_mmd n={COND_SAMPLES}, MMD {EBM_ROUNDS} x "
        f"{EBM_SAMPLES} with ExactSampling and with CRMebmLBJF; beside them one "
        "ConditionalLBJF batch, (d), (c) and (e)")
    with ThreadPoolExecutor(3) as pool:
        p_eval = pool.submit(run_cli, "eval", "--preset", "pianoroll_cond", "--ckpt", p_ckpt,
                             "--metric", "cond_mmd", "--samples", str(COND_SAMPLES),
                             "--set", lakh)
        e_evals = {name: pool.submit(
            run_cli, "eval", "--preset", "ebm_synthetic", "--ckpt", e_ckpt, "--metric", "mmd",
            "--rounds", str(EBM_ROUNDS), "--samples", str(EBM_SAMPLES), "--batch", "0",
            "--set", f"sampler.name={name}",
            *([f"sampler.num_steps={EXACT_STEPS}"] if name == "ExactSampling" else []))
            for name in ("ExactSampling", "CRMebmLBJF")}
        lcfg = get_preset("pianoroll_cond")
        lcfg.data.location, lcfg.sampler.name = pcfg.data.location, "ConditionalLBJF"
        P = lcfg.sampler.condition_dim
        prefixes = generate_standin(COND_LBJF_BATCH, lcfg.data.shape[0])[:, :P]
        steps = lcfg.sampler.num_steps
        cond_lbjf = one_batch(
            f"pianoroll_cond trained {COND_TRAIN_STEPS} steps", lcfg,
            trained_model(lcfg, dev, p_ckpt, COND_TRAIN_STEPS), COND_LBJF_BATCH,
            {"fused_tau_leap_update": 0, "reverse_rates": steps, "euler_posterior": steps},
            conditioner=prefixes)
        made = cond_lbjf.pop("samples")
        if not np.array_equal(made[:, :P], prefixes):
            raise AssertionError("ConditionalLBJF did not keep the prefix")
        cond_lbjf["scale_consistency"] = scale_consistency(made, P)
        levels = ebm_levels(dev, ecfg)
        # the EBM's loss on fixed draws, at the start and trained (raw) weights
        x0 = torch.from_numpy(get_dataset(ecfg).data[:256].astype(np.int32)).to(dev)
        model = trained_model(ecfg, dev, e_ckpt, EBM_TRAIN_STEPS, ema=False)
        with torch.no_grad():
            losses = {which: float(get_loss(ecfg).calc_loss(
                model, params, torch.Generator(device=dev).manual_seed(123), x0, train=False))
                for which, params in (("start", start_weights(ecfg, dev)),
                                      ("trained", model.net))}
        log("  (d) card vs CPU")
        vs_cpu = slice8_vs_cpu(dev)
        log(f"  (c) PCTauL and TAULStepSize on the flagship, {PC_STEPS} steps, a live "
            "corrector")
        pc = pc_samplers(dev)
        log("  (e) determinism of train() (its steps/s shared with the evals: not figures)")
        det = determinism_runs(dev, tmpdir, data_path, pools)
        p_res = last_json(p_eval.result())
        e_res = {name: last_json(run.result()) for name, run in e_evals.items()}

    want_cond = {"fused_tau_leap_update": 0, "reverse_rates": steps, "euler_posterior": 0}
    log(f"  pianoroll_cond: cond_mmd {p_res['value']:.6f}, floor {p_res['floor']:.6f}, "
        f"shuffled anchor {p_res['shuffled']:.6f}; scale_consistency "
        f"{p_res['scale_consistency']:.4f} (ground truth {p_res['gt_scale_consistency']:.4f}, "
        f"shuffled {p_res['shuffled_scale_consistency']:.4f}), rest fraction "
        f"{p_res['model_rest_frac']:.4f} (ground truth {p_res['gt_rest_frac']:.4f}); "
        f"launches {p_res['kernel_launches']} (expected {want_cond}); the train CLI "
        f"{p_rate:.2f} steps/s beside the EBM's")
    if p_res["kernel_launches"] != want_cond or not math.isfinite(p_res["value"]):
        raise AssertionError(f"eval cond_mmd: {p_res}")
    e_steps = ecfg.sampler.num_steps
    want_ebm = {"ExactSampling": {"fused_tau_leap_update": 0, "reverse_rates": 0,
                                  "euler_posterior": 0},
                "CRMebmLBJF": {"fused_tau_leap_update": 0, "reverse_rates": 0,
                               "euler_posterior": EBM_ROUNDS * e_steps}}
    ceiling = {"ExactSampling": levels["uniform_mean"] + UNIFORM_SPREAD * levels["uniform_std"],
               "CRMebmLBJF": levels["uniform_mean"]}
    log(f"  ebm_synthetic: BinEBMAux on fixed draws {losses['start']:.5f} at the start, "
        f"{losses['trained']:.5f} trained; uniform random bits {levels['uniform_mean']:.6f} "
        f"+- {levels['uniform_std']:.6f} over {UNIFORM_SEEDS} eval seeds "
        f"({levels['uniform']:.6f} at seed 0); data vs data {levels['data']:.3e}; the train "
        f"CLI {e_rate:.2f} steps/s beside pianoroll_cond's")
    for name, res in e_res.items():
        n_steps = EXACT_STEPS if name == "ExactSampling" else e_steps
        log(f"  ebm_synthetic MMD ({name}/{n_steps}, {EBM_ROUNDS} x {EBM_SAMPLES}) "
            f"{res['value']:.6f}: held between data vs data and {ceiling[name]:.6f}; "
            f"launches {res['kernel_launches']} (expected {want_ebm[name]})")
    if not losses["trained"] < losses["start"]:
        raise AssertionError(f"ebm_synthetic: the loss did not fall: {losses}")
    for name, res in e_res.items():
        if res["kernel_launches"] != want_ebm[name] or not (
                levels["data"] < res["value"] < ceiling[name]):
            raise AssertionError(f"eval mmd ebm_synthetic {name}: {res}, levels {levels}")

    seconds = time.perf_counter() - t0
    log(f"  phase [16]: {seconds:.1f} s")
    return dict(
        vs_cpu=vs_cpu, pc_samplers=pc,
        pianoroll_cond=dict(train_steps=COND_TRAIN_STEPS, cli_steps_per_s_shared=p_rate,
                            train_step=step, cond_mmd=p_res, conditional_lbjf=cond_lbjf),
        ebm_synthetic=dict(train_steps=EBM_TRAIN_STEPS, cli_steps_per_s_shared=e_rate,
                           loss=losses, mmd=e_res, levels=levels),
        determinism=det, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 17: slice 9, the DiT, U-ViT and CIFAR10 image presets and the
# label-conditional path
# ---------------------------------------------------------------------------

IMAGE_SHORT_STEPS = 10  # (c) dit_mnist under NLLOriginal
BIN_TRAIN_STEPS = 30  # (e) bin_mnist_hollow (the preset's 500k, cut)
CFG_STEPS = 100  # (c) the guided batch and /generate: 100 of the preset's 1000 steps
CFG_SCALE = 1.5
FID_LENET_SAMPLES = 32  # (g) not a quality figure
# (b), (e), (g): sampler steps of the served, sampled and scored batches (the
# presets' 1000 until phase [19] came: cut for time)
IMAGE_SAMPLER_STEPS = 500
K_FUSED = 3  # (b) fused vs plain steps at D=3072
TABLE_LEAF = "DiT_0.LabelEmbedder_0.Embed_0.weight"


def cifar_like(path: str, n: int = 2048, seed: int = 1) -> str:
    """A seeded stand-in in CIFAR10's layout: uint8 (n, 3, 32, 32) images of
    `mnist_like`'s strokes on a 32x32 canvas, tinted per image, as
    `x_train`/`y_train` (an image's label the decile of its mean)."""
    grey = np.load(mnist_like(path + ".grey.npz", n, seed))["x_train"]
    os.remove(path + ".grey.npz")
    canvas = np.zeros((n, 32, 32), np.uint8)
    canvas[:, 2:30, 2:30] = grey
    tint = np.random.default_rng(seed).uniform(0.4, 1.0, (n, 3, 1, 1))
    imgs = np.rint(canvas[:, None] * tint).astype(np.uint8)
    ink = imgs.reshape(n, -1).mean(axis=1)
    labels = np.searchsorted(np.quantile(ink, np.linspace(0.1, 0.9, 9)), ink)
    np.savez(path, x_train=imgs, y_train=labels.astype(np.int64))
    return path


def image_cfg(tmpdir: str, preset: str, data: dict, run: str = ""):
    """`preset` at its full width on its stand-in (`data`: preset -> npz), no
    in-loop grid, one checkpoint at the end."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset(preset)
    cfg.data.location = data[preset]
    cfg.save_location = f"{tmpdir}/{preset}{run}"
    cfg.sampler.sample_freq = 0
    cfg.saving.checkpoint_freq = 10**6
    return cfg


def tau_unet_cfg():
    """`GaussianTargetRateImageX0PredEMA`, the zoo's tau-UNet that no preset
    names, at `tauUnet_cifar10`'s width (its four scales)."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset("tauUnet_cifar10")
    cfg.model.name = "GaussianTargetRateImageX0PredEMA"
    cfg.model.num_scales = len(cfg.model.ch_mult)
    return cfg


def perturbed_pair(cfg, dev):
    """`seeded_pair` with 0.02·N(0, 1) from seed 1 added to every weight:
    DiT's zero-initialised adaLN and final layer and U-ViT's positional
    table would otherwise hide the layers they gate."""
    cpu, gpu, net64 = seeded_pair(cfg, dev)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    gpu.net.load_state_dict(cpu.net.state_dict())
    net64.load_state_dict({k: v.double() for k, v in cpu.net.state_dict().items()})
    return cpu, gpu, net64


def image_vs_cpu(dev) -> dict:
    """(a) Full-width logits at B=2, card against CPU (`hold_vs_cpu`, with its
    TF32 control): DiT (with labels), both U-ViTs, the CIFAR10 UNet and the
    tau-UNet; then DiT's guided logits at cfg_scale 0, 1 and 1.5. The
    logistic heads run with the min-trick (`fix_logistic`): without it the
    far bins are ill-conditioned in float32 (the CPU's float32 sits ~2e-3
    of the largest |logit| from its float64 there), which hides a TF32
    network."""
    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.sampling.samplers import bind_label

    out = {}
    nets = (("dit_mnist", get_preset("dit_mnist")), ("uvit_mnist", get_preset("uvit_mnist")),
            ("uvit_cifar10", get_preset("uvit_cifar10")),
            ("tauUnet_cifar10", get_preset("tauUnet_cifar10")), ("tau-UNet", tau_unet_cfg()))
    g = np.random.default_rng(7)
    for label, cfg in nets:
        cfg.model.fix_logistic = True
        cpu, gpu, net64 = perturbed_pair(cfg, dev)
        D, S = cfg.model.concat_dim, cfg.data.S
        x = torch.from_numpy(g.integers(0, S, (2, D)).astype(np.int32))
        t = torch.tensor([0.3, 0.9])
        y = torch.tensor([3, 7])
        scales = (None,) + ((0.0, 1.0, CFG_SCALE) if cpu.has_label else ())
        for scale in scales:
            def run(where, dtype, scale=scale):
                m = gpu if where == "cuda" else cpu
                net = net64 if dtype == torch.float64 else m.net
                if scale is not None:
                    m = bind_label(m, y, scale, S)
                kw = {"label": y.to(m.device)} if m.has_label and scale is None else {}
                return m.apply(net, x.to(m.device), t.to(m.device, dtype), **kw).cpu()

            name = label if scale is None else f"{label} guided, cfg_scale {scale:g}"
            out[name] = hold_vs_cpu(name, run)
        del cpu, gpu, net64
    return out


def fused_vs_plain_steps(dev, cfg, model) -> dict:
    """(b) K_FUSED fused tau-leap steps at D=3072 from the trained model's
    logits, the kernel against its plain version on the same logits and
    injected uniforms (phase [3]'s hold); both chains go on from the plain
    state."""
    from ctdd_tpu_torch.ops import fused_update as fu
    from ctdd_tpu_torch.sampling.samplers import _shared_mats

    g = torch.Generator(device=dev).manual_seed(11)
    D, S = cfg.model.concat_dim, cfg.data.S
    x = torch.randint(100, 156, (16, D), generator=g, device=dev, dtype=torch.int32)
    x0, flips, states = x.clone(), 0, 0
    with torch.inference_mode():
        for t_, h_ in ((0.6, 1e-3), (0.3, 1e-3), (0.05, 1e-3))[:K_FUSED]:
            logits = model.apply(model.net, x, torch.full((16,), t_, device=dev))
            qt0, rate = _shared_mats(model.process, t_)
            u = torch.rand((16, D, S), generator=g, device=dev)
            k = fu.fused_tau_leap_update(logits, x, x, qt0, rate, h_, cfg.sampler.eps_ratio,
                                         0, u=u)
            p = fu.fused_tau_leap_update_plain(logits, x, x, qt0, rate, h_,
                                               cfg.sampler.eps_ratio, u)
            flips += int((k != p).sum())
            states += p.numel()
            x = p
    moved = (x != x0).float().mean().item()
    log(f"  {K_FUSED} fused TauL steps at (16, {D}, {S}), kernel vs plain on the trained "
        f"model's logits: {flips} of {states} states differ (allowed "
        f"{MAX_FLIP_FRAC * states:.1f}; moved {moved:.3f})")
    if flips > MAX_FLIP_FRAC * states or not moved > 0:
        raise AssertionError(f"fused vs plain at D={D}: {flips} differ, moved {moved}")
    return dict(steps=K_FUSED, states=states, differ=flips, moved=moved)


def twin_train(dev, cfg) -> tuple:
    """Two train() runs of `cfg` from seed 0, DETERMINISM_STEPS steps each,
    which must end bit-identical: (the first run's state, its info with its
    peak memory)."""
    from ctdd_tpu_torch.training.loop import train

    steps = DETERMINISM_STEPS
    runs = []
    base = cfg.save_location
    for run in ("a", "b"):
        cfg.save_location = f"{base}_{run}"
        torch.cuda.reset_peak_memory_stats(dev)
        state, info = train(cfg, n_iters=steps, seed=0, device=dev, log_every=steps)
        info["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        runs.append((state, info))
    cfg.save_location = base
    (a, info), (b, _) = runs
    differ = sorted(k for k in a.params if not torch.equal(a.params[k], b.params[k]))
    log(f"  {cfg.experiment_name}: two train() runs of {steps} steps at "
        f"B={cfg.data.batch_size}: {info['steps_per_sec']:.2f} steps/s, peak "
        f"{info['peak_memory_gb']:.2f} GB; leaves that differ bit for bit: {len(differ)} of "
        f"{len(a.params)}" + (f" ({differ[:6]})" if differ else ""))
    if differ:
        raise AssertionError(f"{cfg.experiment_name}: two train() runs differ: {differ[:6]}")
    return a, info


def image_training(dev, cfg, data_path: str) -> tuple:
    """(train() rate and peak memory (`twin_train`'s first run) with the
    bare step's device split (`train_step_breakdown`, its idle share,
    deterministic as train()), the first run's checkpoint directory)."""
    from ctdd_tpu_torch.utils.device import deterministic_training

    _, info = twin_train(dev, cfg)
    with deterministic_training(dev):
        step = train_step_breakdown(dev, cfg, np.load(data_path)["x_train"])
    return dict(train_steps_per_s=info["steps_per_sec"],
                peak_memory_gb=info["peak_memory_gb"], step=step), info["paths"]["checkpoints"]


def dit_label_path(dev, tmpdir: str, data: dict) -> dict:
    """(c) `dit_mnist`: two 20-step train() runs under its NLL, the label
    table bit-equal to its start in the params and the EMA (NLL never passes
    the label: the reference quirk); IMAGE_SHORT_STEPS steps under
    NLLOriginal, where the table moves in both; one guided batch of 16
    (labels arange % 10, cfg_scale 1.5, CFG_STEPS steps: that many
    reverse-rates launches and two forwards a step and for the denoise);
    one /generate?label=...&cfg_scale=... request."""
    from ctdd_tpu_torch.training.loop import train

    cfg = image_cfg(tmpdir, "dit_mnist", data)
    start = start_weights(cfg, dev)[TABLE_LEAF]
    state, info = twin_train(dev, cfg)
    held = [torch.equal(state.params[TABLE_LEAF].detach(), start),
            torch.equal(state.ema_params[TABLE_LEAF], start)]
    ocfg = image_cfg(tmpdir, "dit_mnist", data, run="_nll_original")
    ocfg.loss.name = "NLLOriginal"
    ostate, _ = train(ocfg, n_iters=IMAGE_SHORT_STEPS, seed=0, device=dev,
                      log_every=IMAGE_SHORT_STEPS)
    moved = [float((ostate.params[TABLE_LEAF].detach() - start).abs().max()),
             float((ostate.ema_params[TABLE_LEAF] - start).abs().max())]
    log(f"  dit_mnist label table {tuple(start.shape)}: under NLL bit-equal to its start "
        f"(params, EMA): {held}; under NLLOriginal after {IMAGE_SHORT_STEPS} steps it "
        f"moved by {moved[0]:.3e} (params), {moved[1]:.3e} (EMA)")
    if held != [True, True] or not (moved[0] > 0 and moved[1] > 0):
        raise AssertionError(f"dit_mnist label table: NLL {held}, NLLOriginal {moved}")

    ckpt = f"{info['paths']['checkpoints']}/{DETERMINISM_STEPS}.pt"
    gcfg = image_cfg(tmpdir, "dit_mnist", data)
    gcfg.sampler.num_steps = CFG_STEPS
    model = trained_model(gcfg, dev, info["paths"]["checkpoints"], DETERMINISM_STEPS)
    calls = []
    hook = model.net.register_forward_hook(lambda *a: calls.append(1))
    want = {"fused_tau_leap_update": 0, "reverse_rates": CFG_STEPS, "euler_posterior": 0}
    try:
        guided = one_batch(f"dit_mnist trained {DETERMINISM_STEPS} steps, guided", gcfg,
                           model, 16, want, label=np.arange(16) % 10, cfg_scale=CFG_SCALE)
    finally:
        hook.remove()
    guided.pop("samples")
    guided["forwards"] = len(calls)
    if len(calls) != 2 * (CFG_STEPS + 1):
        raise AssertionError(f"guided batch: {len(calls)} forwards, expected "
                             f"{2 * (CFG_STEPS + 1)}")
    query = "&label=" + ",".join(str(i % 10) for i in range(16)) + f"&cfg_scale={CFG_SCALE}"
    served = serve_checkpoint(dev, "dit_mnist guided /generate", gcfg, ckpt, 16,
                              {"reverse_rates": CFG_STEPS}, warmup=False, query=query)
    return dict(table_held_under_nll=held, table_moved_under_nll_original=moved,
                train_steps_per_s=info["steps_per_sec"], peak_memory_gb=info["peak_memory_gb"],
                guided_batch=guided, generate_launches=served[0], generate_seconds=served[1])


def slice9_kernels(dev) -> dict:
    """(f) The kernels against their plain versions at this slice's shapes
    (fused tau-leap at (16, 3072, 256) and (256, 3072, 256); reverse rates
    at (16, 3072, 256); the Euler posterior at bin_mnist_hollow's
    (16, 784, 2)), then each one's time against its bound."""
    from ctdd_tpu_torch.ops import fused_update as fu

    worst = dict(rate_abs=0.0, rate_row_rel=0.0, post_prob=0.0, post_log=0.0)
    flipped = 0.0
    for N in (16, 256):
        for step in (100, 500, 950):
            logits, x, qt0, rate, u, h = fused_inputs(N, 3072, 256, step, N + step, dev)
            for mode, uu in (("poisson", u), ("expected", None)):
                k = fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 0,
                                             mode=mode, u=uu)
                p = fu.fused_tau_leap_update_plain(logits, x, x, qt0, rate, h, 1e-9, uu,
                                                   mode=mode)
                frac = (k != p).float().mean().item()
                flipped = max(flipped, frac)
                # a tie in "expected" mode moves the rounded jump by 1; in
                # "poisson" mode it flips one jump count, which moves the
                # state by that jump's s - x: the share of states is held
                far = mode == "expected" and (k - p).abs().max().item() > 1
                if frac > MAX_FLIP_FRAC or far:
                    raise AssertionError(f"fused kernel vs plain {mode} N={N} D=3072 "
                                         f"step={step}: {frac:.2e} of states differ")
        log(f"  fused tau-leap N={N} D=3072 S=256: poisson(u) and expected agree with "
            f"plain at three grid points (largest share that differs {flipped:.2e}, "
            f"allowed {MAX_FLIP_FRAC:.0e})")
    for N, D, S in ((16, 3072, 256), (16, 784, 2)):
        for per_sample, fracs in ((True, (0.1, 0.5, 0.95)), (False, (0.5,))):
            logits, qc, qt0, rc, x, h = rate_inputs(N, D, S, fracs, 3 * N + D, dev, per_sample)
            hold_rate_kernels(f"N={N} D={D} S={S} "
                              f"{'per-sample' if per_sample else 'shared'} tables",
                              logits, qc, qt0, rc, x, h, worst)
    timing = {"fused_tau_leap_update": {N: fused_timing(N, 3072, 256, dev) for N in (16, 256)},
              "reverse_rates": {}, "euler_posterior": {}}
    for key, shape in (("cifar", (16, 3072, 256)), ("binmnist", (16, 784, 2))):
        for name, t in rate_timing(*shape, dev).items():
            timing[name][key] = t
    return dict(worst=worst, fused_flip_frac=flipped, timing=timing)


def phase_slice9(dev, tmpdir: str, data_path: str) -> dict:
    """Phase [17]. (b) tauUnet_cifar10 through train() (twin 20-step runs
    bit-identical; rate, peak memory, the step's device split), its
    checkpoint served over /generate (TauL/IMAGE_SAMPLER_STEPS: exactly that
    many reverse-rates launches at (16, 3072, 256)) and K fused steps
    against plain at D=3072;
    then (g) the eval CLI's lenet FID of that checkpoint, beside (a) card
    vs CPU and (c) dit_mnist's label path, whose times are not figures;
    alone again, (d) uvit_mnist, uvit_cifar10 and dit_mnist's bare steps,
    (e) bin_mnist_hollow trained and LBJF/IMAGE_SAMPLER_STEPS (exactly that
    many posterior launches at (16, 784, 2)), and (f) the kernels at this
    slice's shapes."""
    from concurrent.futures import ThreadPoolExecutor

    from ctdd_tpu_torch.training.loop import train
    from ctdd_tpu_torch.utils.device import deterministic_training

    t0 = time.perf_counter()
    cifar = cifar_like(f"{tmpdir}/cifar_like.npz")
    data = {"tauUnet_cifar10": cifar, "uvit_cifar10": cifar, "dit_mnist": data_path,
            "uvit_mnist": data_path, "bin_mnist_hollow": data_path}
    out = {}

    log("  (b) tauUnet_cifar10 (UNet, 3 x 32 x 32, CTElboLambda) at B=64")
    cfg = image_cfg(tmpdir, "tauUnet_cifar10", data)
    out["tauUnet_cifar10"], ckpt_dir = image_training(dev, cfg, cifar)
    ckpt = f"{ckpt_dir}/{DETERMINISM_STEPS}.pt"
    steps = cfg.sampler.num_steps = IMAGE_SAMPLER_STEPS
    launches, seconds = serve_checkpoint(
        dev, f"tauUnet_cifar10 trained {DETERMINISM_STEPS} steps", cfg, ckpt, 16,
        {"reverse_rates": steps}, warmup=False)
    out["tauUnet_cifar10"].update(served_launches=launches, served_seconds=seconds,
                                  served_samples_per_s=16 / seconds)
    fcfg = image_cfg(tmpdir, "tauUnet_cifar10", data)
    fcfg.sampler.use_fused_update = True
    out["tauUnet_cifar10"]["fused_vs_plain"] = fused_vs_plain_steps(
        dev, fcfg, trained_model(fcfg, dev, ckpt_dir, DETERMINISM_STEPS))

    log(f"  (g) eval --metric fid --features lenet of that checkpoint ({FID_LENET_SAMPLES} "
        f"samples, TauL/{steps}), beside (a) and (c)")
    with ThreadPoolExecutor(1) as pool:
        fid_run = pool.submit(
            run_cli, "eval", "--preset", "tauUnet_cifar10", "--ckpt", ckpt, "--metric", "fid",
            "--features", "lenet", "--samples", str(FID_LENET_SAMPLES), "--batch", "16",
            "--n-real", "512", "--set", f"data.location={cifar}",
            f"sampler.num_steps={steps}")
        log("  (a) full-width logits at B=2, card vs CPU")
        out["vs_cpu"] = image_vs_cpu(dev)
        log("  (c) dit_mnist: the label table under NLL and NLLOriginal, a guided batch, "
            "/generate with labels")
        out["dit_mnist"] = dit_label_path(dev, tmpdir, data)
        fid = last_json(fid_run.result())
    want = {"fused_tau_leap_update": 0, "reverse_rates": 2 * steps, "euler_posterior": 0}
    log(f"  eval fid lenet tauUnet_cifar10: {fid['value']:.4f} (not a quality figure); "
        f"launches {fid['kernel_launches']} (expected {want})")
    if fid["kernel_launches"] != want or not math.isfinite(fid["value"]):
        raise AssertionError(f"eval fid lenet: {fid}")
    out["fid_lenet"] = fid

    log("  (d) the bare B=64 steps of uvit_mnist, uvit_cifar10 and dit_mnist, alone, "
        "deterministic as train()")
    for preset in ("uvit_mnist", "uvit_cifar10", "dit_mnist"):
        torch.cuda.reset_peak_memory_stats(dev)
        with deterministic_training(dev):
            step = train_step_breakdown(dev, image_cfg(tmpdir, preset, data),
                                        np.load(data[preset])["x_train"])
        step["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"  {preset}: peak device memory {step['peak_memory_gb']:.2f} GB")
        out.setdefault(preset, {})["step"] = step

    log(f"  (e) bin_mnist_hollow (hollow, D=784, S=2, CatRM) at B=16, {BIN_TRAIN_STEPS} steps; "
        f"LBJF/{IMAGE_SAMPLER_STEPS} at batch 16")
    bcfg = image_cfg(tmpdir, "bin_mnist_hollow", data)
    torch.cuda.reset_peak_memory_stats(dev)
    _, info = train(bcfg, n_iters=BIN_TRAIN_STEPS, seed=0, device=dev,
                    log_every=BIN_TRAIN_STEPS)
    bsteps = bcfg.sampler.num_steps = IMAGE_SAMPLER_STEPS
    model = trained_model(bcfg, dev, info["paths"]["checkpoints"], BIN_TRAIN_STEPS)
    lbjf = one_batch(f"bin_mnist_hollow trained {BIN_TRAIN_STEPS} steps", bcfg, model, 16,
                     {"fused_tau_leap_update": 0, "reverse_rates": 0,
                      "euler_posterior": bsteps})
    lbjf.pop("samples")
    pool = (np.load(data_path)["x_train"] > 127).astype(np.int32)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with deterministic_training(dev):
        step = train_step_breakdown(dev, bcfg, pool)
    out["bin_mnist_hollow"] = dict(train_steps_per_s=info["steps_per_sec"], peak_memory_gb=peak,
                                   lbjf=lbjf, samples_per_s=16 / lbjf["seconds"], step=step)

    log("  (f) the kernels at this slice's shapes, against plain and timed")
    out["kernels"] = slice9_kernels(dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase [17]: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase [18]: the D3PM baseline and on-device augmentation
# ---------------------------------------------------------------------------

D3PM_PRESETS = ("mnist_d3pm", "synthetic_d3pm", "protein_maze_d3pm")
D3PM_GRID_STEPS = 100  # (b) mnist_d3pm's in-loop TauL grid: 100 of the preset's 1000 steps
D3PM_SYNTH_STEPS = 300  # (b) synthetic_d3pm (the preset's 200k, cut)
D3PM_MAZE_STEPS = 20  # (b) protein_maze_d3pm (the preset's 300k, cut)
D3PM_MAZE_SAMPLES = 64  # (c) maze_acc, ancestral at T=1000
D3PM_ULP_FLOOR = 2.0**-23  # (a) the CPU's float32 error is taken as at least one ulp
AUGM_STEPS = 10  # (d) tauUnet_cifar10 and dit_mnist with data.use_augm
AUGM_TIE_BAND = 1e-4  # (d) a source coordinate this close to a half-integer is a tie
D3PM_PROFILE_STEPS = 10  # (e) ancestral steps timed and traced
GRID_OFF = "in-loop sample grids disabled: model has no CTMC process"


def d3pm_cfg(tmpdir: str, preset: str, data_path: str, run: str = ""):
    """`preset` at its full width (mnist_d3pm on the MNIST-layout stand-in),
    one checkpoint at the end; the preset's own sample_freq."""
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset(preset)
    if preset == "mnist_d3pm":
        cfg.data.location = data_path
    cfg.save_location = f"{tmpdir}/{preset}{run}"
    cfg.saving.checkpoint_freq = 10**6
    return cfg


def hold_d3pm(label: str, run) -> dict:
    """`run(where, dtype)` -> {name: CPU tensor}: each value, card (float32,
    TF32 off) against the CPU's float32, within LOGIT_FLOOR_MULT times the
    CPU's own float32 error against float64 (at least D3PM_ULP_FLOOR), as
    shares of its largest |value|; the card with TF32 on is the control,
    which must break at least one of the limits."""
    from ctdd_tpu_torch.utils.device import tf32, tf32_off

    with torch.inference_mode():
        ref, ref64 = run("cpu", torch.float32), run("cpu", torch.float64)
        with tf32_off():
            got = run("cuda", torch.float32)
        with tf32(True):
            got_tf32 = run("cuda", torch.float32)
    out, broken = {}, []
    for name in ref:
        scale = ref64[name].abs().max().item()
        floor = max((ref[name] - ref64[name]).abs().max().item() / scale, D3PM_ULP_FLOOR)
        err = (got[name] - ref[name]).abs().max().item() / scale
        err_tf32 = (got_tf32[name] - ref[name]).abs().max().item() / scale
        tol = LOGIT_FLOOR_MULT * floor
        out[name] = dict(rel_err=err, floor=floor, tol=tol, tf32_rel_err=err_tf32)
        log(f"  {label} {name} {tuple(got[name].shape)}: card vs CPU {err:.3e} (tol {tol:.3e} "
            f"= {LOGIT_FLOOR_MULT:g} x the CPU's float32 error {floor:.3e}); TF32 on "
            f"{err_tf32:.3e}")
        if not (got[name].shape == ref[name].shape and math.isfinite(err) and err <= tol):
            raise AssertionError(f"{label} {name}: card vs CPU {err} above {tol}")
        if err_tf32 > tol:
            broken.append(name)
    log(f"  {label}: the TF32 control breaks the limits of {broken} (must break one)")
    if not broken:
        raise AssertionError(f"{label}: the limits pass TF32 values")
    return out


def d3pm_vs_cpu(dev) -> dict:
    """(a) Each preset at full width, B=2, t = (T-1, 0), the weights of
    `perturbed_pair`: its tables on the card bit-equal to the host's; then
    the posterior logits of both branches, p_logits and the three losses
    with injected Gumbel noise, held by `hold_d3pm` (float64 reference: the
    CPU's network in float64 on the float32 tables cast to float64)."""
    import copy

    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.d3pm.diffusion import make_diffusion

    out = {}
    for preset in D3PM_PRESETS:
        cfg = get_preset(preset)
        # perturbed: the UNet's final layer starts at ~0, which hides the network
        cpu, gpu, net64 = perturbed_pair(cfg, dev)
        dc, dg = make_diffusion(cfg.model, device="cpu"), make_diffusion(cfg.model, device=dev)
        names = ("q_onestep_mats", "q_mats", "transpose_q_onestep_mats")
        if not all(torch.equal(getattr(dg, n).cpu(), getattr(dc, n)) for n in names):
            raise AssertionError(f"{preset}: the tables on the card differ from the host's")
        d64 = copy.copy(dc)
        d64.q_onestep_mats, d64.q_mats = dc.q_onestep_mats.double(), dc.q_mats.double()
        d64.transpose_q_onestep_mats = d64.q_onestep_mats.transpose(1, 2)
        T, D, S = cfg.model.num_timesteps, cfg.model.concat_dim, cfg.data.S
        g = torch.Generator().manual_seed(7)
        x0, xt = (torch.randint(0, S, (2, D), generator=g) for _ in range(2))
        t = torch.tensor([T - 1, 0])
        logits = 3.0 * torch.randn((2, D, S), generator=g)
        u = torch.rand((2, D, S), generator=g).clamp_min(float(np.finfo(np.float32).tiny))
        gumbel = -torch.log(-torch.log(u))

        def run(where, dtype):
            diff = dg if where == "cuda" else (dc if dtype == torch.float32 else d64)
            model = gpu if where == "cuda" else cpu
            net = {"cuda": gpu.net, "cpu": cpu.net if dtype == torch.float32 else net64}[where]
            on = dev if where == "cuda" else "cpu"

            def fn(x, ti):
                return model.apply(net, x, ti)

            res = dict(
                posterior_x_start=diff.q_posterior_logits(x0.to(on), xt.to(on), t.to(on), False),
                posterior_logits=diff.q_posterior_logits(logits.to(on, dtype), xt.to(on),
                                                         t.to(on), True),
                p_logits=diff.p_logits(fn, xt.to(on), t.to(on))[0])
            for loss_type in ("kl", "cross_entropy_x_start", "hybrid"):
                diff.loss_type = loss_type
                res[f"loss_{loss_type}"] = diff.training_losses(
                    fn, x0.to(on), t.to(on), gumbel=gumbel.to(on, dtype))
            return {k: v.double().cpu() for k, v in res.items()}

        mb = sum(getattr(dc, n).numel() * 4 for n in names[:2]) / 1e6
        log(f"  {preset} ({type(cpu.net).__name__}, T={T}, D={D}, S={S}): tables on the card "
            f"bit-equal to the host's ({mb:.1f} MB)")
        out[preset] = hold_d3pm(preset, run)
    return out


def d3pm_training(dev, tmpdir: str, data_path: str) -> dict:
    """(b) mnist_d3pm twice through train(), DETERMINISM_STEPS steps at B=64
    from seed 0, bit-identical; run (a) with its in-loop TauL grid at the last
    step (D3PM_GRID_STEPS steps), run (b) without. The grid takes the ratio
    rate path, as JAX's does for a loss outside the tauLDR family (loss.name
    d3pm): plain torch, no kernel launch. synthetic_d3pm (its loss falls) and
    protein_maze_d3pm (through its fresh pool), each printing JAX's no-grid
    line."""
    import contextlib
    import io

    from ctdd_tpu_torch.sampling.samplers import get_sampler
    from ctdd_tpu_torch.training.loop import train

    steps, runs = DETERMINISM_STEPS, {}
    for run in ("a", "b"):
        cfg = d3pm_cfg(tmpdir, "mnist_d3pm", data_path, f"_{run}")
        if run == "a":
            cfg.sampler.sample_freq, cfg.sampler.num_steps = steps, D3PM_GRID_STEPS
        torch.cuda.reset_peak_memory_stats(dev)
        (state, info), launches = counted(lambda: train(cfg, n_iters=steps, seed=0, device=dev,
                                                        log_every=steps))
        runs[run] = (state, info, launches, torch.cuda.max_memory_allocated(dev) / 1e9)
    (a, info, grid, peak), (b, _, quiet, _) = runs["a"], runs["b"]
    differ = sorted(k for k in a.params if not torch.equal(a.params[k], b.params[k]))
    samples = np.load(f"{info['paths']['pngs']}/samples_{steps}.npy")
    rate_param = get_sampler(d3pm_cfg(tmpdir, "mnist_d3pm", data_path)).rate_param
    log(f"  mnist_d3pm: two train() runs of {steps} steps at B={cfg.data.batch_size}: "
        f"{info['steps_per_sec']:.2f} steps/s, peak {peak:.2f} GB; leaves that differ bit for "
        f"bit: {len(differ)} of {len(a.params)}; the in-loop grid (TauL/{D3PM_GRID_STEPS}, "
        f"the {rate_param} rate path) launched {grid} (expected none), samples "
        f"{samples.shape} in [{samples.min()}, {samples.max()}]; the run without it {quiet}")
    if differ:
        raise AssertionError(f"mnist_d3pm: two train() runs differ: {differ[:6]}")
    if rate_param != "ratio" or any(grid.values()) or any(quiet.values()) or \
            samples.shape != (16, 784) or samples.min() < 0 or samples.max() > 255:
        raise AssertionError(f"mnist_d3pm grid: {rate_param}, {grid}, {samples.shape}")
    out = {"mnist_d3pm": dict(train_steps_per_s=info["steps_per_sec"], peak_memory_gb=peak,
                              grid_launches=grid, checkpoints=info["paths"]["checkpoints"])}
    for preset, n in (("synthetic_d3pm", D3PM_SYNTH_STEPS), ("protein_maze_d3pm",
                                                            D3PM_MAZE_STEPS)):
        cfg = d3pm_cfg(tmpdir, preset, data_path)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, info = train(cfg, n_iters=n, seed=0, device=dev, log_every=n)
        losses = np.asarray(info["step_losses"])
        k = min(20, n // 2)
        first, last = float(losses[:k].mean()), float(losses[-k:].mean())
        log(f"  {preset}: {n} steps at B={cfg.data.batch_size}, "
            f"{info['steps_per_sec']:.2f} steps/s; loss {first:.4f} (first {k}) -> {last:.4f} "
            f"(last {k}); pool swaps {len(info['pool_swaps'])}; printed: "
            + " | ".join(printed.getvalue().strip().splitlines()))
        if GRID_OFF not in printed.getvalue():
            raise AssertionError(f"{preset}: no 'grids disabled' line")
        if preset == "synthetic_d3pm":
            check_losses(preset, losses, first, last)
        elif not np.isfinite(losses).all():
            raise AssertionError(f"{preset}: losses {losses.tolist()}")
        out[preset] = dict(train_steps_per_s=info["steps_per_sec"], first_loss=first,
                           last_loss=last, checkpoints=info["paths"]["checkpoints"])
    return out


def mmd_levels(cfg, dev, rounds: int, samples: int) -> tuple:
    """The MMD of uniform random bits and of data against data, in the
    eval's protocol (`rounds` x `samples`)."""
    from ctdd_tpu_torch.data.loaders import get_dataset
    from ctdd_tpu_torch.metrics.mmd import eval_mmd

    D = cfg.model.concat_dim
    dataset = get_dataset(cfg)
    uniform = eval_mmd(cfg, lambda g, n: torch.randint(0, 2, (n, D), generator=g, device=dev),
                       dataset, rounds, samples, device=dev)
    data = eval_mmd(cfg, lambda g, n: dataset.data[
        torch.randint(0, len(dataset), (n,), generator=g, device=dev).cpu().numpy()],
        dataset, rounds, samples, device=dev)
    return uniform, data


def d3pm_evals(dev, tmpdir: str, data_path: str, trained: dict):
    """(c) The eval CLI, the three started at once in threads: synthetic_d3pm's
    MMD (SYNTH_ROUNDS x 4096, T=500), protein_maze_d3pm's maze_acc
    (D3PM_MAZE_SAMPLES, T=1000) and one mnist_d3pm batch of 16 (save_samples,
    T=1000); returns a function that waits for them and holds them."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(3)
    mmd = pool.submit(run_cli, "eval", "--preset", "synthetic_d3pm", "--ckpt",
                      trained["synthetic_d3pm"]["checkpoints"], "--metric", "mmd",
                      "--rounds", str(SYNTH_ROUNDS), "--batch", "0")
    maze = pool.submit(run_cli, "eval", "--preset", "protein_maze_d3pm", "--ckpt",
                       trained["protein_maze_d3pm"]["checkpoints"], "--metric", "maze_acc",
                       "--samples", str(D3PM_MAZE_SAMPLES), "--batch", "0")
    path = f"{tmpdir}/d3pm_mnist_samples.npy"
    mnist = pool.submit(run_cli, "eval", "--preset", "mnist_d3pm", "--ckpt",
                        trained["mnist_d3pm"]["checkpoints"], "--metric", "save_samples",
                        "--samples", "16", "--out", path, "--set",
                        f"data.location={data_path}")

    def finish() -> dict:
        from ctdd_tpu_torch.config.presets import get_preset

        res = {"mmd synthetic_d3pm": last_json(mmd.result()),
               "maze_acc protein_maze_d3pm": last_json(maze.result()),
               "save_samples mnist_d3pm": last_json(mnist.result())}
        pool.shutdown()
        mmd_res, maze_res = res["mmd synthetic_d3pm"], res["maze_acc protein_maze_d3pm"]
        samples = np.load(path)
        uniform, data = mmd_levels(get_preset("synthetic_d3pm"), dev, SYNTH_ROUNDS, 4096)
        mmd_res.update(uniform_bits_mmd=uniform, data_vs_data_mmd=data)
        log(f"  eval save_samples mnist_d3pm (16, ancestral/1000): {samples.shape} in "
            f"[{samples.min()}, {samples.max()}]; eval mmd synthetic_d3pm ({SYNTH_ROUNDS} x "
            f"4096, ancestral/500): {mmd_res['value']:.6f}, uniform random bits "
            f"{uniform:.6f}, data vs data {data:.3e}; eval maze_acc protein_maze_d3pm "
            f"({D3PM_MAZE_SAMPLES}, ancestral/1000): {maze_res['value']:.4f} (not a quality "
            "figure); launches "
            + ", ".join(f"{k}: {r['kernel_launches']}" for k, r in res.items()))
        if samples.shape != (16, 784) or samples.min() < 0 or samples.max() > 255:
            raise AssertionError(f"mnist_d3pm eval: {res['save_samples mnist_d3pm']}")
        if not (data < mmd_res["value"] < uniform):
            raise AssertionError(f"synthetic_d3pm MMD not between data and uniform: {res}")
        if any(any(r["kernel_launches"].values()) for r in res.values()) or \
                not 0.0 <= maze_res["value"] <= 1.0:
            raise AssertionError(f"d3pm evals: {res}")
        return res

    return finish


def augment_checks(dev, tmpdir: str, data_path: str, cifar: str) -> dict:
    """(d) Rotation at (64, 1, 28, 28) and flip at (64, 3, 32, 32), card
    against CPU with the same angles and flips: the flip exact, the rotation
    exact but for tie pixels (a float64 source coordinate within
    AUGM_TIE_BAND of a half-integer), counted; then tauUnet_cifar10 (flip)
    and dit_mnist (rotation) through train() with data.use_augm, each step
    through the transform (counted by wrapping the loop's make_augment_fn)."""
    import ctdd_tpu_torch.training.loop as loop
    from ctdd_tpu_torch.data.augment import make_flip_fn, make_rotation_fn

    g = torch.Generator().manual_seed(3)
    x = torch.from_numpy(np.load(data_path)["x_train"][:64].reshape(64, -1).astype(np.int32))
    angles = torch.rand(64, generator=g) * 20.0 - 10.0
    rot = make_rotation_fn((1, 28, 28))
    want, got = rot(None, x, angles), rot(None, x.to(dev), angles.to(dev)).cpu()
    ang = angles.double().numpy() * (np.pi / 180.0)
    yy, xx = np.meshgrid(np.arange(28) - 13.5, np.arange(28) - 13.5, indexing="ij")
    c, s = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    tie = np.zeros((64, 28, 28), bool)
    for v in (c * yy - s * xx + 13.5, s * yy + c * xx + 13.5):
        tie |= np.abs(np.abs(v - np.floor(v)) - 0.5) < AUGM_TIE_BAND
    differ = (got != want).numpy().reshape(64, 28, 28)
    moved = float((want != x).float().mean())
    xc = torch.from_numpy(np.load(cifar)["x_train"][:64].reshape(64, -1).astype(np.int32))
    flips = torch.rand(64, generator=g) < 0.5
    flip = make_flip_fn((3, 32, 32))
    flip_same = torch.equal(flip(None, xc.to(dev), flips.to(dev)).cpu(), flip(None, xc, flips))
    log(f"  rotation (64, 1, 28, 28), card vs CPU: {int(differ.sum())} of {differ.size} pixels "
        f"differ, all at ties: {not (differ & ~tie).any()} ({int(tie.sum())} tie pixels; "
        f"{moved:.3f} of the pixels moved); flip (64, 3, 32, 32): equal {flip_same} "
        f"({int(flips.sum())} flipped)")
    if (differ & ~tie).any() or not flip_same or not moved > 0.01:
        raise AssertionError("augmentation: card vs CPU")
    out = dict(rotation_pixels_differ=int(differ.sum()), rotation_tie_pixels=int(tie.sum()),
               flip_equal=flip_same)
    calls = []
    made = loop.make_augment_fn

    def counting(cfg):
        fn = made(cfg)

        def aug(generator, batch, draws=None):
            calls.append(fn.__qualname__.split(".")[0])
            return fn(generator, batch, draws)

        return aug if fn is not None else None

    data = {"tauUnet_cifar10": cifar, "dit_mnist": data_path}
    loop.make_augment_fn = counting
    try:
        for preset, kind in (("tauUnet_cifar10", "make_flip_fn"),
                             ("dit_mnist", "make_rotation_fn")):
            cfg = image_cfg(tmpdir, preset, data, "_augm")
            cfg.data.use_augm = True
            calls.clear()
            _, info = loop.train(cfg, n_iters=AUGM_STEPS, seed=0, device=dev,
                                 log_every=AUGM_STEPS)
            log(f"  {preset} with data.use_augm: {AUGM_STEPS} train() steps at "
                f"B={cfg.data.batch_size}, {info['steps_per_sec']:.2f} steps/s, last loss "
                f"{info['step_losses'][-1]:.4f}; transform calls {len(calls)} ({set(calls)})")
            if calls != [kind] * AUGM_STEPS or not np.isfinite(info["step_losses"]).all():
                raise AssertionError(f"{preset} augmented: {calls}, {info['step_losses']}")
            out[preset] = dict(train_steps_per_s=info["steps_per_sec"],
                               transform_calls=len(calls))
    finally:
        loop.make_augment_fn = made
    return out


def d3pm_step_breakdown(dev, cfg, steps: int = D3PM_PROFILE_STEPS) -> dict:
    """(e) Where one mnist_d3pm ancestral step's time goes at batch 16, t=T/2:
    wall time, device time of the whole step (torch.profiler), of the UNet's
    forward and of the posterior product (16, 784, 256) x (16, 256, 256) in
    float32 alone (from a trace, or from a loop between CUDA events where the
    trace reads below the product's bound: its operations at the float32
    peak, or its bytes), the rest, launches and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from ctdd_tpu_torch.d3pm.diffusion import make_diffusion
    from ctdd_tpu_torch.models.base import create_model

    torch.manual_seed(4)
    model = create_model(cfg, device=dev)
    model.net.eval()
    diffusion = make_diffusion(cfg.model, device=dev)
    B, D, S = 16, cfg.model.concat_dim, cfg.data.S
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, S, (B, D), device=dev, generator=gen)
    t = torch.full((B,), cfg.model.num_timesteps // 2, device=dev, dtype=torch.long)

    def fn(xs, ts):
        return model.apply(model.net, xs, ts)

    flops = 2.0 * B * D * S * S
    nbytes = 4.0 * (B * D * S + B * S * S + B * D * S)
    post_bound_ms = max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    with torch.inference_mode():
        probs = torch.softmax(fn(x, t), dim=-1)
        unet_ms = device_ms(lambda: fn(x, t), 10)

        def product():
            return diffusion._at_onehot(diffusion.q_mats, t - 1, probs)

        # a trace that reads below the bound lost the launches: the loop's time
        post = dict(device_ms=device_ms(product, 20), loop_ms=cuda_ms(product, 20))
        post_ms = post["device_ms"] if post["device_ms"] >= post_bound_ms else post["loop_ms"]

        def run():
            xs = x
            for _ in range(steps):
                xs, _ = diffusion.p_sample(fn, xs, t, gen)
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
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    out = dict(batch=B, step_ms=step_ms, unet_ms=unet_ms, posterior_product_ms=post_ms,
               posterior_product_trace_ms=post["device_ms"],
               posterior_product_loop_ms=post["loop_ms"],
               posterior_product_gflop=flops / 1e9, posterior_product_bound_ms=post_bound_ms,
               device_busy_ms=busy_ms,
               rest_ms=busy_ms - unet_ms - post_ms if busy_ms else None,
               idle_share=1.0 - busy_ms / step_ms if busy_ms else None,
               device_kernels_per_step=sum(e.count for e in kernels) / steps,
               table_mb=2 * diffusion.q_mats.numel() * 4 / 1e6)
    log(f"  mnist_d3pm ancestral step at batch 16: {step_ms:.3f} ms wall; device busy "
        f"{busy_ms:.3f} ms: UNet forward {unet_ms:.3f} ms, posterior product {post_ms:.4f} ms "
        f"(trace {post['device_ms']:.4f}, loop {post['loop_ms']:.4f}; {flops / 1e9:.2f} GFLOP, "
        f"bound {post_bound_ms:.4f} ms), the rest "
        + (f"{out['rest_ms']:.3f} ms" if busy_ms else "not measured")
        + f"; {out['device_kernels_per_step']:.0f} device kernels per step; idle share "
        + (f"{out['idle_share']:.3f}" if busy_ms else "not measured")
        + f"; the two float32 tables {out['table_mb']:.0f} MB on the card")
    return out


def phase_d3pm(dev, tmpdir: str, data_path: str) -> dict:
    """Phase [18]: (b) the three D3PM presets through train(); then, beside
    (c)'s three eval CLIs (their times are not figures), (a) card vs CPU and
    (d) augmentation; alone, (e) the mnist_d3pm ancestral step's breakdown."""
    t0 = time.perf_counter()
    cifar = f"{tmpdir}/cifar_like.npz"
    if not os.path.exists(cifar):
        cifar_like(cifar)
    log(f"  (b) train(): mnist_d3pm twice ({DETERMINISM_STEPS} steps, one with the TauL grid), "
        f"synthetic_d3pm {D3PM_SYNTH_STEPS} steps, protein_maze_d3pm {D3PM_MAZE_STEPS} steps")
    out = {"training": d3pm_training(dev, tmpdir, data_path)}
    log("  (c) eval CLI: synthetic_d3pm mmd, protein_maze_d3pm maze_acc and one mnist_d3pm "
        "batch of 16, beside (a) and (d) (their times are not figures; (e) times the step)")
    finish = d3pm_evals(dev, tmpdir, data_path, out["training"])
    log("  (a) full width, B=2, card vs CPU")
    out["vs_cpu"] = d3pm_vs_cpu(dev)
    log("  (d) augmentation")
    out["augment"] = augment_checks(dev, tmpdir, data_path, cifar)
    out["evals"] = finish()
    log("  (e) one mnist_d3pm ancestral step at batch 16 under torch.profiler, alone")
    out["step"] = d3pm_step_breakdown(dev, d3pm_cfg(tmpdir, "mnist_d3pm", data_path))
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase [18]: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: data parallelism, the figure loggers and the loop's figures
# ---------------------------------------------------------------------------

DP_STEPS = 5  # (a) steps of each one-rank DP step against the single-device step
DP_TRAIN_STEPS = 10  # (b) train()'s DP branch over two ranks on the one card
DP_SAMPLER_STEPS = 100  # (c) fused TauL steps of the DP sampler (the preset's 1000, cut)
GRID_TRAIN_STEPS = 20  # (d) train() with its in-loop grid at the last step
DP_LOSS_RTOL = 1e-6  # (b) the 10th loss against the shard losses recomputed here


def params_digest(params) -> str:
    """sha256 of every parameter's bytes, in order."""
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def states_equal(a, b) -> bool:
    """Parameters, EMA and Adam's moments bit for bit, and the counters."""
    trees = ((a.params, b.params), (a.ema_params, b.ema_params),
             (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu))
    same = all(torch.equal(x[k], y[k]) for x, y in trees for k in a.params)
    return same and (a.step, a.opt_state.count, a.ema_num_updates) == \
        (b.step, b.opt_state.count, b.ema_num_updates)


class no_matplotlib:
    """Inside the block `import matplotlib` fails, as on a machine without
    it: the loggers and the loss curve take their PNG-only paths whatever
    this machine has installed."""

    def __enter__(self):
        self.saved = sys.modules.get("matplotlib", False)
        sys.modules["matplotlib"] = None
        return self

    def __exit__(self, *exc):
        if self.saved is False:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = self.saved


def dp_one_rank(dev, data_path: str, mesh) -> dict:
    """(a) On a one-rank NCCL group: make_dp_train_step and
    make_device_data_train_step against make_train_step and
    make_device_data_step, DP_STEPS steps at B=64 from the same weights under
    deterministic_training; parameters, EMA and moments bit-identical. A
    control that scales one gradient leaf by 1 + 2^-10 before the reduction
    must break the hold."""
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.parallel import dp
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import make_device_data_step, make_train_step
    from ctdd_tpu_torch.utils.device import deterministic_training

    cfg = full_cfg(fused=True)
    B, decay = cfg.data.batch_size, float(cfg.model.ema_decay)
    data = torch.from_numpy(np.load(data_path)["x_train"].reshape(-1, 784).astype(np.int32)).to(dev)

    def run(build, device_data: bool):
        model = create_model(cfg, device=dev)
        model.net.init_weights(torch.Generator().manual_seed(0))
        tx = get_optimizer(cfg)
        state = create_train_state(dict(model.net.named_parameters()), tx)
        step = build(model, get_loss(cfg), tx)
        for i in range(DP_STEPS):
            state, _ = step(state, data if device_data else data[i * B:(i + 1) * B], 0)
        return state

    builds = {
        "host batches": (lambda m, l, t: make_train_step(m, l, t, ema_decay=decay),
                         lambda m, l, t: dp.make_dp_train_step(m, l, t, mesh, ema_decay=decay)),
        "device data": (lambda m, l, t: make_device_data_step(m, l, t, B, ema_decay=decay),
                        lambda m, l, t: dp.make_device_data_train_step(m, l, t, mesh, B,
                                                                       ema_decay=decay)),
    }
    out = {}
    with deterministic_training(dev):
        for name, (single, parallel) in builds.items():
            device_data = name == "device data"
            want = run(single, device_data)
            out[name] = states_equal(run(parallel, device_data), want)
            if name == "host batches":
                real = dp.pmean

                def perturbed(mesh_, loss, grads):
                    next(iter(grads.values())).mul_(1.0 + 2.0 ** -10)
                    return real(mesh_, loss, grads)

                dp.pmean = perturbed
                try:
                    out["control: one leaf scaled before the reduction"] = states_equal(
                        run(parallel, device_data), want)
                finally:
                    dp.pmean = real
    log(f"  (a) one-rank {mesh.backend} group, {DP_STEPS} steps at B={B}, DP vs single "
        f"device bit-identical (params, EMA, moments, counters): {out}")
    if not (out["host batches"] and out["device data"]):
        raise AssertionError(f"one-rank DP differs from the single-device step: {out}")
    if out["control: one leaf scaled before the reduction"]:
        raise AssertionError("the DP hold passed a gradient perturbed before the reduction")
    return out


def _dp_train_rank(rank: int, world: int, port: int, tmpdir: str, data_path: str,
                   device: str):
    """(b) One rank of train()'s DP branch on `device`, the card the ranks
    share (gloo): its parameters' digest after every step, its step losses
    and rate, to `tmpdir/dp_rank<r>.json`."""
    from ctdd_tpu_torch.parallel.dryrun import join_group
    from ctdd_tpu_torch.training import loop

    mesh = join_group(rank, world, port, device)
    digests = []
    made = loop.make_device_data_train_step

    def recording(*args, **kwargs):
        step = made(*args, **kwargs)

        def rec(state, data, seed):
            state, lv = step(state, data, seed)
            digests.append(params_digest(state.params))
            return state, lv

        return rec

    loop.make_device_data_train_step = recording
    try:
        cfg = train_cfg(tmpdir, data_path, "dp_two_ranks")
        cfg.sampler.sample_freq = 0
        cfg.saving.checkpoint_freq = DP_TRAIN_STEPS - 1
        _, info = loop.train(cfg, n_iters=DP_TRAIN_STEPS, seed=0, mesh=mesh,
                             log_every=DP_TRAIN_STEPS)
        with open(f"{tmpdir}/dp_rank{rank}.json", "w") as f:
            json.dump(dict(device=str(mesh.device), backend=mesh.backend, digests=digests,
                           step_losses=info["step_losses"],
                           steps_per_sec=info["steps_per_sec"], paths=info["paths"]), f)
    finally:
        torch.distributed.destroy_process_group()


def dp_two_ranks(dev, tmpdir: str, data_path: str) -> dict:
    """(b) Two processes on the one card over gloo run train()'s DP branch
    (the dataset on the device: make_device_data_train_step, 32 rows a rank
    of the global 64): parameters bit-identical after every step, rank 0's
    checkpoints alone, and the last step's loss against the mean of the two
    shard losses recomputed here from rank 0's checkpoint before it."""
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.parallel.dryrun import spawn
    from ctdd_tpu_torch.training.train_step import make_loss_fn, step_generator
    from ctdd_tpu_torch.utils.bookkeeping import load_checkpoint
    from ctdd_tpu_torch.utils.device import deterministic_training

    t0 = time.perf_counter()
    spawn(_dp_train_rank, 2, tmpdir, data_path, dev.type)
    seconds = time.perf_counter() - t0
    ranks = [json.load(open(f"{tmpdir}/dp_rank{r}.json")) for r in range(2)]
    same_steps = [a == b for a, b in zip(ranks[0]["digests"], ranks[1]["digests"])]
    paths = ranks[0]["paths"]
    runs = os.listdir(os.path.dirname(paths["root"]))
    ckpts = sorted(os.listdir(paths["checkpoints"]), key=lambda f: int(f.split(".")[0]))

    cfg = train_cfg(tmpdir, data_path, "dp_recompute")
    model = create_model(cfg, device=dev)
    before = load_checkpoint(f"{paths['checkpoints']}/{DP_TRAIN_STEPS - 1}.pt",
                             map_location=dev)["params"]
    data = torch.from_numpy(np.load(data_path)["x_train"].reshape(-1, 784).astype(np.int32)).to(dev)
    loss_fn = make_loss_fn(model, get_loss(cfg))
    shard_losses = []
    with deterministic_training(dev):
        for r in range(2):
            gen = step_generator(0, DP_TRAIN_STEPS - 1, dev, rank=r)
            idx = torch.randint(0, data.shape[0], (cfg.data.batch_size // 2,), generator=gen,
                                device=dev)
            shard_losses.append(float(loss_fn(before, data[idx], gen, None, DP_TRAIN_STEPS - 1)))
    logged = ranks[0]["step_losses"][-1]
    mean = (shard_losses[0] + shard_losses[1]) / 2
    rel = abs(logged - mean) / abs(mean)
    out = dict(seconds=seconds, ranks_on=[r["device"] for r in ranks],
               backend=ranks[0]["backend"], bit_identical_every_step=all(same_steps),
               steps=len(same_steps), logged_last_loss=logged, shard_losses=shard_losses,
               last_loss_rel_err=rel, run_folders=len(runs), checkpoints=ckpts,
               steps_per_s_rank0=ranks[0]["steps_per_sec"],
               steps_per_s_rank1=ranks[1]["steps_per_sec"])
    log(f"  (b) train() on 2 ranks ({out['ranks_on']}, {out['backend']}), {DP_TRAIN_STEPS} "
        f"steps at global B={cfg.data.batch_size}: parameters bit-identical after every "
        f"step: {same_steps}; last loss {logged:.6f} vs the mean of the shard losses "
        f"{mean:.6f} (rel {rel:.2e}, limit {DP_LOSS_RTOL:.0e}); run folders {len(runs)}, "
        f"checkpoints {ckpts}; {out['steps_per_s_rank0']:.3f} / "
        f"{out['steps_per_s_rank1']:.3f} steps/s (ranks 0 / 1); {seconds:.1f} s with the "
        "processes' start")
    if len(same_steps) != DP_TRAIN_STEPS or not all(same_steps):
        raise AssertionError(f"the ranks' parameters differ: {same_steps}")
    if ranks[0]["step_losses"] != ranks[1]["step_losses"]:
        raise AssertionError("the ranks logged different losses")
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"the last loss is not the mean of the shard losses: {out}")
    if len(runs) != 1 or ckpts != [f"{DP_TRAIN_STEPS - 1}.pt", f"{DP_TRAIN_STEPS}.pt"]:
        raise AssertionError(f"checkpoints beyond rank 0's: {runs}, {ckpts}")
    return out


def dp_sampler(dev, mesh) -> dict:
    """(c) make_dp_sampler on the one-rank group: N=16, fused TauL for
    DP_SAMPLER_STEPS steps, exactly one fused launch a step, samples
    bit-identical to sampler.sample from the same rank-keyed generator."""
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.parallel.dp import make_dp_sampler, rank_generator
    from ctdd_tpu_torch.sampling.samplers import get_sampler
    from ctdd_tpu_torch.utils.device import deterministic_training

    cfg = full_cfg(fused=True)
    cfg.sampler.num_steps = DP_SAMPLER_STEPS
    model = create_model(cfg, device=dev)
    model.net.init_weights(torch.Generator().manual_seed(0))
    model.net.eval()
    sampler = get_sampler(cfg)
    sample = make_dp_sampler(sampler, mesh)
    with deterministic_training(dev):  # the two runs' network calls bit for bit
        sample(model, model.net, 1, 16)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, launches = counted(lambda: sample(model, model.net, 11, 16))
        seconds = time.perf_counter() - t0
        want, _ = sampler.sample(model, model.net, rank_generator(11, 0, dev), 16)
    out = dict(launches=launches, seconds=seconds, samples_per_s=16 / seconds,
               step_ms=seconds * 1e3 / DP_SAMPLER_STEPS, equal=bool(np.array_equal(got, want)))
    log(f"  (c) DP sampler, 1 rank, N=16, fused TauL/{DP_SAMPLER_STEPS}: {seconds:.3f} s "
        f"({out['step_ms']:.3f} ms a step, {out['samples_per_s']:.3f} samples/s); launches "
        f"{launches}; bit-identical to sampler.sample: {out['equal']}")
    if launches != {"fused_tau_leap_update": DP_SAMPLER_STEPS, "reverse_rates": 0,
                    "euler_posterior": 0}:
        raise AssertionError(f"DP sampler launches {launches}")
    if not out["equal"] or got.shape != (16, 784):
        raise AssertionError("the DP sampler's samples differ from sampler.sample's")
    return out


def logger_figures(dev, tmpdir: str, data_path: str) -> dict:
    """(d) Both loggers on the card with NumpyWriter and no matplotlib: each
    PNG read back through zlib equals its panels; train() for
    GRID_TRAIN_STEPS steps with its in-loop grid (TauL/100) leaves
    samples_<n>.png beside the .npy and prints the loss-curve line."""
    import contextlib
    import io

    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.loggers import loggers as L
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.training.loop import train
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.utils.bookkeeping import NumpyWriter
    from ctdd_tpu_torch.utils.png import read_png

    out, writer = {}, NumpyWriter(f"{tmpdir}/loggers")
    images = np.load(data_path)["x_train"][:4].reshape(4, 1, 28, 28)
    notes_cfg = get_preset("pianoroll_cond")
    notes = np.random.default_rng(3).integers(0, notes_cfg.data.S, (2, 256))
    with no_matplotlib():
        for name, cfg, batch in (("denoisingImages", full_cfg(fused=True), images),
                                 ("ConditionalDenoisingNoteSeq", notes_cfg, notes)):
            model = create_model(cfg, device=dev)
            model.net.init_weights(torch.Generator().manual_seed(0))
            state = create_train_state(dict(model.net.named_parameters()), get_optimizer(cfg))
            state.step = GRID_TRAIN_STEPS
            t0 = time.perf_counter()
            panels = L.get_logger(name)(state=state, cfg=cfg, writer=writer, minibatch=batch,
                                        model=model)
            seconds = time.perf_counter() - t0
            img = read_png(f"{tmpdir}/loggers/{name}_{GRID_TRAIN_STEPS}.png")
            want = (L.denoising_grid(panels, tuple(cfg.data.shape), cfg.data.S)
                    if name == "denoisingImages" else L.noteseq_grid(panels, cfg.data.S))
            out[name] = dict(png_shape=list(img.shape), seconds=seconds,
                             equal=bool(img.shape == want.shape and (img == want).all()))
            log(f"  (d) {name}: {seconds:.3f} s on the card; its PNG {img.shape} read back "
                f"equal to the panels: {out[name]['equal']}")
            if not out[name]["equal"]:
                raise AssertionError(f"{name}'s PNG differs from its panels")

        cfg = train_cfg(tmpdir, data_path, "grid19")
        cfg.sampler.sample_freq = cfg.saving.checkpoint_freq = GRID_TRAIN_STEPS
        cfg.sampler.num_steps = 100
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            (_, info), launches = counted(lambda: train(cfg, n_iters=GRID_TRAIN_STEPS, seed=0,
                                                        device=dev, log_every=10))
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"    {line}")
    pngs, root = info["paths"]["pngs"], info["paths"]["root"]
    samples = np.load(f"{pngs}/samples_{GRID_TRAIN_STEPS}.npy")
    grid = read_png(f"{pngs}/samples_{GRID_TRAIN_STEPS}.png")
    out["train_grid"] = dict(
        launches=launches, grid_png_shape=list(grid.shape),
        grid_equal=bool((grid == L.sample_grid(samples, (1, 28, 28), 256)).all()),
        loss_curve_line=[s for s in lines if s.startswith("loss curve:")],
        loss_curve_png=os.path.exists(f"{root}/loss_curve.png"),
        steps_per_s=info["steps_per_sec"])
    log(f"  (d) train() {GRID_TRAIN_STEPS} steps, grid TauL/100: launches {launches}; "
        f"samples_{GRID_TRAIN_STEPS}.png {grid.shape} beside the .npy, equal to its "
        f"samples: {out['train_grid']['grid_equal']}; loss curve: "
        f"{out['train_grid']['loss_curve_line']}")
    if launches != {"fused_tau_leap_update": 100, "reverse_rates": 0, "euler_posterior": 0}:
        raise AssertionError(f"in-loop grid launches {launches}")
    if not out["train_grid"]["grid_equal"] or grid.shape != (4 * 28, 4 * 28):
        raise AssertionError("the in-loop PNG grid differs from its samples")
    if len(out["train_grid"]["loss_curve_line"]) != 1 or out["train_grid"]["loss_curve_png"]:
        raise AssertionError(f"the loss-curve line: {out['train_grid']}")
    return out


def d3pm_table_build(preset: str = "mnist_d3pm") -> dict:
    """Seconds of the host build of a D3PM preset's tables alone (the
    process's cache cleared first), on whatever runs this."""
    from ctdd_tpu_torch.config.presets import get_preset
    from ctdd_tpu_torch.d3pm import diffusion as D

    m = get_preset(preset).model
    betas = np.asarray(D.get_diffusion_betas(m), np.float64)
    D._host_tables.cache_clear()
    t0 = time.perf_counter()
    D._host_tables(betas.tobytes(), m.transition_mat_type, m.transition_bands,
                   m.num_pixel_vals)
    return dict(preset=preset, seconds=time.perf_counter() - t0, cores=os.cpu_count())


def phase_parallel(dev, tmpdir: str, data_path: str) -> dict:
    """Phase [19]: (e)'s dry run starts first, on the CPU, beside (a), (c)
    and (d) on the card; (b) runs alone after them, since it reports a rate."""
    from ctdd_tpu_torch.parallel.dryrun import free_port
    from ctdd_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    t0 = time.perf_counter()
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "ctdd_tpu_torch.parallel.dryrun", "--nprocs", "2",
         "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    out = {}
    try:
        initialize_multihost(f"localhost:{free_port()}", 1, 0, device=dev)
        try:
            mesh = make_mesh(1, device=dev)
            out["one_rank"] = dp_one_rank(dev, data_path, mesh)
            out["sampler"] = dp_sampler(dev, mesh)
        finally:
            torch.distributed.destroy_process_group()
        out["loggers"] = logger_figures(dev, tmpdir, data_path)
        stdout, stderr = dryrun.communicate(timeout=300)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
    ok = [s for s in stdout.splitlines() if s.startswith("dryrun_multichip(2) ok")]
    out["dryrun"] = dict(returncode=dryrun.returncode, line=ok)
    log(f"  (e) python -m ctdd_tpu_torch.parallel.dryrun --nprocs 2 --device cpu: exit "
        f"{dryrun.returncode}, {ok}")
    if dryrun.returncode != 0 or not ok:
        raise AssertionError(f"the dry run failed:\n{stdout[-2000:]}\n{stderr[-4000:]}")
    out["d3pm_tables"] = d3pm_table_build()
    log(f"  (e) mnist_d3pm's host table build alone: {out['d3pm_tables']['seconds']:.2f} s "
        f"on {out['d3pm_tables']['cores']} host cores")
    out["two_ranks"] = dp_two_ranks(dev, tmpdir, data_path)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase [19]: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the 3xTF32 GEMM (kernel 4) at the SDAR cell's shapes
# ---------------------------------------------------------------------------

# (product, M, N, K) of the cell's forwards (B = 4, L = 4096, 2L positions);
# each also runs as its input's and its weight's gradient
DENSE_SHAPES = [("qkv", 32768, 5120, 2048), ("o", 32768, 2048, 4096),
                ("head", 16384, 18992, 2048)]
RAGGED_SHAPE = ("ragged", 130, 324, 96)  # off every tile in M, N and K


def dense_forms(M, N, K, dev):
    """A linear layer's three products at forward shape (M, N, K), as
    `Dense` hands them to the kernel: {form: (a, b)}."""
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    x = torch.randn(M, K, device=dev, generator=g)
    w = torch.randn(N, K, device=dev, generator=g)
    gy = torch.randn(M, N, device=dev, generator=g)
    return {"forward": (x, w.t()), "input_grad": (gy, w), "weight_grad": (gy.t(), x)}


def hold_dense(what, a, b, c) -> dict:
    """Kernel output `c` = a @ b against float64 on its first and last 256
    rows, beside cuBLAS float32 and single TF32 on the same rows."""
    saved = torch.backends.cuda.matmul.allow_tf32
    worst = dict(err=0.0, cublas_err=0.0, tf32_err=math.inf)
    try:
        for rows in (slice(0, 256), slice(-256, None)):
            want = a[rows].double() @ b.double()
            scale = want.abs().max()
            errs = {}
            for key, tf32 in (("cublas_err", False), ("tf32_err", True)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                errs[key] = float(((a[rows] @ b).double() - want).abs().max() / scale)
            errs["err"] = float((c[rows].double() - want).abs().max() / scale)
            if not (math.isfinite(errs["err"]) and errs["err"] <= 4.0 * errs["cublas_err"]
                    and errs["tf32_err"] > 100.0 * errs["err"]):
                raise AssertionError(f"3xTF32 {what} rows {rows}: {errs} (want at most 4x "
                                     "cuBLAS float32, more than 100x below single TF32)")
            worst = dict(err=max(worst["err"], errs["err"]),
                         cublas_err=max(worst["cublas_err"], errs["cublas_err"]),
                         tf32_err=min(worst["tf32_err"], errs["tf32_err"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return worst


def phase_dense(dev) -> dict:
    """Kernel 4 held to float64 at every shape the SDAR cell gives it, then
    timed: the kernel and the plain version (`matmul_plain`, the same split
    in PyTorch) by `timed`, cuBLAS float32 (TF32 off) as the library's
    yardstick. The launch counter is zeroed here and read back."""
    from ctdd_tpu_torch.ops import tf32x3_gemm as tg

    tg.matmul.launches = 0
    products, held = {}, 0
    for name, M, N, K in DENSE_SHAPES + [RAGGED_SHAPE]:
        for form, (a, b) in dense_forms(M, N, K, dev).items():
            c = tg.matmul(a, b)
            held += 1
            err = hold_dense(f"{name} {form} {tuple(a.shape)} @ {tuple(b.shape)}", a, b, c)
            rec = dict(shape=[a.shape[0], b.shape[1], a.shape[1]], **err)
            if name != "ragged":
                flops = 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
                rec.update(within_bound(dict(
                    **timed(lambda: tg.matmul(a, b), lambda: tg.matmul_plain(a, b), 10),
                    bound_ms=flops / (TF32_FLOP_PER_S / 3) * 1e3, bound_by="operations",
                    flops=flops)))
                saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    rec["library_ms"] = device_ms(lambda: a @ b, 10) or cuda_ms(lambda: a @ b, 10)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                log(f"  {name} {form} (M, N, K) = {tuple(rec['shape'])}: {rec['ms']:.3f} ms "
                    f"by {rec['timed_by']}, bound {rec['bound_ms']:.3f} ms, cuBLAS float32 "
                    f"{rec['library_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms; error "
                    f"{err['err']:.3g} ({err['err'] / err['cublas_err']:.2f}x cuBLAS float32, "
                    f"single TF32 {err['tf32_err'] / err['err']:.0f}x)")
            else:
                log(f"  ragged {form} (M, N, K) = {tuple(rec['shape'])}: error {err['err']:.3g} "
                    f"({err['err'] / err['cublas_err']:.2f}x cuBLAS float32)")
            products[f"{name}_{form}"] = rec
            del c
    if tg.matmul.launches < held:
        raise AssertionError(f"3xTF32: {tg.matmul.launches} launches counted for {held} "
                             "products held")
    timed_products = [r for r in products.values() if "ms" in r]
    record = {
        "name": "tf32x3_gemm", "route": "cuda", "source": "ctdd_tpu_torch/csrc/tf32x3_gemm.cu",
        "replaces": None, "launches": tg.matmul.launches, "held_products": held,
        "max_rel_err": max(r["err"] for r in products.values()),
        "max_err_over_cublas": max(r["err"] / r["cublas_err"] for r in products.values()),
        "min_tf32_over_err": min(r["tf32_err"] / r["err"] for r in products.values()),
        "ms": sum(r["ms"] for r in timed_products),
        "bound_ms": sum(r["bound_ms"] for r in timed_products),
        "library_ms": sum(r["library_ms"] for r in timed_products),
        "plain_ms": sum(r["plain_ms"] for r in timed_products),
        "bound_by": "operations", "timed_by": timed_products[0]["timed_by"],
        "products": products,
    }
    log(dense_line(record))
    return record


def dense_line(k: dict) -> str:
    """Kernel 4's `kernels` line: the cell's nine products summed, and the
    worst accuracy over every product held."""
    return (f"kernels {k['name']}: launches {k['launches']} ({k['held_products']} products "
            f"held to float64), max rel err {k['max_rel_err']:.3g} (at most "
            f"{k['max_err_over_cublas']:.2f}x cuBLAS float32's, single TF32 at least "
            f"{k['min_tf32_over_err']:.0f}x worse); the cell's 9 products {k['ms']:.3f} ms, "
            f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}), cuBLAS float32 "
            f"{k['library_ms']:.3f} ms, plain {k['plain_ms']:.3f} ms; times by {k['timed_by']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    from ctdd_tpu_torch.ops import _build

    def stage(title: str):
        """A phase's header, with the seconds since the start."""
        log(f"{title} [{time.perf_counter() - t_start:.0f} s in]")

    stage("[1] device")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    stage("[2] build")
    t0 = time.perf_counter()
    reports = _build.build(["fused_tau_leap", "reverse_rates", "euler_posterior",
                            "tf32x3_gemm"])
    seconds = time.perf_counter() - t0
    for name, rep in reports.items():
        log(f"  {name}: {ptxas_summary(rep)}")
    log(f"  built in {seconds:.2f} s")
    for name in reports:
        ops = _build.tensor_core_ops(name)
        log(f"  {name}: tensor-core MMA ops in the binary: "
            + ("not checked (no cuobjdump)" if ops is None else
               ", ".join(f"{n} x {op}" for op, n in sorted(ops.items())) or "none"))

    stage("[3] fused tau-leap kernel vs plain version")
    max_err, flip_frac = phase_kernels(dev)

    stage("[4] timing")
    timing = phase_timing(dev)

    stage("[8] reverse-rates and Euler-posterior kernels vs plain versions")
    rate_err = phase_rate_kernels(dev)

    stage("[9] timing of the rate kernels")
    rate_timing = phase_rate_timing(dev)

    stage("[20] 3xTF32 GEMM at the SDAR cell's shapes")
    dense = phase_dense(dev)

    if "--kernels-only" in sys.argv[1:]:
        log(f"  kernels only: {time.perf_counter() - t_start:.1f} s")
        return 0

    stage("[5] UNet, tau-leap and LBJF steps, card vs CPU")
    phase_unet(dev)

    stage("[6] TauL step breakdown")
    breakdown = phase_step_breakdown(
        dev, full_cfg(fused=True), {"fused_kernel_ms": "fused_tau_leap"})

    stage("[10] LBJF step breakdown")
    lbjf_breakdown = phase_step_breakdown(
        dev, full_cfg(fused=False, sampler="LBJF"),
        {"reverse_rates_kernel_ms": "reverse_rates_kernel",
         "euler_posterior_kernel_ms": "euler_posterior_kernel"})

    with tempfile.TemporaryDirectory() as tmpdir:
        stage("[7] serving: the flagship, fused TauL")
        launches, elapsed = phase_serving(dev, tmpdir)
        stage("[11] serving: LBJF with a corrector, MidPointTauL, maze")
        served = phase_serving_slice2(dev, tmpdir)
        stage("[12] training: the flagship at full width, and serving what it trained")
        data_path = mnist_like(f"{tmpdir}/mnist_like.npz")
        log("  (a) one step, card vs CPU")
        step_check = phase_train_step(dev, data_path)
        log("  (b) train() 100 steps with the in-loop grid, (c) resume, (d) serve")
        trained = phase_training(dev, tmpdir, data_path)
        stage("[13] scoring: the eval and bench CLIs")
        log("  (a) InceptionV3, card vs CPU")
        npz = random_inception_npz(f"{tmpdir}/inception_random.npz")
        inception = phase_inception(dev, npz, data_path)
        log("  (b) mlp_synthetic trained by the train CLI, its MMD by the eval CLI, beside "
            "(c) the FIDs of the flagship trained in [12] (at once since phase [16] came: "
            "their wall times are not figures)")
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as pool:
            mmd_run = pool.submit(phase_mmd, dev, tmpdir)
            fid = phase_fid(trained["checkpoints"], data_path, npz)
            mmd = mmd_run.result()
        log(f"  (d) the bench CLI at {BENCH_STEPS} sampler steps")
        bench = phase_bench(BENCH_STEPS)
        stage("[14] the SDDM hollow family at full width, and the flagship's bf16 compute")
        hollow = phase_hollow(dev, tmpdir, data_path, trained["record"])
        stage("[15] the maze, sudoku and protein presets: data generators, DDSM networks, "
            "the fresh-pool stream")
        maze_sudoku, pools = phase_maze_sudoku(dev, tmpdir, data_path)
        stage("[16] the rest of the samplers, the EBM and the prefix-conditional path; "
            "determinism of train()")
        slice8 = phase_slice8(dev, tmpdir, data_path, pools)
        stage("[17] the DiT, U-ViT and CIFAR10 image presets and the label-conditional "
              "path")
        slice9 = phase_slice9(dev, tmpdir, data_path)
        stage("[18] the D3PM baseline (mnist_d3pm, synthetic_d3pm, protein_maze_d3pm) and "
              "on-device augmentation")
        d3pm = phase_d3pm(dev, tmpdir, data_path)
        stage("[19] data parallelism, the figure loggers and the loop's figures")
        parallel = phase_parallel(dev, tmpdir, data_path)

    by_request = {"tauUnet_mnist TauL fused n=16": launches,
                  **{label: counts for label, (counts, _) in served.items()},
                  "train() in-loop grid at step 100": trained["grid_launches"],
                  "tauUnet_mnist trained 100 steps n=16": trained["served_launches"],
                  "eval mmd mlp_synthetic 25x4096": mmd["kernel_launches"],
                  **{f"eval fid {kind} 256": r["kernel_launches"] for kind, r in fid.items()},
                  f"bench {BENCH_STEPS} steps N=256": bench["extras"]["kernel_launches"],
                  f"holvisual_mnist trained {HOLLOW_TRAIN_STEPS} steps n=16":
                      hollow["serving"]["launches"],
                  **{f"eval mmd {p} {SYNTH_ROUNDS}x4096": r["kernel_launches"]
                     for p, r in hollow["synthetic"].items()},
                  "eval sudoku_acc 256": maze_sudoku["sudoku"]["kernel_launches"],
                  "eval maze_acc tauUnet_maze 64": maze_sudoku["maze"]["kernel_launches"],
                  f"hollow_maze trained {FAMILY_STEPS} steps n=16":
                      maze_sudoku["family"]["hollow_maze"]["served_launches"],
                  "hollow_protein sampled n=16":
                      maze_sudoku["family"]["hollow_protein"]["sampled_launches"],
                  **{f"tauUnet_mnist {name} n=16 {PC_STEPS} steps, corrector": r["launches"]
                     for name, r in slice8["pc_samplers"].items()},
                  f"eval cond_mmd pianoroll_cond {COND_SAMPLES}":
                      slice8["pianoroll_cond"]["cond_mmd"]["kernel_launches"],
                  f"pianoroll_cond ConditionalLBJF n={COND_LBJF_BATCH}":
                      slice8["pianoroll_cond"]["conditional_lbjf"]["launches"],
                  **{f"eval mmd ebm_synthetic {name} {EBM_ROUNDS}x{EBM_SAMPLES}":
                     res["kernel_launches"]
                     for name, res in slice8["ebm_synthetic"]["mmd"].items()},
                  f"tauUnet_cifar10 trained {DETERMINISM_STEPS} steps n=16":
                      slice9["tauUnet_cifar10"]["served_launches"],
                  f"eval fid lenet tauUnet_cifar10 {FID_LENET_SAMPLES}":
                      slice9["fid_lenet"]["kernel_launches"],
                  f"dit_mnist guided n=16 {CFG_STEPS} steps":
                      slice9["dit_mnist"]["guided_batch"]["launches"],
                  f"dit_mnist guided /generate n=16 {CFG_STEPS} steps":
                      slice9["dit_mnist"]["generate_launches"],
                  "bin_mnist_hollow LBJF n=16": slice9["bin_mnist_hollow"]["lbjf"]["launches"],
                  f"mnist_d3pm train() in-loop grid TauL/{D3PM_GRID_STEPS} n=16":
                      d3pm["training"]["mnist_d3pm"]["grid_launches"],
                  **{f"eval {name}": r["kernel_launches"]
                     for name, r in d3pm["evals"].items()},
                  f"DP sampler 1 rank n=16 TauL/{DP_SAMPLER_STEPS}":
                      parallel["sampler"]["launches"],
                  f"train() in-loop PNG grid at step {GRID_TRAIN_STEPS} TauL/100":
                      parallel["loggers"]["train_grid"]["launches"]}

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

    rr = rate_timing["reverse_rates"]
    # the posterior's headline fields are its draw mode's, the sampler's
    # path; its log-prob mode's sit under `logprob_*`
    ep = {key: draw_first(t) for key, t in rate_timing["euler_posterior"].items()}

    def shapes(timings):
        """The named shapes' times (sudoku's, pianoroll_cond's, the EBM's)."""
        return {f"{key}_{field}": timings[key][src]
                for key in ("sudoku", "pianoroll", "ebm")
                for field, src in (("shape", "shape"), ("ms", "ms"), ("loop_ms", "loop_ms"),
                                   ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                                   ("bound_by", "bound_by"))}

    s9 = dict(slice9["kernels"]["timing"])
    s9["euler_posterior"] = {key: draw_first(t) for key, t in s9["euler_posterior"].items()}

    def mode_fields(timings, keys):
        """The posterior's log-prob mode, injected-noise draw and replaced
        chain fields, per shape."""
        return {f"{prefix}{field}": t[field]
                for key, prefix in keys for t in [timings[key]]
                for field in t if field.startswith(("logprob_", "draw_", "unfused_"))}

    def slice9_shapes(name):
        """This kernel's times at slice 9's shapes (CIFAR10's D=3072 at
        N=16, and N=256 for the fused kernel; bin_mnist_hollow's S=2)."""
        return {f"{key}_{field}": t[field]
                for key, t in s9[name].items()
                for field in ("shape", "ms", "loop_ms", "plain_ms", "bound_ms", "bound_by")}

    record = {"kernels": [
        entry("fused_tau_leap_update", "ctdd_tpu_torch/csrc/fused_tau_leap.cu",
              "ctdd_tpu/ops/fused_update.py:170", max_err, timing[256], timing[16],
              max_flip_frac=max(flip_frac, slice9["kernels"]["fused_flip_frac"]),
              expected_mode_ms=timing[256]["expected_mode_ms"],
              expected_jumps_per_row=timing[256]["expected_jumps_per_row"],
              **{f"cifar{k}": v for k, v in slice9_shapes("fused_tau_leap_update").items()}),
        entry("reverse_rates", "ctdd_tpu_torch/csrc/reverse_rates.cu",
              "ctdd_tpu/ops/pallas_kernels.py:81", max(rate_err["rate_abs"],
                                                      slice9["kernels"]["worst"]["rate_abs"]),
              rr[256], rr[16], max_row_rel_err=max(rate_err["rate_row_rel"],
                                                   slice9["kernels"]["worst"]["rate_row_rel"]),
              **shapes(rr), **{k: v for k, v in slice9_shapes("reverse_rates").items()
                               if k.startswith("cifar")}),
        entry("euler_posterior", "ctdd_tpu_torch/csrc/euler_posterior.cu",
              "ctdd_tpu/ops/pallas_kernels.py:137", max(rate_err["post_prob"],
                                                       slice9["kernels"]["worst"]["post_prob"]),
              ep[256], ep[16], max_log_err=max(rate_err["post_log"],
                                               slice9["kernels"]["worst"]["post_log"]),
              **shapes(ep), **{k: v for k, v in slice9_shapes("euler_posterior").items()
                               if k.startswith("binmnist")},
              **mode_fields(ep, ((256, ""), (16, "serving_"), ("sudoku", "sudoku_"),
                                 ("pianoroll", "pianoroll_"), ("ebm", "ebm_"))),
              **mode_fields(s9["euler_posterior"], (("binmnist", "binmnist_"),)),
              draw_near_ties=rate_err["draw_near_ties"], draw_rows=rate_err["draw_rows"],
              draw_differ=rate_err["draw_differ"],
              draw_statistics_max_z=max(v["max_z"]
                                        for v in rate_err["draw_statistics"].values())),
    ]}
    for k in record["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"no served request launched {k['name']}")
    record["kernels"].append(dense)
    log("serving: " + json.dumps({
        "samples_per_s": 16 / elapsed, "batch": 16, "steps": 1000,
        **breakdown}))
    log("serving_lbjf: " + json.dumps({
        "samples_per_s": 16 / served["tauUnet_mnist LBJF corrector"][1],
        "batch": 16, "steps": SERVE_CUT_STEPS, "corrector_steps": 2, **lbjf_breakdown}))
    log("serving_other: " + json.dumps({
        label: {"samples_per_s": 16 / secs, "seconds": secs}
        for label, (_, secs) in served.items()}))
    log("training: " + json.dumps({**trained["record"], "step_vs_cpu": step_check,
                                   "card": card_line()}))
    log("scoring: " + json.dumps({"inception": inception, "mmd": mmd, "fid": fid,
                                  "bench": bench, "card": card_line()}))
    log("hollow: " + json.dumps({**hollow, "card": card_line()}))
    log("maze_sudoku_protein: " + json.dumps({**maze_sudoku, "card": card_line()}))
    log("slice8: " + json.dumps({**slice8, "card": card_line()}))
    log("slice9: " + json.dumps({**slice9, "card": card_line()}))
    log("d3pm: " + json.dumps({**d3pm, "card": card_line()}))
    log("parallel: " + json.dumps({**parallel, "card": card_line()}))
    for k in record["kernels"][:-1]:
        log(f"kernels {k['name']}: launches {k['launches']}, max diff "
            f"{k['max_abs_err']:.3g}, {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}) at N=256; "
            f"{k['serving_ms']:.4f} ms ({k['serving_loop_ms']:.4f} ms per turn of a loop), "
            f"plain {k['serving_plain_ms']:.4f} ms, bound "
            f"{k['serving_bound_ms'] * 1e3:.1f} us ({k['serving_bound_by']}) at N=16, "
            f"{k['serving_step_device_ms']:.4f} ms of device time inside a step; "
            f"times by {k['timed_by']}"
            + (f"; these are the draw mode's; the log-prob mode {k['logprob_ms']:.4f} ms "
               f"(bound {k['logprob_bound_ms'] * 1e3:.1f} us) and the chain the draw "
               f"replaced {k['unfused_ms']:.4f} ms at N=256, {k['serving_logprob_ms']:.4f} ms "
               f"(bound {k['serving_logprob_bound_ms'] * 1e3:.1f} us) and "
               f"{k['serving_unfused_ms']:.4f} ms at N=16"
               if "logprob_ms" in k else ""))
    log(dense_line(dense))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
