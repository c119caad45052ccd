"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any fault exits non-zero; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA kernel of the port from csrc/, in parallel
  3. kernels  fused tau-leap kernel vs its plain PyTorch version on the card
  4. timing   kernel, plain version and bound at N=256, D=784, S=256
  5. unet     full-width logits on the card vs the port's CPU logits, and
              tau-leap steps on the card vs the CPU with the same uniforms
  6. steps    where a batch-16 sampler step's time goes (torch.profiler)
  7. serving  a seeded full-width checkpoint served over HTTP: two 1000-step
              batches of the flagship sampler with the fused update
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
MAX_FLIP_FRAC = 1e-3  # kernel vs plain: rounding ties under another sum order
STEP_FLIP_FRAC = 5e-3  # whole steps, card vs CPU: network logits differ too


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


# ---------------------------------------------------------------------------
# phase 3/4 inputs: real GaussianTargetRate tables at one sampler step
# ---------------------------------------------------------------------------


def fused_inputs(N, D, S, step, seed, dev):
    from ctdd_tpu_torch.ops.forward_process import make_gaussian_target
    from ctdd_tpu_torch.sampling.samplers import _shared_mats, _time_grid

    proc = make_gaussian_target(S, 6.0, 512.0, 3.0, 100.0, device=dev)
    ts, hs = _time_grid(1.0, 0.01, 1000)
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
    cases = [(16, 784, 256), (3, 77, 256), (16, 64, 8), (3, 77, 8)]
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
        if not torch.equal(a, b) or torch.equal(a, c):
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
    return float(worst)


def phase_timing(dev) -> dict:
    from ctdd_tpu_torch.ops import fused_update as fu

    out = {}
    for N in (256, 16):
        D, S = 784, 256
        logits, x, qt0, rate, _, h = fused_inputs(N, D, S, 500, 1, dev)
        iters = 20 if N == 256 else 200
        ms = cuda_ms(lambda: fu.fused_tau_leap_update(
            logits, x, x, qt0, rate, h, 1e-9, 3), iters)
        gen = torch.Generator(device=dev).manual_seed(0)
        plain_ms = cuda_ms(lambda: fu.fused_tau_leap_update_plain(
            logits, x, x, qt0, rate, h, 1e-9, generator=gen), max(iters // 10, 3))
        # each input read once, the output written once; the ratio product
        # at the bf16 tensor-core rate
        nbytes = (logits.numel() * 4 + 2 * x.numel() * 4 + 2 * S * S * 4
                  + x.numel() * 4)
        flops = 2.0 * N * D * S * S
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        out[N] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                      bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                      bytes=nbytes, flops=flops)
        log(f"  N={N} D={D} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {out[N]['bound_ms'] * 1e3:.1f} us ({out[N]['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return out


def full_cfg(fused: bool):
    from ctdd_tpu_torch.config.presets import get_preset

    cfg = get_preset("tauUnet_mnist")
    cfg.sampler.use_fused_update = fused
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
    return n_params


def phase_step_breakdown(dev, steps: int = 20) -> dict:
    """Where one serving step's time goes at batch 16: the network, the
    fused kernel, the rest, and the share of the step the card is idle."""
    from torch.profiler import ProfilerActivity, profile

    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    cfg = full_cfg(fused=True)
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
    fused_ms = sum(e.self_device_time_total for e in kernels
                   if "fused_tau_leap" in e.key) / 1e3 / steps
    out = dict(step_ms=step_ms, unet_ms=unet_ms, device_busy_ms=busy_ms,
               fused_kernel_ms=fused_ms,
               idle_share=1.0 - busy_ms / step_ms if busy_ms else None,
               device_kernels_per_step=sum(e.count for e in kernels) / steps)
    log(f"  step at batch 16: {step_ms:.3f} ms wall; UNet forward "
        f"{unet_ms:.3f} ms (events); device busy {busy_ms:.3f} ms "
        f"(fused kernel {fused_ms:.3f} ms) over "
        f"{out['device_kernels_per_step']:.0f} kernels; idle share "
        + (f"{out['idle_share']:.3f}" if busy_ms else "not measured"))
    return out


def phase_serving(dev, tmpdir):
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.ops import fused_update as fu
    from ctdd_tpu_torch.serving import SamplerService, run_http_server
    from ctdd_tpu_torch.utils.bookkeeping import save_checkpoint

    cfg = full_cfg(fused=True)
    torch.manual_seed(1)
    model = create_model(cfg)
    sd = model.net.state_dict()
    path = save_checkpoint(f"{tmpdir}/flagship.pt", sd, sd, step=0, config=cfg)
    svc = SamplerService(cfg, path, batch=16, device=dev)
    t0 = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    log(f"  warm-up batch (16 samples, {cfg.sampler.num_steps} steps): "
        f"{time.perf_counter() - t0:.2f} s")

    server = run_http_server(svc, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not health["ok"] or health["batch"] != 16:
            raise AssertionError(f"healthz: {health}")
        fu.fused_tau_leap_update.launches = 0
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/generate?n=20",
                                    timeout=900) as r:
            payload = json.loads(r.read())
        elapsed = time.perf_counter() - t0
        launches = fu.fused_tau_leap_update.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    samples = np.asarray(payload["samples"])
    if samples.shape != (20, 784) or samples.min() < 0 or samples.max() > 255:
        raise AssertionError(f"bad samples: shape {samples.shape}, "
                             f"range [{samples.min()}, {samples.max()}]")
    if launches != 2 * cfg.sampler.num_steps:
        raise AssertionError(f"fused kernel launched {launches} times, "
                             f"expected {2 * cfg.sampler.num_steps}")
    log(f"  /generate?n=20: {elapsed:.2f} s for 2 batches of 16 "
        f"({20 / elapsed:.3f} samples/s served, {32 / elapsed:.3f} samples/s "
        f"generated on {torch.cuda.get_device_name(dev)}), fused kernel "
        f"launches {launches}, values in [{samples.min()}, {samples.max()}]")
    return launches, elapsed


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
    reports = _build.build(["fused_tau_leap"])
    seconds = time.perf_counter() - t0
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {' | '.join(regs) or 'already built'}")
    log(f"  built in {seconds:.2f} s")

    log("[3] fused tau-leap kernel vs plain version")
    max_err = phase_kernels(dev)

    log("[4] timing")
    timing = phase_timing(dev)

    log("[5] UNet and tau-leap steps, card vs CPU")
    phase_unet(dev)

    log("[6] step breakdown")
    breakdown = phase_step_breakdown(dev)

    log("[7] serving")
    with tempfile.TemporaryDirectory() as tmpdir:
        launches, elapsed = phase_serving(dev, tmpdir)

    big, small = timing[256], timing[16]
    record = {"kernels": [{
        "name": "fused_tau_leap_update",
        "route": "cuda",
        "source": "ctdd_tpu_torch/csrc/fused_tau_leap.cu",
        "replaces": "ctdd_tpu/ops/fused_update.py:170",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "shape": [256, 784, 256],
        "serving_shape": [16, 784, 256],
        "serving_ms": small["ms"],
        "serving_plain_ms": small["plain_ms"],
        "serving_bound_ms": small["bound_ms"],
    }]}
    log("serving: " + json.dumps({
        "samples_per_s": 32 / elapsed, "batch": 16, "steps": 1000,
        **breakdown}))
    for k in record["kernels"]:
        log(f"kernels {k['name']}: launches {k['launches']}, max diff "
            f"{k['max_abs_err']}, {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}) at N=256")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
