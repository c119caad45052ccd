"""Benchmark CLI of the port: the flagship's throughput on one GPU.

Counterpart of the root bench.py of the JAX package. Prints ONE JSON line
with the same metric name, unit and `extras` keys:

- `value` (headline): 1000-step TauL samples/s at N=256 with the fused
  tau-leap kernel, 3 runs after a warm-up run; `plain_samples_per_sec` the
  same without it;
- `ctelbo_train_steps_per_sec`: CTElbo train steps/s at the preset's batch
  (64), 10 steps after one, deterministic as `train()` runs;
- `bf16_train_steps_per_sec`: the same step with `model.compute_dtype =
  "bfloat16"` (float32 weights, bf16 convolutions and Dense layers), on the
  same initial weights and batch; `bf16_train_mfu` over the float32 step's
  FLOPs, as the JAX bench takes it;
- FLOPs per train step and per sampler step, counted over one call by
  `torch.utils.flop_counter.FlopCounterMode` (matmuls and convolutions; the
  fused kernel, a ctypes call, is not seen), and the MFUs against the card's
  dense bf16 peak (`peak_flops`; null for a card the table lacks);
- `device`: the card's name and power limit.

`vs_baseline` and `train_vs_baseline` are null: the JAX side's constants are
torch-CPU times on another host. Weights are drawn from seed 0 with the JAX
package's initializers; the sampler runs on them, untrained.

Environment, as the JAX bench: BENCH_BATCH (train batch), BENCH_TRAIN_ONLY
(only the train step), BENCH_NO_FUSED (no fused sampler run).

Usage:
  python -m ctdd_tpu_torch.bench                 # tauUnet_mnist on the GPU
  python -m ctdd_tpu_torch.bench --set sampler.num_steps=100
  python -m ctdd_tpu_torch.bench --device cpu --set model.ch=8 ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

N_SAMPLE = 256  # the JAX bench's sample batch
N_RUNS = 3
N_TRAIN = 10

# dense bf16 tensor-core peaks (NVIDIA's data sheets), by device-name prefix
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # SXM
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H200": 989e12,
}


def peak_flops(device: torch.device):
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in PEAK_BF16_FLOPS.items():
        if name.startswith(prefix):
            return peak
    return None


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def counted_flops(fn) -> tuple:
    """(FLOPs of one call of `fn` as FlopCounterMode counts them, its result)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return float(counter.get_total_flops()), out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _samples_per_sec(sampler, model, device) -> tuple:
    """(samples/s over N_RUNS runs after a warm-up, seconds per run)."""
    gen = torch.Generator(device=device)
    sampler.sample(model, model.net, gen.manual_seed(0), N=N_SAMPLE)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for i in range(N_RUNS):
        sampler.sample(model, model.net, gen.manual_seed(i + 1), N=N_SAMPLE)
    _sync(device)
    dt = (time.perf_counter() - t0) / N_RUNS
    return N_SAMPLE / dt, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tauUnet_mnist")
    ap.add_argument("--set", nargs="*", default=None, help="key=value overrides")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ctdd_tpu_torch.config.base import Config
    from ctdd_tpu_torch.config.presets import apply_overrides, get_preset, parse_overrides
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.models.base import create_model
    from ctdd_tpu_torch.ops import kernel_launches
    from ctdd_tpu_torch.sampling.samplers import get_sampler
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import make_train_step
    from ctdd_tpu_torch.utils.device import deterministic_training, resolve_device

    device = resolve_device(args.device)
    cfg = apply_overrides(get_preset(args.preset), parse_overrides(args.set))
    if os.environ.get("BENCH_BATCH"):
        cfg.data.batch_size = int(os.environ["BENCH_BATCH"])
    with torch.random.fork_rng(devices=[]):
        model = create_model(cfg, device=device)
    model.net.init_weights(torch.Generator().manual_seed(0))
    D, S, B = cfg.model.concat_dim, cfg.data.S, cfg.data.batch_size
    peak = peak_flops(device)

    # --- train step throughput (CTElbo), float32 then bf16 compute -------
    # on copies of the weights: the sampler below runs on the initial ones,
    # as the JAX bench's does
    tx = get_optimizer(cfg)
    batch = torch.randint(0, S, (B, D), generator=torch.Generator(device=device).manual_seed(9),
                          device=device, dtype=torch.int32)

    def train_rate(train_model) -> tuple:
        """(FLOPs of one step, steps/s over N_TRAIN steps after it), with
        cuDNN and attention deterministic as `train()` runs it."""
        state = create_train_state(
            {k: v.detach().clone() for k, v in model.net.named_parameters()}, tx)
        step = make_train_step(train_model, get_loss(cfg), tx,
                               ema_decay=float(cfg.model.ema_decay))
        with deterministic_training(device):
            flops, (state, _) = counted_flops(lambda: step(state, batch, 10))
            _sync(device)
            t0 = time.perf_counter()
            for i in range(N_TRAIN):
                state, _ = step(state, batch, 11 + i)
            _sync(device)
        return flops, N_TRAIN / (time.perf_counter() - t0)

    train_flops, train_steps_per_sec = train_rate(model)
    train_mfu = round(train_flops * train_steps_per_sec / peak, 4) if peak else None
    cfg_bf16 = apply_overrides(Config(cfg.to_dict()), {"model.compute_dtype": "bfloat16"})
    with torch.random.fork_rng(devices=[]):
        model_bf16 = create_model(cfg_bf16, device=device)
    _, bf16_steps_per_sec = train_rate(model_bf16)
    bf16_mfu = round(train_flops * bf16_steps_per_sec / peak, 4) if peak else None
    del model_bf16
    dev_line = device_line(device)

    if os.environ.get("BENCH_TRAIN_ONLY"):
        print(json.dumps({
            "metric": "ctelbo_train_steps_per_sec",
            "value": round(train_steps_per_sec, 4),
            "unit": "steps/sec",
            "vs_baseline": None,
            "extras": {
                "train_flops_per_step": train_flops,
                "train_mfu": train_mfu,
                "bf16_train_steps_per_sec": round(bf16_steps_per_sec, 4),
                "bf16_train_mfu": bf16_mfu,
                "train_batch": B,
                "device": dev_line,
                "peak_flops": peak,
            },
        }))
        return

    # --- sampler throughput (TauL, plain) --------------------------------
    model.net.eval()
    # a sampler reads `use_fused_update` when it is built
    cfg.sampler.use_fused_update = False
    sampler = get_sampler(cfg)
    n_steps = int(cfg.sampler.num_steps)
    samples_per_sec, dt = _samples_per_sec(sampler, model, device)
    x = torch.randint(0, S, (N_SAMPLE, D), generator=torch.Generator(device=device).manual_seed(1),
                      device=device, dtype=torch.int32)
    with torch.inference_mode():
        sample_flops, _ = counted_flops(lambda: sampler.step(
            model, model.net, x, 0.5, 1e-3,
            generator=torch.Generator(device=device).manual_seed(2)))
    sample_mfu = round(sample_flops * n_steps / dt / peak, 4) if peak else None

    # --- the fused tau-leap kernel (the production sampler: the headline) -
    fused_samples_per_sec = None
    if not os.environ.get("BENCH_NO_FUSED"):
        cfg.sampler.use_fused_update = True
        fused_samples_per_sec, _ = _samples_per_sec(get_sampler(cfg), model, device)

    headline = fused_samples_per_sec or samples_per_sec
    print(json.dumps({
        "metric": "mnist_taul_samples_per_sec",
        "value": round(headline, 4),
        "unit": "samples/sec/chip",
        "vs_baseline": None,
        "extras": {
            "sampler_steps": n_steps,
            "sample_batch": N_SAMPLE,
            "plain_samples_per_sec": round(samples_per_sec, 4),
            "ctelbo_train_steps_per_sec": round(train_steps_per_sec, 4),
            "train_batch": B,
            "train_vs_baseline": None,
            "device": dev_line,
            "train_flops_per_step": train_flops,
            "train_mfu": train_mfu,
            "bf16_train_steps_per_sec": round(bf16_steps_per_sec, 4),
            "bf16_train_mfu": bf16_mfu,
            "sample_flops_per_sampler_step": sample_flops,
            "sample_mfu": sample_mfu,
            "peak_flops": peak,
            "fused_samples_per_sec": (round(fused_samples_per_sec, 4)
                                      if fused_samples_per_sec else None),
            "kernel_launches": kernel_launches(),
        },
    }))


if __name__ == "__main__":
    main()
