"""Offline generation: whole batches of N samples, one after another.

Traffic parameters: `n` (samples a batch), `checked_among` (the batch
whose output is checked is drawn from the seed among the window's first
this many). The sampler always takes its one-launch tau-leap update
(`sampler.use_fused_update`), the path offline generation runs.

The window runs batches until `--seconds` have passed and then finishes
the batch it is in; `samples_per_s` divides all the samples of all its
batches by the time until the last one ended. A forward pre-hook on the
network records, for the checked batch only, the state each forward saw:
x_T, every step's state and the denoise's input; the reference follows
that trajectory once the window has closed (reference/sample.py).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from h100bench import common, program
from h100bench.reference import sample as ref_sample

BLOCK = 128  # rows of the reference's forward at a time
CONTROL_NUMBER = "denoise_gap"  # the compared number the bf16 control fails


class Recorder:
    """Keeps the states each network forward receives while on."""

    def __init__(self):
        self.on = False
        self.states = []

    def __call__(self, module, args):
        if self.on:
            self.states.append(args[0])


def run(r) -> common.Outcome:
    from ctdd_tpu_torch.sampling.samplers import get_sampler

    cfg, tr, dev = r.cfg, r.traffic, r.device
    N, S = int(tr["n"]), cfg["data"]["S"]
    steps = int(cfg["sampler"]["num_steps"])
    overrides = {"sampler.use_fused_update": True}
    if r.variant == "bf16":
        overrides["model.compute_dtype"] = "bfloat16"
    elif r.variant:
        raise ValueError(f"offline generation has no variant {r.variant!r}")
    r.mark("imports")
    pcfg = program.config(cfg, overrides)
    weights = common.reference_weights(r.family, cfg, r.seed, dev)
    held = {"model": program.model(pcfg, weights, dev)}
    held["model"].net.eval()
    sampler = get_sampler(pcfg)
    r.mark("model built and loaded")
    rec = Recorder()
    held["model"].net.register_forward_pre_hook(rec)

    def batch(i: int):
        gen = torch.Generator(device=dev).manual_seed(common.sub_seed(r.seed, common.BATCH, i))
        return sampler.sample(held["model"], held["model"].net, gen, N)[0]

    batch(0)  # the warm-up batch: every shape the window uses, the kernel built
    r.mark("warm-up batch")
    setup_s = time.perf_counter() - r.t0

    chosen = int(np.random.default_rng(common.sub_seed(r.seed, common.CHOICE))
                 .integers(0, int(tr["checked_among"])))
    batches, failed, kept = 0, 0, None
    t0 = time.perf_counter()
    while True:
        rec.on, rec.states = batches == chosen, []
        x = batch(batches + 1)
        if rec.on:
            kept = (x, rec.states)
            rec.on = False
        failed += int(((x < 0) | (x >= S)).any(axis=1).sum())
        batches += 1
        if time.perf_counter() - t0 >= r.seconds and batches > chosen:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ctx = common.Context(cfg=cfg, traffic=tr, setup_s=setup_s)
    ctx.counters.update(window_s=window_s, samples=batches * N, batches=batches)
    if r.trace:
        D = int(np.prod(cfg["data"]["shape"]))
        ctx.counters.update(flops_per_batch=(steps + 1) * r.family.forward_flops(cfg, N),
                            fused_tau_leap_bytes=common.fused_tau_leap_bytes(N, D, S))
        ctx.trace = common.profile_segment(lambda: batch(0), units=steps)
        xp = torch.randint(0, S, (N, D), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(r.seed))
        tp = torch.full((N,), 0.5, device=dev)

        def network_forward():
            with torch.inference_mode():
                held["model"].apply(held["model"].net, xp, tp)

        ctx.probes["network_forward"] = network_forward
    metrics = r.read(ctx)
    ctx.probes.clear()

    # the reference, once the program is gone
    t_ref = time.perf_counter()
    x_out, traj = kept
    held.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with common.tf32_off():
        net = common.reference_net(r.family, cfg, dev, weights).eval()
        proc = r.family.process(cfg, dev)
        tokens = torch.as_tensor(x_out, device=dev)
        if len(traj) != steps + 1:
            # the program did not run the configured steps: every step fails
            numbers = {"denoise_gap": common.FAR, "steps_outside_law": steps,
                       "jump_drift_sd": common.FAR, "jump_size_sd": common.FAR,
                       "prior_states_outside_law": S}
        else:
            traj = [s.clone() for s in traj]
            numbers = {
                "denoise_gap": ref_sample.denoise_gap(net, traj[-1], tokens,
                                                      cfg["sampler"]["min_t"], BLOCK),
                **ref_sample.jump_laws(net, proc, traj, cfg, BLOCK),
                "prior_states_outside_law": ref_sample.prior_states_outside_law(traj[0], cfg),
            }
            print(f"where the tokens go: held on {numbers.pop('held_steps')} of {steps} steps",
                  file=sys.stderr)
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return common.Outcome(metrics=metrics, numbers=numbers, attempted=batches * N,
                          failed=failed, memory_peak_bytes=peak, trace=ctx.trace,
                          busy_s=ctx.trace.busy_s() if ctx.trace else None)
