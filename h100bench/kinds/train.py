"""Training on data that lives on the card, on one rank or several.

Traffic parameters: `ranks` (processes, one card each; above 1 the first
process starts the others and they join an NCCL group), `profiled_steps`
(steps in the traced segment). The batch a card is the configuration's
`data.batch_size`; the global batch is that times the ranks.

The step is the program's `make_device_data_train_step` under
`deterministic_training`, as `train()` runs it: each rank draws its rows
from the on-card dataset, the gradients are averaged in one all-reduce,
then clip, Adam and EMA. Set-up builds the state and drives it through
three steps, recording what the reference is compared with (the losses,
the first gradient as Adam's first moment holds it, the change of the
parameters and of the EMA); the window then continues the same state.
Every step of the window asks all ranks whether the time is up
(`Mesh.any`, as `train()` asks about preemption), so all stop together.
"""

from __future__ import annotations

import gc
import math
import socket
import subprocess
import sys
import time

import torch

from h100bench import common, program
from h100bench.reference import train as ref_train
from h100bench.reference.process import GaussianTargetRate

CHECKED_STEPS = 3
REFERENCE_ONLY = ("half_batch", "no_exchange")  # faults planted in the reference
CHILD_WAIT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(r, ranks: int, port: int):
    cmd = [sys.executable, str(common.HERE / "run.py"), "--workload", r.workload,
           "--seed", str(r.seed), "--seconds", str(r.seconds), "--trace", str(int(r.trace)),
           "--port", str(port), "--device", r.device.type] + (
               ["--variant", r.variant] if r.variant else [])
    return [subprocess.Popen(cmd + ["--rank", str(k)]) for k in range(1, ranks)]


def stop_ranks(procs, ok: bool) -> None:
    for p in procs:
        if not ok:
            p.kill()
    bad = []
    for p in procs:
        try:
            code = p.wait(timeout=CHILD_WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            code = "timeout"
        if code != 0:
            bad.append(code)
    if ok and bad:
        raise RuntimeError(f"a rank process ended with {bad}")


def run(r):
    cfg, tr = r.cfg, r.traffic
    ranks = int(tr["ranks"])
    per_rank = int(cfg["data"]["batch_size"])
    rows = int(r.about["dataset_rows"])
    tseed = common.sub_seed(r.seed, common.TRAIN)
    if r.variant in REFERENCE_ONLY:
        dev = r.device
        weights = common.seeded_weights(common.reference_net(cfg, "meta"), r.seed, dev)
        data = common.seeded_data(cfg, rows, r.seed, dev)
        keep = dict(keep_rows=per_rank // 2) if r.variant == "half_batch" else dict(keep_ranks=1)
        prog = reference_readings(cfg, weights, data, tseed, ranks, per_rank, dev, **keep)
        numbers = compare([prog], cfg, weights, data, tseed, ranks, per_rank, dev)
        return common.Outcome(metrics={}, numbers=numbers, attempted=CHECKED_STEPS,
                              failed=0, memory_peak_bytes=0)

    port, procs = r.port, []
    if ranks > 1 and r.rank == 0:
        port = free_port()
        procs = start_ranks(r, ranks, port)
    ok = False
    try:
        if ranks > 1:
            import torch.distributed as dist

            cuda = r.device.type == "cuda"
            if cuda:
                torch.cuda.set_device(r.rank)
            dist.init_process_group("nccl" if cuda else "gloo",
                                    init_method=f"tcp://localhost:{port}",
                                    world_size=ranks, rank=r.rank)
        out = run_rank(r, cfg, tr, ranks, per_rank, rows, tseed)
        ok = True
    finally:
        if ranks > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        stop_ranks(procs, ok)
    if r.rank:
        return None
    check = out.pop("check")
    out["numbers"] = check()
    return common.Outcome(**out)


def run_rank(r, cfg, tr, ranks, per_rank, rows, tseed) -> dict:
    from ctdd_tpu_torch.losses.losses import get_loss
    from ctdd_tpu_torch.parallel.dp import make_device_data_train_step
    from ctdd_tpu_torch.parallel.mesh import make_mesh
    from ctdd_tpu_torch.training.optimizers import get_optimizer
    from ctdd_tpu_torch.training.state import create_train_state
    from ctdd_tpu_torch.training.train_step import apply_update, value_and_grad
    from ctdd_tpu_torch.utils.device import deterministic_training

    r.mark("imports")
    overrides = {"model.compute_dtype": "bfloat16"} if r.variant == "bf16" else {}
    if r.variant and not overrides:
        raise ValueError(f"training has no variant {r.variant!r}")
    pcfg = program.config(cfg, overrides)
    mesh = make_mesh(device=r.device if ranks == 1 else r.device.type)
    dev = mesh.device
    weights = common.seeded_weights(common.reference_net(cfg, "meta"), r.seed, dev)
    data = common.seeded_data(cfg, rows, r.seed, dev)
    B = per_rank * ranks
    decay = float(pcfg.model.get("ema_decay", 0.0))
    r.mark("mesh, weights and data")
    with deterministic_training(dev):
        held = {"model": program.model(pcfg, weights, dev)}
        r.mark("model built and loaded")
        tx = get_optimizer(pcfg)
        held["state"] = create_train_state(dict(held["model"].net.named_parameters()), tx)
        step = make_device_data_train_step(held["model"], get_loss(pcfg), tx, mesh, B,
                                           ema_decay=decay)

        def advance(n: int):
            losses = []
            for _ in range(n):
                held["state"], value = step(held["state"], data, tseed)
                losses.append(value)
            return losses

        r.mark("state and step built")
        seen = []
        hook = held["model"].net.register_forward_hook(
            lambda module, args, out: seen.append(out.detach().cpu()) if not seen else None)
        losses = advance(1)
        hook.remove()
        r.mark("first step")
        names = list(held["state"].params)
        mine = {"names": names, "logits": seen[0] if r.rank == 0 else None,
                "grad": [float((held["state"].opt_state.mu[n] / (1.0 - ref_train.B1)).norm())
                         for n in names]}
        losses += advance(CHECKED_STEPS - 1)
        st = held["state"]
        mine["change"] = [float((st.params[n].detach() - weights[n]).norm()) for n in names]
        mine["ema"] = [float((st.ema_params[n] - weights[n]).norm()) for n in names]
        mine["losses"] = losses
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        r.mark("checked steps")
        setup_s = time.perf_counter() - r.t0

        steps, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            value = advance(1)[0]
            steps += 1
            failed += not math.isfinite(value) or value >= 1e9
            if mesh.any(time.perf_counter() - t0 >= r.seconds):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

        ctx = common.Context(cfg=cfg, traffic=tr, setup_s=setup_s)
        ctx.counters.update(window_s=window_s, steps=steps, samples=steps * B, ranks=ranks)
        if r.trace:
            n_prof = int(tr["profiled_steps"])
            ctx.counters["flops_per_step"] = 3.0 * common.forward_flops(cfg, B)
            ctx.trace = common.profile_segment(lambda: advance(n_prof), units=n_prof)
            if ranks == 1:
                D, S = data.shape[1], cfg["data"]["S"]
                g = torch.Generator(device=dev).manual_seed(r.seed)
                x = data[:per_rank]
                t = torch.rand(per_rank, device=dev, generator=g) * 0.99 + 0.01
                st = held["state"]
                plist = list(st.params.values())
                g_out = torch.randn((per_rank, D, S), device=dev, generator=g)

                def network_fwd_bwd():
                    torch.autograd.grad(held["model"].apply(st.params, x, t, train=True),
                                        plist, grad_outputs=g_out, allow_unused=True)

                value, grads = value_and_grad(
                    lambda p: held["model"].apply(p, x, t, train=True).float().square().mean(),
                    st.params)
                ctx.probes["network_fwd_bwd"] = network_fwd_bwd
                ctx.probes["update"] = lambda: apply_update(st, value, grads, tx, decay)
        gathered = [dict(mine, peak=peak, busy_s=ctx.trace.busy_s() if ctx.trace else None)]
        if ranks > 1:
            import torch.distributed as dist

            gathered = [None] * ranks
            dist.all_gather_object(gathered, dict(mine, peak=peak,
                                                  busy_s=ctx.trace.busy_s() if ctx.trace else None))
        if r.rank:
            return {}
        metrics = r.read(ctx)
        ctx.probes.clear()
        busy = [g["busy_s"] for g in gathered]

    def check():
        held.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return compare(gathered, cfg, weights, data, tseed, ranks, per_rank, dev)

    return dict(metrics=metrics, check=check, attempted=steps, failed=failed,
                memory_peak_bytes=max(g["peak"] for g in gathered), trace=ctx.trace,
                busy_s=sum(busy) / len(busy) if ctx.trace else None)


def reference_readings(cfg, weights, data, tseed, ranks, per_rank, dev, **fault):
    """What the reference (with a planted `fault`, if any) gives for the
    readings the program is compared on."""
    with common.tf32_off():
        net = common.reference_net(cfg, dev, weights)
        ref = ref_train.Reference(net, GaussianTargetRate(cfg["model"], cfg["data"]["S"], dev),
                                  cfg)
        names = [n for n, _ in net.named_parameters()]
        losses, first, logits = [], None, None
        for k in range(CHECKED_STEPS):
            loss, grads, out = ref.step(data, tseed, k, ranks, per_rank, **fault)
            losses.append(loss)
            if first is None:
                first, logits = [float(g.norm()) for g in grads], out.cpu()
            del out
        change = [float((p.detach() - weights[n]).norm()) for n, p in zip(names, ref.params)]
        ema = [float((e - weights[n]).norm()) for n, e in zip(names, ref.ema)]
    return {"names": names, "losses": losses, "grad": first, "change": change, "ema": ema,
            "logits": logits}


def relative_rms(a: torch.Tensor, b: torch.Tensor, block: int = 1 << 24) -> float:
    """||a - b|| / ||b|| over all entries, summed in float64 by blocks; an
    output of another shape than the reference's reads as far off."""
    if a.shape != b.shape:
        return common.FAR
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), block):
        x, y = a[i:i + block].double(), b[i:i + block].double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return math.sqrt(num / den)


def compare(readings, cfg, weights, data, tseed, ranks, per_rank, dev) -> dict:
    """The compared numbers: the relative RMS gap of rank 0's network output
    in the first step (`first_logits_gap`), the worst relative gap of the
    checked steps' losses, and the worst leaf's gap
    (ref_train.worst_leaf_gap) of the first gradient, of the parameters'
    change and of the EMA's change, over every rank's readings. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the two changes."""
    ref = reference_readings(cfg, weights, data, tseed, ranks, per_rank, dev)
    index = {n: i for i, n in enumerate(ref["names"])}
    rg = torch.tensor(ref["grad"], dtype=torch.float64)
    keep = rg >= 1e-3 * rg.median()
    out = {"first_logits_gap": relative_rms(readings[0]["logits"], ref["logits"]),
           "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0, "ema_gap": 0.0}
    for mine in readings:
        order = [index[n] for n in mine["names"]]
        if sorted(order) != list(range(len(index))):
            raise ValueError("the program's parameters differ from the reference's")
        for a, b in zip(mine["losses"], ref["losses"]):
            out["loss_gap"] = max(out["loss_gap"], abs(a - b) / abs(b))
        for key, name, kept in (("grad", "grad_gap", None), ("change", "change_gap", keep),
                                ("ema", "ema_gap", keep)):
            prog = torch.zeros(len(index), dtype=torch.float64)
            prog[order] = torch.tensor(mine[key], dtype=torch.float64)
            gap = ref_train.worst_leaf_gap(prog, torch.tensor(ref[key], dtype=torch.float64), kept)
            out[name] = max(out[name], gap)
    return out
