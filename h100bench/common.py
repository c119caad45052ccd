"""What every cell of the benchmark shares: the manifest and its files,
seeds, the seeded weights and data, timing on the card, the reading of a
profiler trace, and the result line.

Nothing here imports the program. The kinds of traffic (`kinds/`) drive
it; the per-layer and end-to-end metrics (`metrics/`) read what a kind
hands them in a `Context`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ctdd_tpu")

# the H100 SXM's published dense peaks (NVIDIA's data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# the reading of an output that cannot be compared with the reference's
FAR = 1e30

# sub-seed tags: one stream of draws each
WEIGHTS, DATA, TRAIN, BATCH, CHOICE = 1, 2, 3, 4, 5


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(manifest: dict, name: str, root: Path = ROOT):
    """(the configuration as it is run, its `about` notes)."""
    cfg = load_json(root / config_entry(manifest, name)["file"])
    return cfg, cfg.pop("about", {})


def load_traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def load_limits(workload: str, here: Path = HERE) -> dict:
    return load_json(here / "limits" / f"{workload}.json")


def load_module(path: Path):
    """A module from a file whose name may hold dots (`idle_share.train.py`)."""
    spec = importlib.util.spec_from_file_location(f"h100bench_{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, here: Path = HERE):
    return load_module(here / "kinds" / f"{kind}.py")


def load_reader(metric: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{metric}.py")


def cell_metrics(manifest: dict, workload: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") this cell
    reports: those whose `workloads` list it, and those without the key (a
    per-layer one of those where the cell reports the metric it moves)."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in names)]


# ---------------------------------------------------------------------------
# seeds, weights, data
# ---------------------------------------------------------------------------


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for each purpose (tags) under `seed`."""
    words = np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint64)
    return int(words[0] >> np.uint64(1))


def leaf_kinds(net) -> Dict[str, str]:
    """Each parameter's draw: "fan" for conv and dense kernels, "norm" for
    a normalization's scale, "bias" for the rest."""
    import torch.nn as nn

    kinds = {}
    for mname, mod in net.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if p.dim() >= 2:
                kinds[full] = "fan"
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and pname == "weight":
                kinds[full] = "norm"
            else:
                kinds[full] = "bias"
    return kinds


def seeded_weights(net, seed: int, device) -> Dict[str, Any]:
    """Float32 weights for every parameter of `net` (the reference's, whose
    names and shapes the program shares), drawn on `device` from `seed` in
    one call: kernels uniform in +-sqrt(3 / fan_avg) (variance scaling 1,
    every layer live, unlike the published near-zero output layers),
    normalization scales 1 +- 0.1, biases +-0.05."""
    import torch

    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    kinds = leaf_kinds(net)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        kind = kinds[name]
        if kind == "fan":
            field = math.prod(shape[2:])
            limit = math.sqrt(3.0 / ((shape[0] + shape[1]) * field / 2.0))
            out[name] = part.mul_(limit).view(shape)
        elif kind == "norm":
            out[name] = part.mul_(0.1).add_(1.0).view(shape)
        else:
            out[name] = part.mul_(0.05).view(shape)
    return out


def load_weights(net, weights: Dict[str, Any]) -> None:
    """Copy `weights` into `net`'s parameters, which must match them in
    names and shapes."""
    import torch

    params = dict(net.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) ^ set(params))[:5]
        raise ValueError(f"the network's parameters differ from the benchmark's: {missing}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} != {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def seeded_data(cfg: dict, rows: int, seed: int, device):
    """`rows` images of the configuration's shape, pixels uniform in
    [0, S), int32 on `device`."""
    import torch

    D = math.prod(cfg["data"]["shape"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    return torch.randint(0, cfg["data"]["S"], (rows, D), generator=gen, device=device,
                         dtype=torch.int32)


def reference_net(cfg: dict, device, weights=None):
    import torch

    from h100bench.reference.unet import Net

    with torch.device(device):
        net = Net(cfg)
    if weights is not None:
        load_weights(net, weights)
    return net


def forward_flops(cfg: dict, batch: int) -> float:
    """FLOPs of one forward of the reference network at `batch`, counted by
    FlopCounterMode on the meta device (shapes only, nothing computed)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    net = reference_net(cfg, "meta")
    D = math.prod(cfg["data"]["shape"])
    x = torch.zeros((batch, D), dtype=torch.int32, device="meta")
    t = torch.zeros((batch,), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x, t)
    return float(counter.get_total_flops())


def fused_tau_leap_bytes(N: int, D: int, S: int) -> int:
    """The fused tau-leap kernel's bytes, each input read once and each
    output written once: the (N, D, S) float32 logits, the gathered and the
    base (N, D) int32 states, the two (S, S) float32 tables, the (N, D)
    int32 result."""
    return 4 * N * D * S + 3 * 4 * N * D + 2 * 4 * S * S


# ---------------------------------------------------------------------------
# timing on the card (chip_smoke.py's arithmetic)
# ---------------------------------------------------------------------------


def cuda_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    """Mean ms of `fn` over `iters` back-to-back calls between CUDA events."""
    import torch

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


def device_ms(fn: Callable, iters: int) -> Optional[float]:
    """Device ms of one call of `fn`: every device operation it launches,
    summed from a torch.profiler trace over `iters` calls; None where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    return total_us / 1e3 / iters if total_us else None


# ---------------------------------------------------------------------------
# the trace of a steady segment
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """Device operations, kernels and copies (name, start_us, end_us), and
    host operations (name, start_us, end_us, depth) of one profiled
    segment; `wall_s` is the segment's length on the host clock, `units`
    the steps it held."""

    device: List[tuple]
    host: List[tuple]
    wall_s: float
    units: int

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device)) / 1e6

    def window_s(self) -> float:
        span = 0.0
        if self.device:
            span = (max(e for _, _, e in self.device) - min(s for _, s, _ in self.device)) / 1e6
        return max(self.wall_s, span)

    def kernel_us(self, part: str) -> List[float]:
        return [e - s for name, s, e in self.device if part in name]


def union(ops) -> List[tuple]:
    """The union of the operations' [start, end) intervals, in order."""
    out: List[list] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def profile_segment(fn: Callable, units: int) -> Trace:
    """Run `fn` (which does `units` steps) under torch.profiler and keep its
    device and host operations."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            # a range a library annotates on the device's timeline (NCCL's
            # "nccl:all_reduce") spans its kernels and any wait between them
            if not getattr(e, "is_user_annotation", False):
                dev.append(row)
        else:
            depth, p = 0, e.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            host.append(row + (depth,))
    return Trace(device=dev, host=host, wall_s=wall, units=units)


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its template arguments' tail."""
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing in them (outermost/innermost op)."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace.device:
        name = short(name)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union(trace.device)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    named: Dict[str, float] = {}
    for length, s, e in gaps:
        mid = (s + e) / 2.0
        around = [h for h in trace.host if h[1] <= mid <= h[2]]
        if around:
            outer = min(around, key=lambda h: h[3])[0]
            inner = max(around, key=lambda h: h[3])[0]
            label = short(outer if outer == inner else f"{outer}/{inner}")
        else:
            label = "host between ops"
        named[label] = named.get(label, 0.0) + length / 1e6
    gaps_out = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps_out]}


# ---------------------------------------------------------------------------
# what a kind hands the metric readers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What one run measured. `counters` hold counts and host-clock seconds
    (`window_s`, `samples`, `steps`, `flops_per_step`, ...); `trace` the
    profiled segment (a `--trace 1` run); `probes` zero-argument calls that
    run one part of the step alone on the cell's inputs."""

    cfg: dict
    traffic: dict
    setup_s: float
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    probes: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    peak_flops: float = PEAK_BF16_FLOPS
    peak_bytes_per_s: float = PEAK_HBM_BYTES_PER_S


@dataclasses.dataclass
class Outcome:
    """What a kind hands back: the metrics read, the compared numbers, the
    units attempted and failed in the window, the peak device memory, and
    the traced segment with its device busy time (averaged over the
    cards)."""

    metrics: Dict[str, dict]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    busy_s: Optional[float] = None


class tf32_off:
    """float32 matmuls and convolutions without TF32 inside the block."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def is_batches(ctx: Context) -> bool:
    """Offline generation (the `sample` kind)."""
    return "batches" in ctx.counters


def is_train(ctx: Context) -> bool:
    """Training on one card."""
    return ctx.counters.get("ranks") == 1


def is_dp(ctx: Context) -> bool:
    """Training over several cards."""
    return ctx.counters.get("ranks", 1) > 1


def idle_share_pct(trace: Trace) -> float:
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())


def read_metrics(entries: List[dict], ctx: Context, here: Path = HERE) -> Dict[str, dict]:
    """Each metric's reader on `ctx`; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], here).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the comparison and the result line
# ---------------------------------------------------------------------------


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes at or under
    its limit. A number without a limit, or a limit without a number, fails."""
    names = sorted(set(numbers) | set(limits))
    return {n: {"value": numbers.get(n), "limit": limits.get(n),
                "ok": (n in numbers and n in limits and numbers[n] is not None
                       and math.isfinite(numbers[n]) and numbers[n] <= limits[n])}
            for n in names}


def forbidden_modules(modules=None) -> List[str]:
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers as the last lines on stderr, then the result as
    the last line on stdout, with the numbers under `checks`, last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    print(json.dumps(line), flush=True)
