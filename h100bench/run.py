"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by name
from BENCHMARK.json: the configuration in `configs/<config>.json`, the
traffic in `traffic/<traffic>.json`, whose `kind` names the generator in
`kinds/<kind>.py`, each metric's reader in `metrics/<metric>.py`, and the
limits of the compared numbers in `limits/<workload>.json`. With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the device's busy time and a breakdown.

Without a CUDA device, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. `--rank`, `--port` and `--variant` are
for the processes a multi-card cell starts and for `control.py`;
`--device cpu` for the harness's own tests.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "h100bench" / ".cache"


@dataclasses.dataclass
class Run:
    """One run's arguments, configuration, reference family and traffic, as
    the kinds see it."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    rank: int
    port: int
    variant: str
    chips: int
    cfg: dict
    about: dict
    family: object
    traffic: dict
    device: object
    read: object
    t0: float
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, label: str) -> None:
        """Note how far set-up has come (seconds since the process began)."""
        self.marks.append((label, time.perf_counter() - self.t0))


def fixed_caches() -> None:
    """Every compiler cache the run may fill, at fixed paths inside the
    checkout; nothing of JAX's loaded by a library on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--variant", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu: the harness's own tests, at tiny sizes")
    return p.parse_args(argv)


def execute(args, device, root: Path = ROOT):
    """Run the cell named in `args` on `device` and return (the result
    line without its checks, the checks), or None on a rank above 0."""
    from h100bench import common

    manifest = common.load_manifest(root)
    cell = common.cell(manifest, args.workload)
    cfg, about = common.load_config(manifest, cell["config"], root)
    traffic = common.load_traffic(cell["traffic"])
    kind = common.load_kind(traffic["kind"])
    section = "per_layer" if args.trace else "end_to_end"
    entries = common.cell_metrics(manifest, args.workload, section)
    r = Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), rank=args.rank, port=args.port, variant=args.variant,
            chips=int(cell["chips"]), cfg=cfg, about=about,
            family=common.load_family(about), traffic=traffic, device=device,
            read=lambda ctx: common.read_metrics(entries, ctx), t0=T0)
    out = kind.run(r)
    if out is None:
        return None
    if r.marks:
        print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in r.marks), file=sys.stderr)
    checks = common.judge(out.numbers, common.load_limits(args.workload))
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": device_name(device), "count": r.chips,
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": out.attempted,
              "failed": out.failed, "metrics": out.metrics, "device": device_info}
    if args.trace and out.trace is not None:
        device_info.update(busy_s=out.busy_s, window_s=out.trace.window_s())
        result["breakdown"] = common.breakdown(out.trace)
    return result, checks


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    from h100bench import common

    manifest = common.load_manifest()
    cell = common.cell(manifest, args.workload)
    kind = common.load_kind(common.load_traffic(cell["traffic"])["kind"])
    # a fault planted in the reference alone needs one card
    chips = 1 if args.variant in getattr(kind, "REFERENCE_ONLY", ()) else int(cell["chips"])

    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    done = execute(args, device)
    # on every rank: rank 0 fails its run when another rank exits non-zero
    found = common.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    if done is None:  # a rank above 0: rank 0 prints the line
        return 0
    common.emit(*done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
