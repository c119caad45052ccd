"""Readings of the control and of planted faults, on the card at a cell's size.

    python3 h100bench/control.py --workload <name> --variant <v> --seeds 1,2,3 \\
        [--seconds 0] [--out chiprun_out/control.jsonl]

Each seed is one run of `run.py --variant <v>` (a fresh process, as a run
of the benchmark is), and its compared numbers are appended to `--out` as
one JSON line. The variants:

- `bf16`: the control. The program with its own lower-precision path on
  (`model.compute_dtype = "bfloat16"`: bf16 convolutions and dense
  layers), the configuration stating float32.
- `half_batch` (training): the reference in the program's place with half
  of each rank's rows left out of the loss's mean.
- `no_exchange` (training over several cards): the reference in the
  program's place with rank 0's gradients alone, as if the all-reduce were
  left out.
- the names of `faults.PLANTED` (generation): the program broken
  underneath, in the run's own process: jumps reflected, or destinations
  drawn uniformly.

The benchmark's own runs never run these. The limits in `limits/` lie
between the largest reading of sound runs and the smallest reading these
give (PERF.md lists both).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from h100bench import faults  # noqa: E402


def command(workload: str, seed: str, seconds: float, variant: str) -> list:
    run = str(HERE / "run.py")
    args = ["--workload", workload, "--seed", seed, "--seconds", str(seconds), "--trace", "0"]
    if variant not in faults.PLANTED:
        return [sys.executable, run, *args, "--variant", variant]
    code = (faults.PLANTED[variant] + "\nimport runpy, sys\n"
            f"sys.argv = {[run] + args!r}\nrunpy.run_path({run!r}, run_name='__main__')\n")
    return [sys.executable, "-c", code]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variant", required=True,
                   choices=("bf16", "half_batch", "no_exchange", *faults.PLANTED))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default="chiprun_out/control.jsonl")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    worst = 0
    for seed in args.seeds.split(","):
        cmd = command(args.workload, seed, args.seconds, args.variant)
        done = subprocess.run(cmd, capture_output=True, text=True)
        lines = done.stdout.strip().splitlines()
        if done.returncode != 0 or not lines:
            print(f"seed {seed}: exit {done.returncode}\n{done.stderr[-3000:]}", file=sys.stderr)
            worst = 1
            continue
        line = json.loads(lines[-1])
        row = {"workload": args.workload, "variant": args.variant, "seed": int(seed),
               "correct": line["correct"], "checks": line["checks"]}
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
