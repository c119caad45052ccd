"""Fixtures of the harness's own tests: a copy of the benchmark at tiny
widths, and a way to run one of its cells on the CPU in a fresh process.

Run them with `python3 -m pytest h100bench/`; the repository's suite
(`tests/`) does not collect them.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def shrink(cfg: dict) -> dict:
    """The configuration at tiny widths: 8x8 images, ch 8, 5 steps; S as published."""
    m, d = cfg["model"], cfg["data"]
    m.update(ch=8, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[4], num_heads=2,
             data_min_max=[0, 255], time_embed_dim=8)
    d.update(S=256, image_size=8, shape=[m["input_channels"], 8, 8], batch_size=4)
    m["concat_dim"] = m["input_channels"] * 64
    cfg["sampler"]["num_steps"] = 5
    cfg["about"]["dataset_rows"] = 32
    return cfg


def make_tree(dst: Path) -> Path:
    """A checkout holding BENCHMARK.json and h100bench/ at tiny widths."""
    shutil.copytree(HERE, dst / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        path = dst / c["file"]
        path.write_text(json.dumps(shrink(json.loads(path.read_text())), indent=1))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("tiny"))


def run_cell(tree: Path, workload: str, seed: int = 3000000007, *, fault: str = "",
             extra=(), program: bool = True, timeout: float = 300):
    """Run `workload` of the tree on the CPU; `fault` is Python run at the
    start of every process of the run (a sitecustomize module), which
    breaks the program underneath. Returns (exit code, last stdout line as
    a dict or None, stderr)."""
    env = dict(os.environ)
    paths = [str(ROOT)] if program else []
    if fault:
        hook = tree / f"fault_{abs(hash(fault))}"
        hook.mkdir(exist_ok=True)
        (hook / "sitecustomize.py").write_text(textwrap.dedent(fault))
        paths.insert(0, str(hook))
    env["PYTHONPATH"] = os.pathsep.join(paths)
    env.pop("BENCH_RUN", None)
    cmd = [sys.executable, str(tree / "h100bench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", "0.5", "--trace", "0", "--device", "cpu",
           *extra]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=tree,
                          env=env)
    lines = done.stdout.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return done.returncode, line, done.stderr
