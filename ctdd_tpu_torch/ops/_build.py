"""Build and load the hand-written CUDA kernels of `ctdd_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
`sm_90a` into `csrc/build/<name>-<digest>.so` at first use and loaded with
`ctypes`; the digest covers the source and the flags, so an edited source
is rebuilt. `build(names)` starts one `nvcc` per missing library, all at
once, and waits for them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library in parallel; returns each one's
    `ptxas -v` report (empty where the library was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    reports = {name: "" for name in names}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        reports[name] = log
    return reports


def tensor_core_ops(name: str):
    """Tensor-core MMA ops in the built library for `csrc/<name>.cu`,
    counted by mnemonic (HMMA, IMMA, HGMMA ...) from `cuobjdump -sass`; None
    where the toolkit has no `cuobjdump`."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run(
        [str(tool), "-sass", str(library_path(name))],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts: Dict[str, int] = {}
    for op in re.findall(r"\b((?:H|I|D|Q)G?MMA(?:\.\w+)*)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))

