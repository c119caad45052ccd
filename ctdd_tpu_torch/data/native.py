"""ctypes bindings for the C++ maze and sudoku generators (csrc/datagen.cpp).

Counterpart of ctdd_tpu/data/native.py. The port builds its own copy of the
generators, `ctdd_tpu_torch/csrc/datagen.cpp`, with the host C++ compiler
(`$CXX`, else `g++`) and the flags of the JAX package's `native/Makefile`,
into `csrc/build/datagen-<digest>.so` at first use; the digest covers the
source, the compiler and the flags, so an edited source is rebuilt. Unlike
the JAX package, a failed build raises with the compiler's output instead of
falling back to the numpy generators, whose boards differ from the same seed:
`use_native=False` in `maze_gen` / `gen_sudoku` is the explicit way there.
ctypes releases the GIL inside the generators, so a pool can be generated on
a background thread while the device trains.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "datagen.cpp"
BUILD_DIR = CSRC / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")  # native/Makefile


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} on PATH: the data generators "
                           f"build from {SOURCE} with it")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((_cxx(), *CXX_FLAGS)).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"datagen-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. The output
    goes to a temporary file renamed into place, so concurrent builds see
    all of it or none."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The generator library, built first where needed."""
    lib = ctypes.CDLL(str(build()))
    lib.maze_gen_batch.restype = ctypes.c_int
    lib.maze_gen_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sudoku_gen_batch.restype = ctypes.c_int
    lib.sudoku_gen_batch.argtypes = [
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int8),
    ]
    return lib


def maze_gen_native(
    n: int,
    dim_x: int = 7,
    dim_y: int = 7,
    weight_high: float = 99.0,
    weight_low: float = 97.0,
    random_transform: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """(n, 1, H, W) solved mazes in {0,1,2}. Raises when the generator gives
    up (it tries 50 mazes per one asked for)."""
    H, W = 2 * dim_y + 1, 2 * dim_x + 1
    out = np.empty((n, H, W), np.uint8)
    produced = load().maze_gen_batch(
        n, dim_x, dim_y, weight_high, weight_low, int(random_transform),
        seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if produced < n:
        raise RuntimeError(f"the maze generator solved {produced} of {n} mazes")
    return out[:, None, :, :]


def sudoku_gen_native(n: int, seed: int = 0) -> np.ndarray:
    """(n, 81) solved boards, int32 cell values 0..8."""
    out = np.empty((n, 81), np.int8)
    load().sudoku_gen_batch(n, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out.astype(np.int32)
