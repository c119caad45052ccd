"""Time the tensor-core kernels against the CUDA-core kernels they replaced.

    python3 compare_kernels.py OLD_DIR      (from the repository's root)

OLD_DIR holds `fused_tau_leap.cu` and `reverse_rates.cu` as they stood in
commit ca0a97d (`git show ca0a97d:ctdd_tpu_torch/csrc/<name>.cu`, written into
a directory that git ignores). This script is bound to the C interface of
those two sources (unpadded tables, no vector flags) and serves that one
comparison: a later source needs its own argument list here. Both versions
are built, run on the same inputs at N=256 and N=16 (D=784, S=256) and
timed in turns old, new, new, old inside this one process, so the four
numbers come from one card. Needs a CUDA device and nvcc; prints one JSON
line per kernel and shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import card_line, cuda_ms, device_ms, fused_inputs, rate_inputs
from ctdd_tpu_torch.ops import _build
from ctdd_tpu_torch.ops import fused_update as fu
from ctdd_tpu_torch.ops import rate_kernels as rk


def build_old(old_dir: Path, name: str) -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"{name}-earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(old_dir / f"{name}.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def old_fused(lib):
    """The earlier interface: bf16 qt0, qt0^T and rate^T, unpadded."""
    fn = lib.fused_tau_leap_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(logits, x, qt0, rate, h):
        N, D, S = logits.shape
        qt0b = qt0.to(torch.bfloat16).contiguous()
        qt0Tb = qt0b.t().contiguous()
        rateTb = rate.to(torch.bfloat16).t().contiguous()
        out = torch.empty((N, D), dtype=torch.int32, device=logits.device)
        err = fn(logits.data_ptr(), x.data_ptr(), x.data_ptr(), qt0b.data_ptr(),
                 qt0Tb.data_ptr(), rateTb.data_ptr(), None, out.data_ptr(),
                 N * D, S, h, 1e-9, 3, 0, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier fused kernel: CUDA error {err}")
        return out

    return call


def old_rates(lib):
    fn = lib.reverse_rates_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(logits, qc, qt0, rc, x):
        N, D, S = logits.shape
        out = torch.empty_like(logits)
        err = fn(logits.data_ptr(), qc.data_ptr(), qt0.data_ptr(), rc.data_ptr(),
                 x.data_ptr(), out.data_ptr(), N, D, S, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier reverse-rates kernel: CUDA error {err}")
        return out

    return call


def turns(old, new, iters) -> dict:
    """old, new, new, old, in that order: ms of device time per call (0.0
    where the profiler cannot trace the card) and ms per turn of a
    back-to-back loop, which at N=16 waits for the host."""
    dev = [device_ms(f, iters) for f in (old, new, new, old)]
    loop = [cuda_ms(f, iters) for f in (old, new, new, old)]
    return {"old_ms": [dev[0], dev[3]], "new_ms": [dev[1], dev[2]],
            "old_loop_ms": [loop[0], loop[3]], "new_loop_ms": [loop[1], loop[2]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    old_dir = Path(sys.argv[1])
    dev = torch.device("cuda", 0)
    card = card_line()
    _build.build(["fused_tau_leap", "reverse_rates"])
    fused_old = old_fused(build_old(old_dir, "fused_tau_leap"))
    rates_old = old_rates(build_old(old_dir, "reverse_rates"))
    D, S = 784, 256
    for N in (256, 16):
        iters = 20 if N == 256 else 200
        logits, x, qt0, rate, _, h = fused_inputs(N, D, S, 500, 1, dev)
        t = turns(
            lambda: fused_old(logits, x, qt0, rate, h),
            lambda: fu.fused_tau_leap_update(logits, x, x, qt0, rate, h, 1e-9, 3),
            iters)
        print(json.dumps({"kernel": "fused_tau_leap_update", "N": N, "card": card,
                          **t}), flush=True)
        logits, qc, qt0, rc, x, _ = rate_inputs(N, D, S, (0.5,), 1, dev, False)
        a, b = rates_old(logits, qc, qt0, rc, x), rk.reverse_rates(logits, qc, qt0, rc, x)
        scale = a.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        t = turns(
            lambda: rates_old(logits, qc, qt0, rc, x),
            lambda: rk.reverse_rates(logits, qc, qt0, rc, x), iters)
        print(json.dumps({"kernel": "reverse_rates", "N": N, "card": card, **t,
                          "old_vs_new_row_rel": ((a - b).abs() / scale).max().item()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
