"""The harness's arithmetic on made-up traces and counters, its counts of
FLOPs and bytes, and the checks that no run holds JAX or the JAX package
and that the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import common

HERE = Path(__file__).resolve().parent


def trace(device, wall_s=1e-3, units=2):
    return common.Trace(device=device, host=[], wall_s=wall_s, units=units)


def test_union_merges_overlaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0), ("d", 32.0, 35.0)]
    assert common.union(ops) == [(0.0, 20.0), (30.0, 40.0)]


def test_idle_share_counts_overlapping_streams_once():
    # an NCCL kernel beside a compute kernel: a sum would read 1.5 ms busy
    t = trace([("gemm", 0.0, 500.0), ("ncclDevKernel_AllReduce", 0.0, 500.0),
               ("gemm", 500.0, 800.0)], wall_s=1e-3)
    assert t.busy_s() == pytest.approx(800e-6)
    assert common.idle_share_pct(t) == pytest.approx(20.0)


def test_idle_share_never_negative():
    # device timestamps spanning more than the host's wall: the span counts
    t = trace([("k", 0.0, 2000.0)], wall_s=1e-3)
    assert common.idle_share_pct(t) == pytest.approx(0.0)


def ctx(**counters):
    c = common.Context(cfg={}, traffic={}, setup_s=1.0)
    c.counters.update(counters)
    return c


def test_mfu_readers():
    c = ctx(window_s=2.0, batches=4, flops_per_batch=989e12 * 0.05)
    assert common.load_reader("mfu.sample").read(c) == pytest.approx(10.0)
    c = ctx(window_s=1.0, steps=10, flops_per_step=989e12 * 0.01, ranks=1)
    assert common.load_reader("mfu.train").read(c) == pytest.approx(10.0)
    assert common.load_reader("mfu.dp4").read(c) is None
    c = ctx(window_s=1.0, steps=10, flops_per_step=4 * 989e12 * 0.01, ranks=4)
    assert common.load_reader("mfu.dp4").read(c) == pytest.approx(10.0)
    assert common.load_reader("mfu.train").read(c) is None


def test_roofline_reader():
    nbytes = common.fused_tau_leap_bytes(256, 784, 256)
    c = ctx(fused_tau_leap_bytes=nbytes)
    bound_us = nbytes / 3.35e12 * 1e6
    c.trace = trace([("void fused_tau_leap_kernel<true, 0>", 0.0, 4 * bound_us),
                     ("other", 0.0, 1.0)])
    assert common.load_reader("fused_tau_leap.roofline").read(c) == pytest.approx(25.0)
    c.trace = trace([("other", 0.0, 1.0)])
    assert common.load_reader("fused_tau_leap.roofline").read(c) is None


def test_allreduce_and_idle_readers():
    c = ctx(ranks=4)
    c.trace = trace([("ncclDevKernel_AllReduce_Sum_f32", 0.0, 600.0),
                     ("gemm", 0.0, 1000.0), ("ncclDevKernel_AllReduce_Sum_f32", 1200.0, 1400.0)],
                    wall_s=2e-3, units=2)
    assert common.load_reader("allreduce_ms.dp4").read(c) == pytest.approx(0.4)
    assert common.load_reader("idle_share.dp4").read(c) == pytest.approx(40.0)
    assert common.load_reader("idle_share.train").read(c) is None
    assert common.load_reader("idle_share.sample").read(c) is None


def test_rate_readers():
    c = ctx(window_s=4.0, samples=1000, batches=4)
    assert common.load_reader("samples_per_s").read(c) == pytest.approx(250.0)
    assert common.load_reader("train_samples_per_s").read(c) is None
    c = ctx(window_s=2.0, samples=1000, steps=10, ranks=1)
    assert common.load_reader("train_samples_per_s").read(c) == pytest.approx(500.0)
    assert common.load_reader("dp_train_samples_per_s").read(c) is None
    assert common.load_reader("setup_s").read(c) == 1.0


def test_breakdown_names_ops_and_gaps():
    t = common.Trace(device=[("k1", 0.0, 10.0), ("k2", 50.0, 60.0), ("k1", 61.0, 70.0)],
                     host=[("aten::item", 5.0, 55.0, 0), ("cudaStreamSynchronize", 10.0, 50.0, 1)],
                     wall_s=1e-4, units=1)
    b = common.breakdown(t)
    assert b["device_ops"][0] == ["k1", pytest.approx(19e-6)]
    assert b["idle_gaps"][0] == ["aten::item/cudaStreamSynchronize", pytest.approx(40e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("name, gflop", [("tauUnet_mnist", 5.226), ("tauUnet_cifar10", 11.444)])
def test_forward_flops_per_sample(name, gflop):
    cfg, _ = common.load_config(common.load_manifest(), name)
    assert common.forward_flops(cfg, 1) / 1e9 == pytest.approx(gflop, rel=1e-3)
    assert common.forward_flops(cfg, 4) == pytest.approx(4 * common.forward_flops(cfg, 1))


def test_fused_kernel_bytes():
    # PERF.md's bound for kernel 1: 0.06222 ms at 3.35 TB/s
    assert common.fused_tau_leap_bytes(256, 784, 256) == 208_453_632
    assert common.fused_tau_leap_bytes(256, 784, 256) / 3.35e12 * 1e3 == pytest.approx(
        0.06222, rel=1e-3)


def test_forbidden_modules_compares_whole_top_level_names():
    assert common.forbidden_modules({"ctdd_tpu_torch": 1, "ctdd_tpu_torch.ops": 1,
                                     "numpy": 1, "jaxtyping": 1}) == []
    assert common.forbidden_modules({"ctdd_tpu.ops": 1, "jax": 1, "jaxlib.xla": 1,
                                     "flax.linen": 1}) == ["ctdd_tpu", "flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("ctdd_tpu_torch", "ctdd_tpu", "jax", "flax"), (
                    path.name, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import h100bench.reference.unet, h100bench.reference.process, "
            "h100bench.reference.train, h100bench.reference.sample\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ctdd_tpu_torch', 'ctdd_tpu', 'jax', 'jaxlib', 'flax'})\n"
            "print(bad); sys.exit(1 if bad else 0)") % str(HERE.parent)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100bench import common, program, run\n"
            "for k in ('sample', 'train'): common.load_kind(k)\n"
            "import ctdd_tpu_torch.sampling.samplers, ctdd_tpu_torch.parallel.dp\n"
            "import ctdd_tpu_torch.losses.losses, ctdd_tpu_torch.models.zoo\n"
            "print(common.forbidden_modules()); sys.exit(1 if common.forbidden_modules() else 0)"
            ) % str(HERE.parent)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
