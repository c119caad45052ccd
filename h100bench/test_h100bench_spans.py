"""The charging of device time to the program's spans (spans.py) on
hand-made Chrome-trace events, and a `--trace 1` run of each kind on the CPU
that reads every span metric."""

from __future__ import annotations

import json

import pytest

from h100bench import common, spans
from h100bench.conftest import make_tree, run_cell

SPAN_METRICS = {
    "mnist_train_b256": {"loss_span_ms.train", "network_span_ms.train",
                         "update_span_ms.train", "update_idle_ms.train"},
    "mnist_sample_n512": {"network_span_ms.sample"},
}

# the CPU build has no CUDA to wait for: the kinds' waits become no-ops
NO_CUDA_WAIT = """
import torch
torch.cuda.synchronize = lambda *a, **k: None
"""


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": {k.replace("_", " "): v for k, v in args.items()}}


def span(name, ts, dur, tid=1):
    return ev(name, "user_annotation", ts, dur, tid)


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 1.0, tid, correlation=corr)


def kernel(name, ts, dur, corr):
    return ev(name, "kernel", ts, dur, tid=7, correlation=corr)


def step_events():
    """One step: the loss around the network, a backward on the autograd
    engine's thread, an update; the segment runs from 0 to 1000 us."""
    return [
        span(spans.SEGMENT, 0.0, 1000.0),
        span("ctdd.train.loss", 10.0, 90.0),
        span("ctdd.network", 20.0, 40.0),
        ev("aten::addmm", "cpu_op", 22.0, 10.0, Sequence_number=5, Fwd_thread_id=0),
        launch(25.0, 1),
        ev("aten::mean", "cpu_op", 70.0, 10.0, Sequence_number=6, Fwd_thread_id=0),
        launch(72.0, 2),
        span("ctdd.train.backward", 110.0, 190.0),
        ev("autograd::engine::evaluate_function: MeanBackward0", "cpu_op", 120.0, 10.0, tid=2,
           Sequence_number=6, Fwd_thread_id=1),
        launch(122.0, 3, tid=2),
        ev("autograd::engine::evaluate_function: AddmmBackward0", "cpu_op", 140.0, 20.0,
           tid=2, Sequence_number=5, Fwd_thread_id=1),
        launch(145.0, 4, tid=2),
        ev("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", "cpu_op",
           170.0, 10.0, tid=2),
        launch(172.0, 5, tid=2),
        span("ctdd.train.update", 600.0, 300.0),
        launch(610.0, 6),
        launch(890.0, 7),
        kernel("gemm", 100.0, 200.0, 1),     # the network's forward
        kernel("mean", 300.0, 50.0, 2),      # the loss's own op
        kernel("mean_bwd", 350.0, 50.0, 3),  # its backward
        kernel("gemm_bwd", 400.0, 100.0, 4),  # the network's backward
        kernel("accumulate", 500.0, 20.0, 5),
        kernel("adam", 620.0, 30.0, 6),
        kernel("ema", 895.0, 5.0, 7),
        kernel("orphan", 950.0, 10.0, 99),   # no launch in the trace
    ]


def test_kernel_is_charged_through_its_launch():
    c = spans.charge(step_events(), units=1)
    assert c.device_us[("ctdd.train.loss", "ctdd.network")] == pytest.approx(300.0)
    assert c.device_ms("ctdd.train.update") == pytest.approx(0.035)
    assert c.ops[("ctdd.train.update",)] == 2
    assert c.calls == {"ctdd.train.loss": 1, "ctdd.network": 1, "ctdd.train.backward": 1,
                       "ctdd.train.update": 1}


def test_backward_op_is_charged_through_its_sequence_number():
    c = spans.charge(step_events(), units=1)
    # gemm 200 + gemm_bwd 100; mean 50 + mean_bwd 50; AccumulateGrad's kernel
    assert c.device_ms("ctdd.network") == pytest.approx(0.3)
    assert c.device_ms("ctdd.train.loss", self_only=True) == pytest.approx(0.1)
    assert c.device_ms("ctdd.train.backward") == pytest.approx(0.02)


def test_self_time_leaves_out_the_spans_inside():
    c = spans.charge(step_events(), units=2)
    assert c.device_ms("ctdd.train.loss") == pytest.approx(0.2)
    assert c.device_ms("ctdd.train.loss", self_only=True) == pytest.approx(0.05)
    assert c.unattributed == {"orphan": 10.0}
    assert c.busy_us == pytest.approx(465.0)
    assert c.charged_us == pytest.approx(455.0)


def test_idle_is_charged_to_the_span_the_host_was_in():
    c = spans.charge(step_events(), units=1)
    # busy 100-520, 620-650, 895-900, 950-960 of the segment 0-1000
    assert c.idle_ms("ctdd.train.update") == pytest.approx((20 + 245) / 1e3)
    assert c.idle_us[("ctdd.train.loss",)] == pytest.approx(50.0)
    assert c.idle_us[("ctdd.train.loss", "ctdd.network")] == pytest.approx(40.0)
    assert c.idle_ms("ctdd.train.loss") == pytest.approx(0.09)
    assert c.idle_us[()] == pytest.approx(10 + 80 + 50 + 40)
    assert sum(c.idle_us.values()) == pytest.approx(1000 - 465)


def test_on_the_cpu_the_innermost_ops_stand_for_kernels():
    events = [
        span(spans.SEGMENT, 0.0, 100.0),
        span("ctdd.train.loss", 0.0, 50.0),
        span("ctdd.network", 5.0, 20.0),
        ev("aten::linear", "cpu_op", 6.0, 15.0, Sequence_number=1, Fwd_thread_id=0),
        ev("aten::addmm", "cpu_op", 8.0, 10.0, Sequence_number=1, Fwd_thread_id=0),
        ev("aten::mean", "cpu_op", 30.0, 10.0, Sequence_number=2, Fwd_thread_id=0),
        span("ctdd.train.backward", 60.0, 30.0),
        ev("autograd::engine::evaluate_function: AddmmBackward0", "cpu_op", 62.0, 20.0,
           Sequence_number=1, Fwd_thread_id=1),
        ev("aten::mm", "cpu_op", 64.0, 10.0),
    ]
    c = spans.charge(events, units=1, cpu=True)
    assert c.device_us == {("ctdd.train.loss", "ctdd.network"): 20.0,
                           ("ctdd.train.loss",): 10.0}
    assert c.busy_us == pytest.approx(30.0)


def test_a_program_without_spans_reads_nothing():
    c = common.Context(cfg={}, traffic={}, setup_s=1.0)
    assert spans.of(c) is None  # no trace
    c.trace = common.Trace(device=[], host=[], wall_s=1.0, units=1)
    c.counters.update(ranks=1)
    for name in set().union(*SPAN_METRICS.values()):
        assert common.load_reader(name).read(c) is None


@pytest.fixture(scope="module")
def span_tree(tmp_path_factory):
    """The tiny tree with the span metrics alone as per-layer metrics: the
    others time the card with CUDA events."""
    tree = make_tree(tmp_path_factory.mktemp("spans"))
    manifest = json.loads((tree / "BENCHMARK.json").read_text())
    manifest["per_layer"] = [m for m in manifest["per_layer"]
                             if m["source"] == "program_span"]
    (tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tree


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reads_every_span_metric(span_tree, workload):
    code, line, err = run_cell(span_tree, workload, fault=NO_CUDA_WAIT,
                               extra=("--trace", "1"))
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == SPAN_METRICS[workload]
    assert all(m["value"] > 0 for m in line["metrics"].values())
    summary = json.loads(next(s for s in err.splitlines() if s.startswith("spans: "))[7:])
    assert summary["charged_pct"] >= 95.0, summary
    assert "ctdd.network" in summary["calls"]
