"""Whole runs of each cell on the CPU at tiny widths, in fresh processes: the
program against the frozen reference, the control and every fault the
cell can have coming out as not correct, a run without the program, and a
cell added as new files alone."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from h100bench.conftest import make_tree, run_cell
from h100bench.faults import (HALF_BATCH, JAX_ON_A_RANK, NO_EXCHANGE, REFLECTED,
                              TOKEN_ALTERED, UNCHANGED_SAMPLER, UNCHANGED_STATE,
                              UNIFORM_DESTINATIONS)

SINGLE = ["mnist_sample_n512", "mnist_train_b256", "cifar_train_b128"]
CELLS = SINGLE + ["cifar_train_dp4_b512"]

FAULTS = [("mnist_sample_n512", f) for f in (
    UNCHANGED_SAMPLER, TOKEN_ALTERED, REFLECTED, UNIFORM_DESTINATIONS)] + [
    (cell, fault) for cell in SINGLE[1:] + ["cifar_train_dp4_b512"]
    for fault in (UNCHANGED_STATE, HALF_BATCH)] + [("cifar_train_dp4_b512", NO_EXCHANGE)]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_tree, workload):
    code, line, err = run_cell(tiny_tree, workload)
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert line["device"]["count"] == (4 if "dp4" in workload else 1)
    # the compared numbers are the last lines on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{w}-{i}" for i, (w, _) in enumerate(FAULTS)])
def test_fault_is_not_correct(tiny_tree, workload, fault):
    code, line, err = run_cell(tiny_tree, workload, fault=fault)
    assert code == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_separates(tiny_tree, workload):
    # the limits are set on the card at the cells' sizes; at tiny widths the
    # control has to read well above a sound run of the same seed
    name = "denoise_gap" if "sample" in workload else "first_logits_gap"
    code, sound, err = run_cell(tiny_tree, workload)
    assert code == 0, err[-3000:]
    code, control, err = run_cell(tiny_tree, workload, extra=("--variant", "bf16"))
    assert code == 0, err[-3000:]
    assert control["checks"][name]["value"] > 3 * sound["checks"][name]["value"]


@pytest.mark.parametrize("variant", ["half_batch", "no_exchange"])
def test_reference_faults_are_not_correct(tiny_tree, variant):
    code, line, err = run_cell(tiny_tree, "cifar_train_dp4_b512", extra=("--variant", variant))
    assert code == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_jax_on_any_rank_prints_no_result(tiny_tree):
    code, line, err = run_cell(tiny_tree, "cifar_train_dp4_b512", fault=JAX_ON_A_RANK)
    assert code != 0 and line is None
    assert "['jax']" in err


def test_without_the_program_no_result(tiny_tree):
    code, line, err = run_cell(tiny_tree, "mnist_sample_n512", program=False)
    assert code != 0 and line is None


def digest(tree) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    tree = make_tree(tmp_path)
    before = digest(tree)
    bench = tree / "h100bench"
    manifest = json.loads((tree / "BENCHMARK.json").read_text())
    # a configuration, a traffic mix, a metric and the cell's limits: new files
    shutil.copy(bench / "configs" / "tauUnet_mnist.json", bench / "configs" / "tiny_extra.json")
    (bench / "traffic" / "offline_n8.json").write_text(json.dumps(
        {"kind": "sample", "n": 8, "checked_among": 2}))
    (bench / "metrics" / "batches_per_s.py").write_text(
        "def read(ctx):\n    c = ctx.counters\n"
        "    return c['batches'] / c['window_s'] if 'batches' in c else None\n")
    (bench / "limits" / "extra_sample_n8.json").write_text(
        (bench / "limits" / "mnist_sample_n512.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="tiny_extra",
                                    file="h100bench/configs/tiny_extra.json"))
    manifest["workloads"].append({"name": "extra_sample_n8", "config": "tiny_extra",
                                  "traffic": "offline_n8", "chips": 1, "why": "a throwaway"})
    manifest["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                                   "better": "higher", "bound": 0.01, "source": "host_clock",
                                   "workloads": ["extra_sample_n8"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = digest(tree)
    changed = [p for p in before if p != "BENCHMARK.json" and before[p] != after.get(p)]
    assert changed == []
    code, line, err = run_cell(tree, "extra_sample_n8")
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"batches_per_s", "setup_s"}
    assert line["attempted"] % 8 == 0
