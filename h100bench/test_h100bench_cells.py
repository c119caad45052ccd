"""Whole runs of each cell on the CPU at tiny widths, in fresh processes: the
program against the frozen reference, the control and every fault the
cell can have coming out as not correct, a run without the program, and
cells of a second reference family added as new files alone.

The cells come from BENCHMARK.json, so a cell that a later change adds gets
these tests by the kind of its traffic."""

from __future__ import annotations

import hashlib
import json

import pytest

from h100bench import common
from h100bench.conftest import NO_CUDA_WAIT, ROOT, make_tree, run_cell, shrink_config
from h100bench.faults import (HALF_BATCH, JAX_ON_A_RANK, NO_EXCHANGE, REFLECTED,
                              TOKEN_ALTERED, UNCHANGED_SAMPLER, UNCHANGED_STATE,
                              UNIFORM_DESTINATIONS)

MANIFEST = common.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TRAFFIC = {w["name"]: common.load_traffic(w["traffic"]) for w in MANIFEST["workloads"]}
CHIPS = {w["name"]: int(w["chips"]) for w in MANIFEST["workloads"]}
MULTI = [c for c in CELLS if int(TRAFFIC[c].get("ranks", 1)) > 1]

# the faults a cell of each kind can have, planted in the program
KIND_FAULTS = {"sample": (UNCHANGED_SAMPLER, TOKEN_ALTERED, REFLECTED, UNIFORM_DESTINATIONS),
               "train": (UNCHANGED_STATE, HALF_BATCH)}
FAULTS = [(cell, fault) for kind in KIND_FAULTS for cell in CELLS
          if TRAFFIC[cell]["kind"] == kind for fault in KIND_FAULTS[kind]] + [
    (cell, NO_EXCHANGE) for cell in MULTI]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_tree, workload):
    code, line, err = run_cell(tiny_tree, workload)
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    expected = {m["name"] for m in common.cell_metrics(MANIFEST, workload, "end_to_end")}
    assert "setup_s" in line["metrics"] and set(line["metrics"]) == expected
    assert line["device"]["count"] == CHIPS[workload]
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
    name = common.load_kind(TRAFFIC[workload]["kind"]).CONTROL_NUMBER
    code, sound, err = run_cell(tiny_tree, workload)
    assert code == 0, err[-3000:]
    code, control, err = run_cell(tiny_tree, workload, extra=("--variant", "bf16"))
    assert code == 0, err[-3000:]
    assert control["checks"][name]["value"] > 3 * sound["checks"][name]["value"]


@pytest.mark.parametrize("variant", ["half_batch", "no_exchange"])
def test_reference_faults_are_not_correct(tiny_tree, variant):
    code, line, err = run_cell(tiny_tree, MULTI[0], extra=("--variant", variant))
    assert code == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_jax_on_any_rank_prints_no_result(tiny_tree):
    code, line, err = run_cell(tiny_tree, MULTI[0], fault=JAX_ON_A_RANK)
    assert code != 0 and line is None
    assert "['jax']" in err


def test_without_the_program_no_result(tiny_tree):
    code, line, err = run_cell(tiny_tree, CELLS[0], program=False)
    assert code != 0 and line is None


def digest(tree) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


# a second reference family: every member forwarded to tau_unet, each call
# noted in a file at the root of the checkout
FORWARDED = '''
from pathlib import Path

from h100bench.reference import tau_unet

CALLS = Path(__file__).resolve().parents[2] / "family_calls.txt"


def noted(member):
    def call(*args, **kwargs):
        with open(CALLS, "a") as f:
            f.write(member + "\\n")
        return getattr(tau_unet, member)(*args, **kwargs)
    return call


Net = noted("Net")
process = noted("process")
per_row_loss = noted("per_row_loss")
forward_flops = noted("forward_flops")
shrink = noted("shrink")
'''


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    tree = make_tree(tmp_path)
    before = digest(tree)
    bench = tree / "h100bench"
    manifest = json.loads((tree / "BENCHMARK.json").read_text())
    # a reference family, a configuration that names it, a traffic mix, a
    # metric and the two cells' limits: new files
    (bench / "reference" / "forwarded.py").write_text(FORWARDED)
    cfg = json.loads((ROOT / "h100bench" / "configs" / "tauUnet_mnist.json").read_text())
    cfg["about"]["reference"] = "forwarded"
    (bench / "configs" / "tiny_extra.json").write_text(json.dumps(cfg))
    shrink_config(bench / "configs" / "tiny_extra.json", bench)
    (bench / "traffic" / "offline_n8.json").write_text(json.dumps(
        {"kind": "sample", "n": 8, "checked_among": 2}))
    (bench / "metrics" / "batches_per_s.py").write_text(
        "def read(ctx):\n    c = ctx.counters\n"
        "    return c['batches'] / c['window_s'] if 'batches' in c else None\n")
    for cell, like in (("extra_sample_n8", "mnist_sample_n512"),
                       ("extra_train_b4", "mnist_train_b256")):
        (bench / "limits" / f"{cell}.json").write_text(
            (bench / "limits" / f"{like}.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="tiny_extra",
                                    file="h100bench/configs/tiny_extra.json"))
    manifest["workloads"] += [
        {"name": "extra_sample_n8", "config": "tiny_extra", "traffic": "offline_n8",
         "chips": 1, "why": "a throwaway"},
        {"name": "extra_train_b4", "config": "tiny_extra", "traffic": "train_1card",
         "chips": 1, "why": "a throwaway"}]
    manifest["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                                   "better": "higher", "bound": 0.01, "source": "host_clock",
                                   "workloads": ["extra_sample_n8"]})
    # the train cell reads the training spans, the only per-layer metrics a
    # traced run on the CPU reads
    spans_read = [m for m in manifest["per_layer"]
                  if m["source"] == "program_span" and m["moves"] == "train_samples_per_s"]
    for m in spans_read + [m for m in manifest["end_to_end"]
                           if m["name"] == "train_samples_per_s"]:
        m["workloads"].append("extra_train_b4")
    (tree / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = digest(tree)
    changed = [p for p in before if p != "BENCHMARK.json" and before[p] != after.get(p)]
    assert changed == []

    code, line, err = run_cell(tree, "extra_sample_n8")
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"batches_per_s", "setup_s"}
    assert line["attempted"] % 8 == 0
    # traced, so that the FLOP count is taken too
    code, line, err = run_cell(tree, "extra_train_b4", fault=NO_CUDA_WAIT,
                               extra=("--trace", "1"))
    assert code == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert spans_read and set(line["metrics"]) == {m["name"] for m in spans_read}
    calls = set((tree / "family_calls.txt").read_text().split())
    assert calls == set(common.FAMILY_MEMBERS)
