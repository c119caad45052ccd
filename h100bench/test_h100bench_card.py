"""A short run of each one-card cell on the card itself: `correct` true and
every end-to-end metric read. Skipped where there is no CUDA device; run on
the chip with `python3 -m pytest -m cuda h100bench/`."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from h100bench import common

ONE_CARD = [w["name"] for w in common.load_manifest()["workloads"] if w["chips"] == 1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_on_the_card(card, workload):
    cmd = [sys.executable, str(common.HERE / "run.py"), "--workload", workload,
           "--seed", "4000000001", "--seconds", "1", "--trace", "0"]
    done = subprocess.run(cmd, capture_output=True, text=True, cwd=common.ROOT, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    expected = {m["name"] for m in common.cell_metrics(common.load_manifest(), workload,
                                                        "end_to_end")}
    assert set(line["metrics"]) == expected
    assert line["device"]["platform"] == "gpu"
