"""BENCHMARK.json against the benchmark's contract, and discovery of its
files by name."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|ch$|"
                    r"ch_mult|experts_per")

MANIFEST = common.load_manifest()


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "h100bench/run.py"]
    assert MANIFEST["paths"] == ["h100bench"]
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("h100bench/configs/")
        cfg, about = common.load_config(MANIFEST, c["name"])
        assert about["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key.split(".")[-1]), key
            group, name = key.split(".")
            assert cfg[group][name] != about["published"][key]


def test_workloads():
    w = MANIFEST["workloads"]
    assert [x["name"] for x in w] == ["mnist_sample_n512", "mnist_train_b256",
                                     "cifar_train_b128", "cifar_train_dp4_b512"]
    pairs = {(x["config"], x["traffic"]) for x in w}
    assert len(pairs) == len(w)
    four = [x["name"] for x in w if x["chips"] == 4]
    assert four == ["cifar_train_dp4_b512"]
    assert all(x["chips"] in (1, 4) for x in w)


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {x["name"] for x in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {x["name"] for x in common.cell_metrics(MANIFEST, cell, "end_to_end")}
    for cell in cells:
        e = [x["name"] for x in common.cell_metrics(MANIFEST, cell, "end_to_end")]
        assert "setup_s" in e and len(e) >= 2
        assert common.cell_metrics(MANIFEST, cell, "per_layer")


def test_run_seconds_fits_the_full_check():
    rs = MANIFEST["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_are_found_by_name():
    for w in MANIFEST["workloads"]:
        traffic = common.load_traffic(w["traffic"])
        assert hasattr(common.load_kind(traffic["kind"]), "run")
        limits = common.load_limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(common.load_reader(m["name"]).read)
