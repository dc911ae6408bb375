"""BENCHMARK.json and the files it names: every cell and metric loads from
its own files, the file keeps to the benchmark's format, and a cell added
as new files is found without an edit to any existing file."""

import hashlib
import json
import re
import time

import pytest

from benchmark import harness, spec
from benchmark.tests.tiny import tiny_root

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_its_files(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    gen = spec.generator(cell.config["generator"])
    assert callable(gen.build)
    assert cell.traffic["entry"] in ("solve", "solve_batch")
    assert set(cell.settings["limits"]) == {"not_solved", "kkt_rel"}
    assert cell.settings["limits"]["not_solved"] == 0
    for entry in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric(entry["name"]).read), entry["name"]
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer one.
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all("/" not in w or w.startswith("benchmark")
               for w in BENCH["command"])
    # A full check of 24 cells fits the driver's 43,200 s.
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and config["assumed"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for n in CELLS + [c["name"] for c in BENCH["configs"]]:
        assert NAME.match(n)


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_is_found_and_runs(tmp_path):
    before = _digests(spec.ROOT / "benchmark")
    root = tiny_root(tmp_path)
    after = _digests(root / "benchmark")
    # Only new files in the copy; the existing ones are byte for byte the
    # same.
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/tiny.json", "traffic/tiny-mix.json", "cells/tiny.mix.json",
        "metrics/lps_attempted.py"}
    cell = spec.load_cell("tiny.mix", root)
    assert cell.config["instance"]["n"] == 300
    assert "lps_attempted" in {m["name"] for m in cell.end_to_end}
    with pytest.raises(KeyError, match="tiny.mix"):
        spec.load_cell("tiny.mix")
    result = harness.run_cell(cell, 2**33 + 17, 0.5, False, "cpu",
                              time.perf_counter())
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    m = result["metrics"]
    assert m["lps_attempted"]["value"] == result["attempted"] >= 1
    assert m["lp_per_s"]["unit"] == "lp/s" and m["lp_per_s"]["value"] > 0
    # A CPU run writes nothing under a device metric.
    assert "peak_mem_gb" not in m
    assert result["device"]["platform"] == "cpu"


def test_a_traced_cpu_run_reports_no_device_metric(tmp_path):
    cell = spec.load_cell("tiny.mix", tiny_root(tmp_path))
    result = harness.run_cell(cell, 5, 0.2, True, "cpu", time.perf_counter())
    assert result["correct"]
    assert "breakdown" not in result and "busy_s" not in result["device"]
    assert not {"idle_share", "device_ops_per_iter", "k1_batch_roofline",
                "csr_roofline"} & set(result["metrics"])
