"""The manifest against the benchmark's rules of form, and a cell, a
configuration, a traffic mix and a per-layer metric added as new files
with no edit to a file that exists."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.core import runner
from benchmark.core.manifest import NAME, UNIT, Bench, problems
from benchmark.tests.tiny import ROOT, tiny_run

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


def test_manifest_keeps_the_rules_of_form(bench):
    assert problems(bench) == []
    m = bench.man
    assert set(m) == TOP
    for group, keys in KEYS.items():
        for entry in m[group]:
            assert set(entry) <= keys, entry
            assert keys - {"workloads"} <= set(entry), entry
    assert m["command"][1] == "benchmark/run.py" and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(bench, group):
    for entry in bench.man[group]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
        for key in entry.get("reduced", []):
            assert NAME.match(key)


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    e2e = {e["name"]: e for e in bench.man["end_to_end"]}
    for p in bench.man["per_layer"]:
        for cell in p["workloads"]:
            assert cell in e2e[p["moves"]]["workloads"], (p["name"], cell)


def test_every_configuration_has_a_cell_and_its_file(bench):
    for c in bench.man["configs"]:
        assert any(w["config"] == c["name"] for w in bench.man["workloads"])
        cfg = bench.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_every_cell_finds_its_files(bench):
    for w in bench.man["workloads"]:
        mix = bench.traffic(w["traffic"])
        assert hasattr(bench.kind(mix["kind"]), "window")
        assert bench.limits(w["name"])["numbers"], w["name"]
        for p in bench.per_layer_for(w["name"]):
            assert callable(bench.reader(p["name"]))


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a mix of the serving
    kind, a metric and a cell: only new files and new manifest entries."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/flagship.json").read_text())
    cfg.update(name="scan_k5", model={**cfg["model"], "kernels": [[5, 5], [5, 5]],
                                      "out_kernel": [5, 5]})
    (tmp_path / "benchmark/configs/scan_k5.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/serve.json").read_text())
    mix["pool_shots"] = 4
    (tmp_path / "benchmark/traffic/serve4.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/shots_done.py").write_text(
        "def read(run):\n    return run.counters.get('shots')\n")
    (tmp_path / "benchmark/limits/scan_k5-serve4.json").write_text(json.dumps(
        {"numbers": {"spec_max_abs": {"limit": 1.0}}}))
    man["configs"].append({"name": "scan_k5", "source": cfg["source"],
                           "file": "benchmark/configs/scan_k5.json", "reduced": [],
                           "why": "k5"})
    man["workloads"].append({"name": "scan_k5-serve4", "config": "scan_k5",
                             "traffic": "serve4", "chips": 1, "why": "k5 serving"})
    for e in man["end_to_end"]:
        if "specs_per_s" == e["name"] or "shot_p95_ms" == e["name"]:
            e["workloads"].append("scan_k5-serve4")
    man["per_layer"].append({"name": "shots_done", "unit": "shots", "better": "higher",
                             "source": "host_clock", "layer": "service", "moves": "specs_per_s",
                             "workloads": ["scan_k5-serve4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    bench = Bench(tmp_path)
    assert problems(bench) == []
    run = tiny_run("scan_k5-serve4", trace=True, bench=bench)
    assert run.config["model"]["kernels"] == [[5, 5], [5, 5]]
    assert run.mix["pool_shots"] == 2 and "shots_done" in [p["name"] for p in
                                                           bench.per_layer_for(run.workload["name"])]
    runner.execute(run)
    assert runner.metrics(run)["shots_done"]["value"] == run.counters["shots"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
