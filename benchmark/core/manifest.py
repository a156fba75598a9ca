"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own, so a cell, a configuration, a
mix or a metric is added by adding files and entries:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  code ``kinds/<kind>.py`` that reads them;
- ``metrics/<metric>.py``: the reader of one per-layer metric, ``read(run)``;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}


class Bench:
    """The manifest at ``root``/BENCHMARK.json and the benchmark's folder."""

    def __init__(self, root: Path, folder: str = "benchmark"):
        self.root = Path(root)
        self.dir = self.root / folder
        self.man = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.man["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in self.man['workloads']]}")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.man["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict:
        path = self.dir / "limits" / f"{workload}.json"
        return json.loads(path.read_text()) if path.exists() else {"numbers": {}}

    def _for(self, key: str, workload: str) -> List[Dict]:
        return [m for m in self.man[key] if workload in m.get("workloads", [workload])]

    def end_to_end_for(self, workload: str) -> List[Dict]:
        return self._for("end_to_end", workload)

    def per_layer_for(self, workload: str) -> List[Dict]:
        return self._for("per_layer", workload)

    def kind(self, name: str) -> ModuleType:
        return _load(self.dir / "kinds" / f"{name}.py", f"benchmark_kind_{name}")

    def reader(self, metric: str) -> Callable:
        mod = _load(self.dir / "metrics" / f"{metric}.py",
                    "benchmark_metric_" + re.sub(r"\W", "_", metric))
        return mod.read


def _load(path: Path, modname: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"the benchmark has no {path.name} under {path.parent}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(b: Bench) -> List[str]:
    """What in the manifest breaks the benchmark's rules of form (names,
    units, sources, which cell reports what); empty when none does."""
    m, out = b.man, []
    cells = {w["name"]: w for w in m["workloads"]}
    cfgs = {c["name"] for c in m["configs"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for group in (m["configs"], m["workloads"], m["end_to_end"] + m["per_layer"]):
        names = [x["name"] for x in group]
        out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
        out += [f"duplicate name {n!r}" for n in sorted(set(names)) if names.count(n) > 1]
    for x in m["end_to_end"] + m["per_layer"]:
        if not UNIT.match(x["unit"]):
            out.append(f"bad unit {x['unit']!r} of {x['name']}")
        if x["better"] not in ("lower", "higher"):
            out.append(f"bad 'better' of {x['name']}")
        if x["source"] not in SOURCES:
            out.append(f"bad source of {x['name']}")
        out += [f"{x['name']} names no cell {w!r}" for w in x.get("workloads", [])
                if w not in cells]
    for e in m["end_to_end"]:
        if e["source"] not in E2E_SOURCES:
            out.append(f"end-to-end {e['name']} from {e['source']}")
        if not 0 < e["bound"] <= 0.25:
            out.append(f"bound of {e['name']} out of (0, 0.25]")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for p in m["per_layer"]:
        if p["moves"] not in e2e:
            out.append(f"{p['name']} moves an unknown {p['moves']!r}")
            continue
        mover = e2e[p["moves"]]
        for w in p.get("workloads", list(cells)):
            if w not in mover.get("workloads", list(cells)):
                out.append(f"{p['name']} in {w}, which does not report {p['moves']}")
        if "\n" in p["layer"] or not 0 < len(p["layer"]) <= 200:
            out.append(f"bad layer of {p['name']}")
    for c in m["configs"]:
        if not PATH.match(c["file"]) or not c["file"].startswith(tuple(m["paths"])):
            out.append(f"config file {c['file']} outside paths")
        if not any(w["config"] == c["name"] for w in m["workloads"]):
            out.append(f"config {c['name']} has no cell")
        out += [f"bad reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    for w in m["workloads"]:
        if w["config"] not in cfgs:
            out.append(f"{w['name']} names no configuration {w['config']!r}")
        if pairs.count((w["config"], w["traffic"])) > 1:
            out.append(f"{w['name']} repeats a pair of configuration and traffic")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']} asks for {w['chips']} chips")
        if not NAME.match(w["traffic"]) or not 0 < len(w["why"]) <= 200:
            out.append(f"bad traffic or why of {w['name']}")
        reported = [e for e in m["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        if len(reported) < 2:
            out.append(f"{w['name']} reports no end-to-end metric besides setup_s")
        if not any(w["name"] in p.get("workloads", [w["name"]]) for p in m["per_layer"]):
            out.append(f"{w['name']} reports no per-layer metric")
    for p in m["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"bad path {p!r}")
    return out

