"""A cell of ``BENCHMARK.json`` resolved by name to its files: the
configuration (``file``), the traffic mix (``perfbench/traffic/<traffic>
.json``), the limits of its output check (``perfbench/checks/<cell>.json``)
and the reader of each metric it reports (``perfbench/metrics/<metric>
.py``).  Adding a cell, a mix or a metric adds files and entries; nothing
here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

from . import traffic as traffic_lib

BENCH = Path(__file__).resolve().parent.parent     # perfbench/
ROOT = BENCH.parent


class Metric(NamedTuple):
    name: str
    unit: str
    read: object        # read(ctx) -> float | None


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: traffic_lib.Traffic
    limits: dict        # number -> limit (None: reported, not judged)
    end_to_end: list
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def load_reader(name: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries, cell: str, bench: Path) -> list[Metric]:
    return [Metric(e["name"], e["unit"], load_reader(e["name"], bench))
            for e in entries if cell in e.get("workloads", [cell])]


def resolve(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "perfbench"
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=traffic_lib.load(bench / "traffic" / f"{w['traffic']}.json"),
        limits=json.loads((bench / "checks" / f"{name}.json").read_text()
                          )["limits"],
        end_to_end=_metrics(spec["end_to_end"], name, bench),
        per_layer=_metrics(spec["per_layer"], name, bench))
