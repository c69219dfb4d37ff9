"""Find a cell and everything it names, from `BENCHMARK.json` and files.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's file is the one `BENCHMARK.json` gives; the traffic mix
is `workloads/<traffic>.json`; the limits of its output comparisons are
`limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. A later cell, configuration, mix or metric is
added by adding such files and entries, never by editing this code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _applies(entry: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    # a per-layer metric without a list goes with every cell that reports its end-to-end metric
    return entry.get("moves", entry["name"]) in e2e_names


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"])


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell called `name` of `root/BENCHMARK.json`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "workloads" / f"{w['traffic']}.json").read_text())
    limits_file = root / "benchmark" / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    e2e = [e for e in spec["end_to_end"] if "workloads" not in e or name in e["workloads"]]
    names = {e["name"] for e in e2e}
    per_layer = [p for p in spec["per_layer"] if _applies(p, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [_metric(e) for e in e2e], [_metric(p) for p in per_layer])


def reader(metric: str, root: Path = ROOT):
    """The `read(trace)` function of `metrics/<metric>.py`."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
