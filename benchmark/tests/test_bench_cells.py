"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: the harness finds them by name."""

from __future__ import annotations

import json

import pytest

from benchmark import cells
from benchmark.tests.conftest import tiny_root


def test_every_cell_of_the_benchmark_loads():
    spec = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = cells.load(w["name"])
        assert cell.chips == 1
        assert "setup_s" in {m.name for m in cell.end_to_end}
        assert cell.per_layer, "every cell reports a per-layer metric"
        for m in cell.per_layer:
            assert callable(cells.reader(m.name))
        assert cell.limits, f"{w['name']} has no limits file"


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/single_4k.json").read_text())
    cfg.update(name="single_1k", images=[{"height": 32, "width": 48, "count": 1}])
    (root / "benchmark/configs/single_1k.json").write_text(json.dumps(cfg))
    (root / "benchmark/workloads/cli.json").write_text(json.dumps(
        {"colors": 4, "init": "kmeans", "imax": 2, "polish": 1, "error_image": True}))
    (root / "benchmark/limits/single_1k.cli.json").write_text(json.dumps({"fitness_rel": {"limit": 1.0}}))
    (root / "benchmark/metrics/new_metric.py").write_text("def read(data):\n    return 42.0\n")
    spec["configs"].append({"name": "single_1k", "source": "x", "file": "benchmark/configs/single_1k.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "single_1k.cli", "config": "single_1k", "traffic": "cli", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("single_1k.cli")
    spec["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "program_span",
                              "layer": "engine", "moves": "image_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cells.load("single_1k.cli", root)
    assert cell.config["images"][0]["width"] == 48
    assert cell.traffic["colors"] == 4
    assert cell.limits == {"fitness_rel": {"limit": 1.0}}
    assert [m.name for m in cell.end_to_end] == ["image_s", "setup_s"]
    # without a `workloads` list a metric goes with every cell that reports what it moves
    assert [m.name for m in cell.per_layer] == ["new_metric"]
    assert "new_metric" in {m.name for m in cells.load("single_4k.quality", root).per_layer}
    assert "new_metric" not in {m.name for m in cells.load("batch_mixed.quality64", root).per_layer}
    assert cells.reader("new_metric", root)(None) == 42.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")
