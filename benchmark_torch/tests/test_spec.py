"""Cells, mixes, configurations and metrics are found by name: one added
as files and entries in a copy of the benchmark needs no edit of the
harness."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark_torch import spec

from .conftest import HERE, REPO


def test_every_declared_cell_and_metric_has_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], REPO)
        assert cell.config["name"] == w["config"]
        assert cell.chips == w["chips"]
        names = {m.name for m in cell.end_to_end}
        assert {"fps", "setup_s"} <= names
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m.name))
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()


def test_each_listed_cell_reports_what_its_metrics_move():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_a_per_layer_metric_without_its_cells_is_refused(tmp_path):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="lists no workloads"):
        spec.load_cell(bench["workloads"][0]["name"], tmp_path)


def test_files_added_to_a_copy_are_found_with_no_edit(tmp_path):
    here = tmp_path / "benchmark_torch"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "looks", "cache", "out", "tests", "__pycache__"))
    config = json.loads((here / "configs/uhd_420p8_cube33.json").read_text())
    config.update(name="new_config", lut_size=17)
    (here / "configs/new_config.json").write_text(json.dumps(config))
    mix = json.loads((here / "traffic/stream_8k.json").read_text())
    (here / "traffic/new_mix.json").write_text(json.dumps(mix))
    (here / "workloads/new.cell.json").write_text(json.dumps(
        {"check_batches": 2, "limits": {"max_code_diff": 0,
                                         "diff_share": 0.0}}))
    (here / "metrics/new_metric.py").write_text(
        "def read(run):\n    return run.batch * 2\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_config", "source": "x",
                             "file": "benchmark_torch/configs/new_config.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "new_config",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "fps",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("new.cell", tmp_path, here)
    assert cell.config["lut_size"] == 17 and cell.traffic["kind"] == "stream"
    assert [m.name for m in cell.per_layer] == ["new_metric"]
    # an end-to-end metric without a cell list goes to every cell
    assert {m.name for m in cell.end_to_end} == {"fps", "setup_s"}

    class FakeRun:
        batch = 21
    assert spec.read_metrics(cell.per_layer, FakeRun(), here) == {
        "new_metric": {"value": 42.0, "unit": "1"}}
