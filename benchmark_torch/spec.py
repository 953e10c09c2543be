"""A cell as the files describe it, found by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration, traffic and chips, and which metrics each cell reports.
Everything else sits in a file of its own under this directory:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the cell's correctness limits and sample) and
``metrics/<metric>.py`` (one reader a metric). A cell, a mix or a metric is
added by adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _cell_metrics(entries: list, cell: str, per_layer: bool
                  ) -> List[Metric]:
    """The entries that `cell` reports: those that list it, and the
    end-to-end ones without a list. A per-layer metric has to list its
    cells."""
    out = []
    for m in entries:
        if "workloads" not in m and per_layer:
            raise ValueError(f"per-layer metric {m['name']!r} lists no "
                             f"workloads")
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(Metric(m["name"], m["unit"]))
    return out


def load_cell(name: str, root: Path, here: Path = HERE) -> Cell:
    """The cell `name` of ``root/BENCHMARK.json``, with its files from
    `here`. Raises KeyError for a cell the benchmark does not declare."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    e2e = _cell_metrics(bench["end_to_end"], name, False)
    layer = _cell_metrics(bench["per_layer"], name, True)

    def read(kind: str, key: str) -> dict:
        return json.loads((here / kind / f"{key}.json").read_text())

    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], traffic_name=entry["traffic"],
                config=read("configs", entry["config"]),
                traffic=read("traffic", entry["traffic"]),
                workload=read("workloads", name),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing to read."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_torch_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Metric], run, here: Path = HERE
                 ) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics that found something."""
    out = {}
    for m in metrics:
        value = metric_reader(m.name, here)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
