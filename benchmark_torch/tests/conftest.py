"""Tiny cells for CPU runs of the harness: a copy of the benchmark's files
in a temporary directory, with small configurations and mixes beside the
real ones and a BENCHMARK.json that declares them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
TINY = ("t.native", "t.resize", "t.dither", "t.split")


def _edit(path: Path, **changes) -> dict:
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key] = {**data.get(key, {}), **value}
        else:
            data[key] = value
    return data


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, here): a checkout root with BENCHMARK.json and a copy of the
    benchmark's directory holding four tiny cells beside the real ones."""
    base = tmp_path_factory.mktemp("bench")
    here = base / "benchmark_torch"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "looks", "cache", "out", "tests", "__pycache__"))
    small = dict(probe={"width": 64, "height": 32})
    files = {
        "configs/tiny8.json": _edit(here / "configs/uhd_420p8_cube33.json",
                                    name="tiny8", **small),
        "configs/tiny10.json": _edit(
            here / "configs/fhd_420p10_cube65_dither8.json", name="tiny10",
            lut_size=17, **small),
        "traffic/tiny_q.json": _edit(
            here / "traffic/queue_4k_24_240_looks4.json",
            clip_frames=[4, 40], pool_frames=40),
        "traffic/tiny_resize.json": _edit(
            here / "traffic/queue_4k_to1080_24_120_looks4.json",
            clip_frames=[4, 40], pool_frames=40,
            params={"resolution": "32x16"}),
        "traffic/tiny_z.json": _edit(
            here / "traffic/queue_1080p_24_480_zipf8.json",
            clip_frames=[4, 60], pool_frames=40),
        "traffic/tiny_stream.json": _edit(here / "traffic/stream_8k.json",
                                          pool_frames=40),
    }
    for name in TINY:
        files[f"workloads/{name}.json"] = _edit(
            here / "workloads/uhd8_c33.native.json", check_batches=6)
    for rel, data in files.items():
        (here / rel).write_text(json.dumps(data))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": "t.native", "config": "tiny8", "traffic": "tiny_q",
         "chips": 1, "why": "tiny"},
        {"name": "t.resize", "config": "tiny8", "traffic": "tiny_resize",
         "chips": 1, "why": "tiny"},
        {"name": "t.dither", "config": "tiny10", "traffic": "tiny_z",
         "chips": 1, "why": "tiny"},
        {"name": "t.split", "config": "tiny8", "traffic": "tiny_stream",
         "chips": 2, "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            # a stream has no job starts
            m["workloads"] += [n for n in TINY if n != "t.split" or
                               "job_start_p90_ms" not in (m["name"],
                                                          m.get("moves"))]
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base, here


def run_tiny(tiny, name: str, seed: int = 2 ** 31 + 77, hook=None,
             seconds: float = 0.6, traced: bool = False) -> dict:
    """One CPU run of a tiny cell (a split cell over two CPU devices)."""
    import time

    import torch

    from benchmark_torch import harness

    root, here = tiny
    devices = [torch.device("cpu")] * (2 if name == "t.split" else 1)
    return harness.run_cell(name, seed, seconds, traced, time.perf_counter(),
                            root, devices=devices, device_arg="cpu",
                            hook=hook, here=here)
