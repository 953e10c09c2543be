"""The plain reference agrees with the program's plain versions on the CPU
at small sizes, on every cell's pipeline: the witness beside the card's
runs. It shares no code with the program."""

from __future__ import annotations

import ast
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark_torch import harness, reference, spec, traffic
from benchmark_torch.frames import yuv_frames

from .conftest import HERE, REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
# cells whose files are here but whose entries wait for their measurement
# on the card: (config, traffic) of each, so their pipeline stays witnessed
LATER = {"uhd8k10_c33.split4": ("uhd8k_420p10_cube33", "stream_8k")}


def load(name: str) -> spec.Cell:
    if name not in LATER:
        return spec.load_cell(name, REPO)
    config, mix = LATER[name]
    return spec.Cell(
        name=name, chips=4, config_name=config, traffic_name=mix,
        config=json.loads((HERE / "configs" / f"{config}.json").read_text()),
        traffic=json.loads((HERE / "traffic" / f"{mix}.json").read_text()),
        workload=json.loads((HERE / "workloads" / f"{name}.json"
                             ).read_text()),
        end_to_end=[], per_layer=[])


def small(cell: spec.Cell, w: int = 96, h: int = 48) -> spec.Cell:
    text = cell.traffic.get("params", {}).get("resolution")
    tr = cell.traffic
    if text:
        tr = dict(tr, params=dict(tr["params"], resolution=f"{w // 2}x"
                                                           f"{h // 2}"))
    return dataclasses.replace(
        cell, config=dict(cell.config, probe=dict(cell.config["probe"],
                                                  width=w, height=h)),
        traffic=tr)


@pytest.mark.parametrize("name", CELLS + sorted(LATER))
def test_reference_matches_the_program_on_the_cpu(name):
    from lut_renderer_tpu_torch.ops.prepare import LutTable
    from lut_renderer_tpu_torch.ops.render import make_render_fn

    cell = small(load(name))
    cfg = harness.derive_config(cell)
    pipe, n = cell.config["pipeline"], cell.config["lut_size"]
    table = traffic.look_table(cell.traffic, n, 0)
    planes = yuv_frames(2 ** 31 + 99, 2, 48, 96, pipe["in_depth"],
                        pipe["in_subsampling"])
    got = make_render_fn(LutTable.from_arrays(table, (0, 0, 0), (1, 1, 1),
                                              "cpu"), cfg, "cpu")(
        *(torch.from_numpy(p) for p in planes))
    want = reference.render(*(torch.from_numpy(p) for p in planes),
                            torch.from_numpy(table), pipe,
                            harness.resize_of(cell))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.to(torch.int32), w.to(torch.int32))


def test_resize_weights_match_libswscale_layout():
    w = reference.bicubic_weights(64, 32)
    assert w.shape == (32, 64) and w.dtype == np.float32
    assert np.allclose(w.sum(axis=1), 1, atol=1e-6)
    up = reference.bicubic_weights(32, 64)
    assert np.allclose(up.sum(axis=1), 1, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "frames.py", "roofline.py", "traffic.py"):
        tree = ast.parse((HERE / name).read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert not m.startswith(("lut_renderer_tpu", "jax")), (name, m)
