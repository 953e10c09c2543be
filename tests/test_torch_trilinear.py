"""The 1080p 8-bit trilinear delivery (``BASELINE.json`` ``configs[0]``,
the benchmark's ``fhd8_c33.tri`` cell) on the CPU: the policy's pipeline
for the cell, kernel B's plain twin against the benchmark's plain
reference (``benchmark_torch/reference.py``, plain torch, no JAX) bit for
bit at a small size, the reference's trilinear branch against
``colorcore.interp``, the ``layout`` and ``interp`` attributes of every
``executor.render`` span, and kernel B's launch counter by interpolation.
One test (marker ``cuda``) runs the cell's render function on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_trilinear.py
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark_torch import harness, reference, spec, traffic
from benchmark_torch.frames import yuv_frames
from lut_renderer_tpu_torch import spans
from lut_renderer_tpu_torch.engine import executor
from lut_renderer_tpu_torch.colorcore.interp import apply_lut_trilinear
from lut_renderer_tpu_torch.engine.executor import (StageStats,
                                                    _pick_batch_size,
                                                    render_batches)
from lut_renderer_tpu_torch.ops import fused420
from lut_renderer_tpu_torch.ops.prepare import LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.parallel import make_sharded_render_fn
from lut_renderer_tpu_torch.probes.harness import tie_frames

from torch_parity import (  # noqa: F401
    assert_integer_contract,
    cuda_device,
    planes,
    random_lut,
    rgb_planes,
    to_torch,
)

REPO = Path(__file__).resolve().parent.parent
CELL = "fhd8_c33.tri"


def _cell(w: int = 1920, h: int = 1080) -> spec.Cell:
    cell = spec.load_cell(CELL, REPO)
    return dataclasses.replace(cell, config=dict(
        cell.config, probe=dict(cell.config["probe"], width=w, height=h)))


def _lut(cell: spec.Cell, look: int, device="cpu"):
    """(the look's (N, N, N, 3) table, its LutTable on `device`)."""
    table = traffic.look_table(cell.traffic, cell.config["lut_size"], look)
    return table, LutTable.from_arrays(table, (0, 0, 0), (1, 1, 1), device)


def test_the_policy_derives_the_stated_pipeline():
    cell = _cell()
    cfg = harness.derive_config(cell)
    assert cell.config["params"] == {"lut_interp": "trilinear",
                                     "video_codec": "libx264"}
    assert (cfg.interp, cfg.dither, cfg.in_depth, cfg.out_depth,
            cfg.in_subsampling, cfg.out_subsampling, cfg.resize,
            cfg.phase_layout) == ("trilinear", "none", 8, 8, "420", "420",
                                  None, "auto")
    assert _pick_batch_size(1920, 1080) == 8
    # the cell's batch takes kernel B: the shapes alone decide it
    y = torch.empty((8, 1080, 1920), dtype=torch.uint8, device="meta")
    u = torch.empty((8, 540, 960), dtype=torch.uint8, device="meta")
    assert fused420.fused420_applicable(y, u, cfg, object())
    # nothing of the source is cut, on one card
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == cell.config_name]
    assert entry["reduced"] == [] and cell.chips == 1
    assert (cell.config["probe"]["pix_fmt"], cell.config["lut_size"]) == (
        "yuv420p", 33)


def _frames(kind: str, pipe: dict):
    if kind == "ties":
        return tie_frames(29, 2, 48, 96)
    seed = {"seed_a": 2 ** 31 + 17, "seed_b": 2 ** 33 + 5}[kind]
    return yuv_frames(seed, 2, 48, 96, pipe["in_depth"],
                      pipe["in_subsampling"])


@pytest.mark.parametrize("kind", ["seed_a", "seed_b", "ties"])
@pytest.mark.parametrize("look", [0, 3])
def test_the_program_equals_the_reference_bit_for_bit(kind, look):
    cell = _cell(96, 48)
    cfg = harness.derive_config(cell)
    pipe = cell.config["pipeline"]
    table, lut = _lut(cell, look)
    y, u, v = to_torch(*_frames(kind, pipe))
    fn = make_render_fn(lut, cfg, "cpu")
    got = fn(y, u, v)
    assert (fn.layout, fn.interp) == ("fused", "trilinear")
    want = reference.render(y, u, v, torch.from_numpy(table), pipe, None)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.uint8
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("seed", [5, 6])
def test_the_reference_trilinear_branch_agrees_with_colorcore(seed):
    table = random_lut(33, seed=seed).table
    rgb = rgb_planes(seed, (24, 64))
    r, g, b = to_torch(*rgb)
    got = reference._lut(r, g, b, torch.from_numpy(table), "trilinear")
    want = apply_lut_trilinear(np.moveaxis(rgb, 0, -1), table)
    np.testing.assert_allclose(np.stack([t.numpy() for t in got], -1), want,
                               rtol=0, atol=1e-5)


def _profiled(fn):
    """fn() under a CPU profile, after a span that finds none, so the
    profile's first span begins a new recording."""
    with spans.span("between"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


ROUTES = {
    "trilinear": (RenderConfig(interp="trilinear"), True, "fused",
                  "trilinear"),
    "tetrahedral": (RenderConfig(), True, "fused", "tetrahedral"),
    "resize": (RenderConfig(interp="trilinear", resize=(16, 8)), True,
               "plain", "trilinear"),
    "no_lut": (RenderConfig(apply_lut=False), False, "plain", None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_render_span_names_its_layout_and_interp(route):
    cfg, with_lut, layout, interp = ROUTES[route]
    lut = random_lut(9, seed=4) if with_lut else None
    fn = make_render_fn(lut, cfg, "cpu")
    batches = [(*planes(s, 2, 16, 32, 8), 2) for s in range(3)]
    outs = _profiled(lambda: list(render_batches(
        iter(batches), fn, torch.device("cpu"))))
    assert len(outs) == 3
    recs = [r for r in spans.records() if r.name == "executor.render"]
    assert len(recs) == 3
    for r in recs:
        assert (r.attrs["layout"], r.attrs["interp"]) == (layout, interp)
    assert (fn.layout, fn.interp) == (layout, interp)


def test_the_split_names_its_chunks_layout_and_interp():
    fn = make_sharded_render_fn(random_lut(9, seed=4),
                                RenderConfig(interp="trilinear"),
                                ["cpu"] * 2)
    assert (fn.layout, fn.interp) == (None, "trilinear")
    batches = [(*planes(s, 4, 16, 32, 8), 4) for s in range(2)]
    _profiled(lambda: list(render_batches(iter(batches), fn,
                                          torch.device("cpu"))))
    recs = [r for r in spans.records() if r.name == "executor.render"]
    assert [(r.attrs["layout"], r.attrs["interp"]) for r in recs] == [
        ("fused", "trilinear")] * 2


def test_a_render_function_without_an_account_leaves_the_span_bare():
    batches = [(*planes(s, 2, 16, 32, 8), 2) for s in range(2)]
    fn = make_render_fn(None, RenderConfig(apply_lut=False), "cpu")
    _profiled(lambda: list(render_batches(
        iter(batches), lambda y, u, v: fn(y, u, v), torch.device("cpu"))))
    recs = [r for r in spans.records() if r.name == "executor.render"]
    assert len(recs) == 2
    assert all("layout" not in r.attrs and "interp" not in r.attrs
               for r in recs)


def test_no_attributes_are_set_without_a_profiler(monkeypatch):
    fn = make_render_fn(random_lut(9, seed=4),
                        RenderConfig(interp="trilinear"), "cpu")
    seen = []

    class Watch(spans.span):
        __slots__ = ()

        def __exit__(self, *exc):
            if self.name == "executor.render":
                seen.append(dict(self.attrs))
            return super().__exit__(*exc)

    monkeypatch.setattr(executor, "span", Watch)
    list(render_batches(iter([(*planes(1, 2, 16, 32, 8), 2)]), fn,
                        torch.device("cpu")))
    assert seen == [{"batch": 0}]
    assert fn.layout == "fused"


def test_launches_by_interp_stays_empty_on_the_cpu():
    before = dict(fused420.launches_by_interp)
    launches = fused420.launches
    for interp in ("trilinear", "tetrahedral", "nearest"):
        fn = make_render_fn(random_lut(9, seed=4),
                            RenderConfig(interp=interp), "cpu")
        fn(*to_torch(*planes(2, 2, 16, 32, 8)))
        assert fn.layout == "fused"
    assert fused420.launches_by_interp == before == {}
    assert fused420.launches == launches


def test_the_stage_stats_line_shows_launches_by_interp():
    stats = StageStats(frames_out=16, wall_s=1.0, batches=2)
    assert "kernel B" not in stats.summary()
    stats.launches_by_interp = {"trilinear": 2, "nearest": 0}
    assert stats.summary().endswith(
        "; kernel B launches by interp: trilinear 2")


def test_the_server_status_shows_launches_by_interp(tmp_path, monkeypatch):
    from lut_renderer_tpu_torch.app.server import QueueServer

    server = QueueServer(tmp_path / "s.sock", device="cpu")
    monkeypatch.setattr(fused420, "launches_by_interp", {})
    assert "launches_by_interp" not in server.handle_request(
        {"op": "status"})
    monkeypatch.setattr(fused420, "launches_by_interp",
                        {"trilinear": 12, "tetrahedral": 0})
    resp = server.handle_request({"op": "status"})
    assert resp["ok"] and resp["launches_by_interp"] == {"trilinear": 12}


@pytest.mark.cuda
def test_the_cells_render_function_on_the_card(cuda_device):
    """A 1080p x 8 batch of the cell on the card: one kernel B launch a
    batch, counted under "trilinear", within the integer contract of the
    plain reference (computed on the card, TF32 off as in the harness)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = _cell()
    cfg = harness.derive_config(cell)
    pipe = cell.config["pipeline"]
    table, lut = _lut(cell, 1, cuda_device)
    fn = make_render_fn(lut, cfg, cuda_device)
    frames = [yuv_frames(2 ** 31 + 41 + i, 8, 1080, 1920, 8, "420")
              for i in range(2)]
    before = dict(fused420.launches_by_interp)
    launches = fused420.launches
    outs = list(render_batches(iter([(*f, 8) for f in frames]), fn,
                               cuda_device))
    torch.cuda.synchronize()
    assert fused420.launches == launches + 2
    assert fused420.launches_by_interp.get("trilinear", 0) == \
        before.get("trilinear", 0) + 2
    assert {k: n - before.get(k, 0) for k, n in
            fused420.launches_by_interp.items()} == {
        **{k: 0 for k in before}, "trilinear": 2}
    assert (fn.layout, fn.interp) == ("fused", "trilinear")
    tab = torch.from_numpy(table).to(cuda_device)
    for f, out in zip(frames, outs):
        for i in range(8):
            want = reference.render(
                *(torch.from_numpy(p[i:i + 1]).to(cuda_device) for p in f),
                tab, pipe, None)
            assert_integer_contract([o[i:i + 1] for o in out[:3]],
                                    [w.cpu().numpy() for w in want],
                                    f"frame {i}")
