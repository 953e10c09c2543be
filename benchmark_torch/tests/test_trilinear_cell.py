"""The trilinear cell's yardstick (``trilinear.py``) and its two readers:
kernel B's trilinear operation count and bound beside the accepted counts,
which stay as they are; the symbol pick against kernel names copied from
a card's trace; ``kernel_b_roofline_pct.tri`` on a synthetic trace and
``render_call_ms.tri`` on synthetic spans; and a traced CPU run of a tiny
trilinear cell through the harness."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark_torch import harness, roofline, spec
from benchmark_torch.readers import is_kernel_b
from benchmark_torch.trace import Trace
from benchmark_torch.trilinear import FLOPS_PER_PX_TRILINEAR, \
    is_kernel_b_trilinear, kernel_b_trilinear_bound
from lut_renderer_tpu_torch import spans as program

from .conftest import HERE, REPO, _edit, run_tiny

CELL = "fhd8_c33.tri"
PIPE_8 = {"in_depth": 8, "out_depth": 8, "in_subsampling": "420",
          "out_subsampling": "420"}

# kernel names as CUPTI reported them on the card (an NVIDIA H100 80GB
# HBM3): kernel B's exact table at each interpolation, its coarse2 table,
# kernel A, and the plain layout's pixel kernels
TRILINEAR = ("void (anonymous namespace)::fused420_kernel<1, 1, "
             "lutk::LutArgs, 1, 2>(Fused420Params)")
TETRAHEDRAL = ("void (anonymous namespace)::fused420_kernel<1, 1, "
               "lutk::LutArgs, 2, 2>(Fused420Params)")
NEAREST = ("void (anonymous namespace)::fused420_kernel<1, 1, "
           "lutk::LutArgs, 0, 2>(Fused420Params)")
COARSE2 = ("void (anonymous namespace)::fused420_kernel<1, 1, "
           "lutk::Coarse2Args, 2, 2>(Fused420Params)")
KERNEL_A = ("void (anonymous namespace)::planar_kernel<Lut3dParams, 1, 1, "
            "4>(Lut3dParams)")
UNPACK = ("void (anonymous namespace)::pixel_unpack_kernel<1, 1, false>"
          "(PixelUnpackParams)")
PACK = ("void (anonymous namespace)::pixel_pack_kernel<1, 1>"
        "(PixelPackParams)")


def test_the_accepted_counts_stay_as_they_are():
    assert roofline.FLOPS_PER_PX == {"A": 60, "C": 160, "B": 103,
                                     "B coarse2": 203}
    ms, by = roofline.kernel_b_bound(2, 2160, 3840, PIPE_8, 33)
    assert (round(ms, 4), by) == (0.0255, "operations")


def test_the_trilinear_count_and_bound_at_1080p_x8():
    # the tetrahedral sum (25) out, seven lerps of three channels (63) and
    # three weights in
    assert FLOPS_PER_PX_TRILINEAR == 144
    ms, by = kernel_b_trilinear_bound(8, 1080, 1920, PIPE_8, 33)
    px = 8 * 1080 * 1920
    assert by == "operations"
    assert ms == pytest.approx(144 * px / 67e12 * 1e3)
    assert round(ms, 4) == 0.0357
    # the bytes are kernel B's own: planes in and out once, the LUT once
    nbytes = 2 * px * 3 // 2 + 33 ** 3 * 12
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.01498, abs=1e-5)
    tet, _ = roofline.kernel_b_bound(8, 1080, 1920, PIPE_8, 33)
    assert ms / tet == pytest.approx(144 / 103)


@pytest.mark.parametrize("name,trilinear", [
    (TRILINEAR, True), (TETRAHEDRAL, False), (NEAREST, False),
    (COARSE2, False), (KERNEL_A, False), (UNPACK, False), (PACK, False),
    ("Memcpy HtoD (Pinned -> Device)", False)])
def test_the_pick_takes_the_trilinear_instantiation_alone(name, trilinear):
    assert is_kernel_b_trilinear(name) is trilinear
    # every trilinear launch is one that kernel_b_roofline_pct counts too
    if trilinear:
        assert is_kernel_b(name)


def _run(device=()):
    c = spec.load_cell(CELL, REPO)
    h, w = c.config["probe"]["height"], c.config["probe"]["width"]
    run = harness.Run(c, 1.0, 1.0, 8, [0], (h, w), c.config["lut_size"],
                      t0=100.0, t_close=101.0)
    run.trace = Trace(0.0, 1e6, 1, device=list(device))
    return run


def read(name, run):
    return spec.metric_reader(name)(run)


def test_the_roofline_reader_reads_trilinear_launches_alone():
    bound_ms, _ = kernel_b_trilinear_bound(8, 1080, 1920, PIPE_8, 33)
    run = _run([(0, 0.0, 100.0, TRILINEAR), (0, 200.0, 280.0, TRILINEAR),
                (0, 300.0, 900.0, TETRAHEDRAL),
                (0, 900.0, 1400.0, "Memcpy HtoD (Pinned -> Device)")])
    assert read("kernel_b_roofline_pct.tri", run) == pytest.approx(
        100 * 2 * bound_ms / 0.18)
    # a run with no trilinear launch, or no trace, reads nothing
    assert read("kernel_b_roofline_pct.tri",
                _run([(0, 0.0, 100.0, TETRAHEDRAL)])) is None
    run.trace = None
    assert read("kernel_b_roofline_pct.tri", run) is None


def _rec(name, t0, t1, id, **attrs):
    return program.Record(name, int(t0 * 1e9), int(t1 * 1e9), id, None, id,
                          7, attrs)


def test_the_span_reader_takes_the_fused_trilinear_calls(monkeypatch):
    recs = [
        _rec("executor.render", 100.1, 100.104, 1, batch=0, layout="fused",
             interp="trilinear"),
        _rec("executor.render", 100.2, 100.202, 2, batch=1, layout="fused",
             interp="trilinear"),
        # another route, a call with no account, a call before the window
        _rec("executor.render", 100.3, 100.35, 3, batch=2, layout="plain",
             interp="trilinear"),
        _rec("executor.render", 100.4, 100.45, 4, batch=3, layout="fused",
             interp="tetrahedral"),
        _rec("executor.render", 100.5, 100.55, 5, batch=4),
        _rec("executor.render", 99.5, 99.6, 6, batch=0, layout="fused",
             interp="trilinear"),
    ]
    monkeypatch.setattr(program, "_records", recs)
    run = _run()
    assert read("render_call_ms.tri", run) == pytest.approx(3.0)
    # the accepted reader still means every call
    assert read("render_call_ms", run) == pytest.approx(
        (4 + 2 + 50 + 50 + 50) / 5)
    # a program whose spans carry no attributes reads None
    monkeypatch.setattr(program, "_records", [
        _rec("executor.render", 100.1, 100.2, 1, batch=0)])
    assert read("render_call_ms.tri", run) is None
    monkeypatch.setattr(program, "_records", [])
    assert read("render_call_ms.tri", run) is None


@pytest.fixture(scope="module")
def tiny_tri(tmp_path_factory):
    """(root, here) with a tiny trilinear cell ``t.tri`` beside the real
    ones: the cell's configuration at 64x32 and a short queue."""
    base = tmp_path_factory.mktemp("bench_tri")
    here = base / "benchmark_torch"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "looks", "cache", "out", "tests", "__pycache__"))
    files = {
        "configs/tinytri.json": _edit(
            here / "configs/fhd_420p8_cube33_trilinear.json", name="tinytri",
            probe={"width": 64, "height": 32}),
        "traffic/tiny_tri.json": _edit(
            here / "traffic/queue_1080p_24_240_looks4.json",
            clip_frames=[4, 40], pool_frames=40),
        "workloads/t.tri.json": _edit(here / f"workloads/{CELL}.json",
                                      check_batches=6),
    }
    for rel, data in files.items():
        (here / rel).write_text(json.dumps(data))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "t.tri", "config": "tinytri",
                               "traffic": "tiny_tri", "chips": 1,
                               "why": "tiny"})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("t.tri")
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base, here


def test_a_traced_cpu_run_of_a_tiny_trilinear_cell(tiny_tri):
    out = run_tiny(tiny_tri, "t.tri", traced=True)
    assert out["correct"] and out["failed"] == 0
    assert out["compared"]["max_code_diff"]["value"] == 0
    # the CPU runs no kernel and has no device trace: the span reader
    # alone finds its calls
    assert out["launches"] == {"B": 0, "B coarse2": 0, "A": 0, "C": 0}
    assert set(out["metrics"]) == {"render_call_ms.tri"}
    assert out["metrics"]["render_call_ms.tri"]["value"] > 0
