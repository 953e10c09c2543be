"""The per-layer readers on a synthetic trace: each reads its own events,
and one that finds nothing returns None (never 0 for a share)."""

from __future__ import annotations

import pytest

from benchmark_torch import harness, roofline, spec
from benchmark_torch.trace import Trace

from .conftest import REPO

# kernel names as CUPTI reported them on the card
KB = ("void (anonymous namespace)::fused420_kernel<1, 1, lutk::LutArgs, 2, "
      "2>(Fused420Params)")
KA = ("void (anonymous namespace)::planar_kernel<Lut3dParams, 2, 2, 4>"
      "(Lut3dParams)")
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_cublas"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>>")


def fake_run(name: str, device, host=()):
    cell = spec.load_cell(name, REPO)
    h, w = cell.config["probe"]["height"], cell.config["probe"]["width"]
    run = harness.Run(cell, 1.0, 1.0, 2, [0], (h, w), cell.config["lut_size"],
                      t0=0.0, t_close=1.0)
    job = harness.JobRec(0, 0.0)
    run.batches = [harness.BatchRec(job, 2, [0, 1], 0.1 * i, 0.1 * i + 0.05,
                                    0.1 * i + 0.06) for i in range(4)]
    run.trace = Trace(0.0, 1e6, 1, device=list(device), host=list(host))
    return run


def read(name, run):
    return spec.metric_reader(name)(run)


def test_kernel_b_share_and_copies():
    bound_ms, _ = roofline.kernel_b_bound(
        2, 2160, 3840, spec.load_cell("uhd8_c33.native", REPO)
        .config["pipeline"], 33)
    run = fake_run("uhd8_c33.native", [
        (0, 0.0, 100.0, KB), (0, 200.0, 300.0, KB),
        (0, 300.0, 800.0, "Memcpy HtoD (Pinned -> Device)"),
        (0, 800.0, 1200.0, "Memcpy DtoH (Device -> Pinned)")],
        host=[(0.0, 2000.0, "aten::pin_memory", 1),
              (0.0, 1900.0, "aten::_pin_memory", 1)])
    assert read("kernel_b_roofline_pct", run) == pytest.approx(
        100 * 2 * bound_ms / 0.2)
    assert read("copy_ms", run) == pytest.approx(0.9 / 4)
    assert read("pin_stage_ms", run) == pytest.approx(2.0 / 4)
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - 1100 / 1e6))
    for none in ("kernel_a_roofline_pct", "resample_roofline_pct",
                 "pixel_ops_ms", "peer_copy_ms"):
        assert read(none, run) is None


def test_resize_layers():
    run = fake_run("uhd8_c33.to1080", [
        (0, 0.0, 400.0, KA), (0, 400.0, 5000.0, GEMM),
        (0, 5000.0, 6000.0, ADD)])
    assert read("pixel_ops_ms", run) == pytest.approx(1.0 / 4)
    a_ms, _ = roofline.kernel_a_bound(2, 2160, 3840, 33)
    assert read("kernel_a_roofline_pct", run) == pytest.approx(
        100 * a_ms / 0.4)
    share = read("resample_roofline_pct", run)
    assert 0 < share < 100
    assert read("kernel_b_roofline_pct", run) is None


def test_host_clock_readers():
    run = fake_run("uhd8_c33.native", [])
    run.jobs = [harness.JobRec(0, 0.0, load_s=0.002, fn_s=0.001, first=0.01)]
    assert read("lut_load_ms", run) == pytest.approx(2.0)
    assert read("render_fn_ms", run) == pytest.approx(1.0)
    assert read("job_start_p90_ms", run) == pytest.approx(10.0)
    assert read("batch_p95_ms", run) == pytest.approx(50.0)
    assert read("fps", run) == pytest.approx(8.0)
    # the per-layer copies of a cell that bounds fps alone read the same
    for name in ("lut_load_ms", "render_fn_ms", "job_start_p90_ms"):
        assert read(f"{name}.fps", run) == read(name, run)
    run.trace = None
    assert read("lut_load_ms", run) is None
    assert read("lut_load_ms.fps", run) is None
    assert read("device_idle_pct", run) is None
