"""Pro mastering (``--mode pro``, BASELINE.json config 3) on the port, on
device="cpu": the two-stage run and the master's clean-up, mirroring
tests/test_tasks.py's pro cases and tests/test_app.py's, the CLI's
``render --mode pro``, and each stage's pixels against the JAX package
on the same frames under the integer contract (max |d| <= 1 code value
on fewer than 1e-3 of pixels). Each stage's RenderConfig is derived as the
runner derives it (plan.build_pipeline -> plan.build_render_spec ->
engine.config), here through probes/baseline.py, whose synthetic probe of
the master chip_smoke.py's phase 9 uses; the test holds that derivation
to the one from a probe of the real master. Encoded files are not compared
pixel for pixel: they pass through lossy encoders."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from lut_renderer_tpu.engine import config as jconfig
from lut_renderer_tpu.ops import render as jrender
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.app import cli, load_settings
from lut_renderer_tpu_torch.app.taskfactory import create_tasks
from lut_renderer_tpu_torch.colorcore import (
    Lut3D,
    parse_cube_file,
    write_cube_file,
)
from lut_renderer_tpu_torch.engine import run_stage
from lut_renderer_tpu_torch.hostio import probe_video
from lut_renderer_tpu_torch.hostio.decode import VideoDecoder
from lut_renderer_tpu_torch.models import (
    ProcessingParams,
    Task,
    TaskStatus,
    VideoInfo,
)
from lut_renderer_tpu_torch.ops.render import make_render_fn
from lut_renderer_tpu_torch.probes.baseline import task_stages
from lut_renderer_tpu_torch.tasks import TaskRunner, load_lut_table
from lut_renderer_tpu_torch.tasks import runner as runner_mod
from lut_renderer_tpu_torch.utils.fixtures import (
    make_10bit_prores_clip,
    make_gradient_clip,
)

from torch_parity import assert_integer_contract, random_lut, to_torch


@pytest.fixture(autouse=True)
def isolated_config(tmp_path, monkeypatch):
    monkeypatch.setenv("LUT_TPU_CONFIG_DIR", str(tmp_path / "config"))
    monkeypatch.setenv("LUT_TPU_THUMB_DIR", str(tmp_path / "thumbs"))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("pro")
    return make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=8)


@pytest.fixture(scope="module")
def lut(tmp_path_factory):
    return write_cube_file(tmp_path_factory.mktemp("prolut") / "l.cube",
                           Lut3D.identity(5))


def _task(clip, lut, out, intermediate=None, params=None):
    return Task(
        task_id=f"t-{out.stem}",
        source_path=Path(clip),
        output_path=out,
        lut_path=Path(lut) if lut else None,
        cover_path=None,
        params=params or ProcessingParams(video_codec="mpeg4", bitrate="1M",
                                          processing_mode="pro"),
        source_info=probe_video(clip),
        intermediate_path=intermediate,
    )


def _run(task, events=None):
    runner = TaskRunner(task, device="cpu")
    statuses = []
    runner.finished.connect(lambda tid, s: statuses.append(s))
    if events is not None:
        runner.log.connect(lambda tid, m: events.append(("log", m)))
        runner.progress.connect(lambda tid, p: events.append(("progress", p)))
    runner.run()
    return statuses


# ---- the two-stage run (tests/test_tasks.py) -------------------------------

def test_runner_pro_mode_two_stages(clip, lut, tmp_path):
    master_dir = tmp_path / "masters"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    task = _task(clip, lut, tmp_path / "pro_out.mp4", intermediate)
    events = []
    assert _run(task, events) == [TaskStatus.COMPLETED.value]
    assert task.output_path.exists()
    assert not intermediate.exists()  # cleaned up on success
    logs = [m for kind, m in events if kind == "log"]
    assert any("stage 1/2" in m for m in logs)
    assert any("stage 2/2" in m for m in logs)
    assert any("Master fixed to ProRes" in m for m in logs)
    assert sum("stage 1 stats: 8 frames" in m for m in logs) == 1
    assert sum("stage 2 stats: 8 frames" in m for m in logs) == 1
    # stage 1's progress stays below 50; the run ends at 100
    stage2 = next(i for i, (kind, m) in enumerate(events)
                  if kind == "log" and "stage 2/2" in m)
    first = [p for kind, p in events[:stage2] if kind == "progress"]
    assert first and max(first) <= 49
    assert [p for kind, p in events if kind == "progress"][-1] == 100


def test_runner_pro_mode_missing_intermediate(clip, lut, tmp_path):
    task = _task(clip, lut, tmp_path / "x_out.mp4", intermediate=None)
    assert _run(task) == [TaskStatus.FAILED.value]


def test_runner_failure_cleans_master(clip, lut, tmp_path):
    """A stage-2 failure (an encoder the bundled libraries lack) removes
    the stage-1 master."""
    master_dir = tmp_path / "m2"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    task = _task(clip, lut, tmp_path / "fail_out.mp4", intermediate,
                 ProcessingParams(processing_mode="pro",
                                  video_codec="libx264"))
    events = []
    assert _run(task, events) == [TaskStatus.FAILED.value]
    assert any("stage 2/2" in m for kind, m in events if kind == "log")
    assert not intermediate.exists()


def test_runner_exception_cleans_master(clip, lut, tmp_path, monkeypatch):
    """An exception outside run_stage (stage 2's spec) still removes the
    stage-1 master."""
    master_dir = tmp_path / "m3"
    master_dir.mkdir()
    intermediate = master_dir / "c_master.mov"
    task = _task(clip, lut, tmp_path / "exc_out.mp4", intermediate)
    real_build = runner_mod.build_render_spec
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # stage 2's spec
            raise RuntimeError("synthetic stage-2 failure")
        return real_build(*a, **kw)

    monkeypatch.setattr(runner_mod, "build_render_spec", boom)
    assert _run(task) == [TaskStatus.FAILED.value]
    assert calls["n"] == 2
    assert not intermediate.exists()


# ---- tasks and the CLI (tests/test_app.py) -------------------------------

def _fake_probe(path):
    return VideoInfo(width=320, height=240, fps=25.0, duration=2.0,
                     bitrate="500k", pix_fmt="yuv420p", bit_depth=8)


def test_create_tasks_pro_requires_master_dir(tmp_path):
    src = tmp_path / "v.mp4"
    src.touch()
    with pytest.raises(ValueError):
        create_tasks([src], ProcessingParams(processing_mode="pro"),
                     probe_fn=_fake_probe)


def test_create_tasks_pro(tmp_path):
    src = tmp_path / "v.mp4"
    src.touch()
    master = tmp_path / "masters"
    master.mkdir()
    batch = create_tasks(
        [src], ProcessingParams(processing_mode="pro", video_codec="mpeg4"),
        master_dir=master, probe_fn=_fake_probe)
    assert batch.tasks[0].intermediate_path.name == "v_master.mov"
    assert any("estimated ProRes master" in m for m in batch.logs)


def test_cli_render_pro_dry_run(clip, lut, tmp_path, capsys):
    rc = cli.main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--master-dir", str(tmp_path), "--dry-run",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stage 1: ProRes master" in out
    assert "stage 2: Distribution encode" in out
    assert "LUT output tags" in out
    assert not list(tmp_path.glob("output/*"))  # nothing executed


def test_cli_remembers_master_dir(clip, lut, tmp_path, capsys):
    """--master-dir persists as the `intermediate_dir` setting; a later
    pro run without the flag uses it."""
    master = tmp_path / "masters"
    master.mkdir()
    rc = cli.main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--master-dir", str(master), "--dry-run",
                   "--device", "cpu"])
    assert rc == 0
    assert load_settings().get("intermediate_dir") == str(master)
    capsys.readouterr()
    rc = cli.main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--dry-run", "--device", "cpu"])
    assert rc == 0
    assert "using remembered master dir" in capsys.readouterr().out


def test_cli_render_mode_pro_runs(clip, lut, tmp_path):
    """render --mode pro through the port's CLI on the CPU: a delivery
    file, and the master dir empty again."""
    master, out = tmp_path / "masters", tmp_path / "out"
    master.mkdir()
    rc = cli.main(["render", str(clip), "--lut", str(lut), "--mode", "pro",
                   "--master-dir", str(master), "--out-dir", str(out),
                   "--codec", "mpeg4", "--device", "cpu"])
    assert rc == 0
    (delivered,) = [p for p in out.iterdir() if p.is_file()]
    assert probe_video(delivered).width == 64
    assert not list(master.iterdir())


# ---- each stage's pixels against the JAX package ---------------------------

def _decoded(path):
    with VideoDecoder(path) as dec:
        frames = list(dec)
    return tuple(np.stack([getattr(f, c) for f in frames]) for c in "yuv")


@pytest.fixture(scope="module")
def pro_run(tmp_path_factory):
    """A 10-bit ProRes source through stage 1 (the port's run_stage on the
    CPU), then each stage's RenderConfig as the runner derives it, with
    stage 2's from a probe of the real master."""
    d = tmp_path_factory.mktemp("pro_pixels")
    src = make_10bit_prores_clip(d / "src.mov", 192, 108, frames=4)
    cube = write_cube_file(d / "look.cube", random_lut(17, seed=31))
    task = Task(task_id="pro", source_path=src, output_path=d / "out.mp4",
                lut_path=cube, cover_path=None,
                params=ProcessingParams(processing_mode="pro",
                                        video_codec="mpeg4"),
                source_info=probe_video(src),
                intermediate_path=d / "src_master.mov")
    (_, info1, spec1, _), _ = task_stages(task)
    res = run_stage(spec1, info1, load_lut_table(cube, "cpu"), device="cpu")
    assert res.ok, res.error
    return (task, cube, task_stages(task),
            task_stages(task, probe=probe_video))


def test_pro_stage_configs_as_the_runner_derives_them(pro_run):
    """Stage 1 renders 422p10 -> 422p10 with the LUT; stage 2 the master,
    without it, to 8-bit 4:2:0. The master's synthetic probe
    (baseline.master_info) derives stage 2's config as the real probe
    does; both packages' engine.config derive the same fields."""
    _, _, synthetic, probed = pro_run
    (_, _, _, cfg1), (_, info2, spec2, cfg2) = probed
    assert (cfg1.in_depth, cfg1.out_depth, cfg1.in_subsampling,
            cfg1.out_subsampling, cfg1.apply_lut) == (10, 10, "422", "422",
                                                      True)
    assert (info2.pix_fmt, cfg2.in_depth, cfg2.out_depth, cfg2.in_subsampling,
            cfg2.out_subsampling, cfg2.apply_lut) == ("yuv422p10le", 10, 8,
                                                      "422", "420", False)
    assert [s[3] for s in synthetic] == [cfg1, cfg2]
    for stage, info, spec, cfg in probed:
        want = jconfig.derive_render_config(spec, info)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), stage.name


@pytest.mark.parametrize("index", [0, 1], ids=["stage1_master",
                                               "stage2_delivery"])
def test_pro_stage_pixels_match_jax(pro_run, index):
    """Stage 1 on its decoded source, stage 2 on the decoded master: the
    port's render function on the CPU against the JAX package's
    render_yuv_frame (plain layout, gather LUT, called as its render tests
    call it) on the same frames. Stage 2 takes 10-bit limited range to 8
    bits undithered, so a quarter of its luma codes land on an exact
    rounding tie: the port rounds them as colorcore's NumPy arithmetic
    and the JAX function do; XLA's compiled form of the same function
    (the JAX make_render_fn) rounds some of them the other way."""
    task, cube, _, probed = pro_run
    stage, info, spec, cfg = probed[index]
    frames = _decoded(stage.source_path)
    lut = parse_cube_file(cube) if stage.lut_path is not None else None
    got = make_render_fn(lut, cfg, "cpu")(*to_torch(*frames))
    jcfg = dataclasses.replace(jconfig.derive_render_config(spec, info),
                               lut_strategy="gather", phase_layout="plain")
    want = jrender.render_yuv_frame(*frames, None if lut is None
                                    else prepare_lut(lut), jcfg)
    assert got[0].shape == frames[0].shape
    assert got[1].shape[-2:] == ((54, 96) if index else (108, 96))
    assert_integer_contract(got, want, stage.name)
