"""The port's engine, tasks and CLI against the JAX package's, end to end
on the CPU: config derivation over a corpus of specs, run_stage on a
fixture clip (decoded planes under the integer contract, max |d| <= 1 code
value on fewer than 1e-3 of pixels), and the CLI's render command."""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lut_renderer_tpu.colorcore import Lut3D, parse_cube_file, write_cube_file
from lut_renderer_tpu.engine import config as jconfig
from lut_renderer_tpu.engine import run_stage as jax_run_stage
from lut_renderer_tpu.hostio import probe_video
from lut_renderer_tpu.hostio.decode import VideoDecoder
from lut_renderer_tpu.models import ProcessingParams, VideoInfo
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.plan import build_render_spec
from lut_renderer_tpu.utils.fixtures import make_gradient_clip
from lut_renderer_tpu_torch.app import cli
from lut_renderer_tpu_torch.engine import config as tconfig
from lut_renderer_tpu_torch.engine import render_batches, run_stage
from lut_renderer_tpu_torch.ops.prepare import LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.tasks import load_lut_table

from torch_parity import assert_integer_contract, planes

SRC, OUT, LUT = Path("/in/a.mp4"), Path("/out/a.mov"), Path("/l/look.cube")

INFOS = [
    None,
    VideoInfo(pix_fmt="yuv420p", bit_depth=8, fps=25.0, duration=2.0),
    VideoInfo(pix_fmt="yuvj420p", bit_depth=8, colorspace="smpte170m"),
    VideoInfo(pix_fmt="yuv422p10le", bit_depth=10, colorspace="bt2020nc"),
    VideoInfo(pix_fmt="yuv444p", bit_depth=8, color_range="pc"),
]
PARAMS = [
    ProcessingParams(),
    ProcessingParams(video_codec="prores_ks", profile="3"),
    ProcessingParams(zscale_dither="ordered", pix_fmt="yuv420p"),
    ProcessingParams(zscale_dither="random", lut_interp="trilinear"),
    ProcessingParams(video_codec="libvpx-vp9", crf="30", resolution="64x48"),
    ProcessingParams(bit_depth_policy="force_8bit", lut_output_tags="inherit"),
]


@pytest.mark.parametrize("info", INFOS, ids=lambda i: i.pix_fmt if i else "none")
@pytest.mark.parametrize("lut", [LUT, None], ids=["lut", "nolut"])
def test_config_copy_derives_what_the_jax_config_derives(info, lut):
    for params in PARAMS:
        spec = build_render_spec(SRC, OUT, params, lut, info)
        got = tconfig.derive_render_config(spec, info)
        want = jconfig.derive_render_config(spec, info)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), params
        # each package has its own EncoderSettings class: compare fields
        assert (dataclasses.asdict(
            tconfig.derive_encoder_settings(spec, info, 64, 48))
            == dataclasses.asdict(
                jconfig.derive_encoder_settings(spec, info, 64, 48)))
        assert (tconfig.effective_output_pix_fmt(spec, info)
                == jconfig.effective_output_pix_fmt(spec, info))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine")
    clip = make_gradient_clip(d / "clip.mp4", 128, 96, fps=25.0, frames=10,
                              pattern="zoneplate")
    ident = Lut3D.identity(17)
    table = ident.table.copy()
    table[..., 0] = np.clip(table[..., 0] * 1.15, 0, 1)
    table[..., 2] = table[..., 2] ** 1.2
    cube = write_cube_file(d / "look.cube", Lut3D(table=table, title="look"))
    return clip, cube


def _decoded(path):
    with VideoDecoder(path) as dec:
        frames = list(dec)
    return tuple(np.stack([getattr(f, c) for f in frames]) for c in "yuv")


def _spec(clip, cube, out, **kw):
    info = probe_video(clip)
    params = ProcessingParams(video_codec="ffv1", **kw)
    return build_render_spec(Path(clip), out, params, Path(cube), info), info


@pytest.mark.parametrize("dither", ["none", "ordered"])
def test_run_stage_matches_jax_run_stage(media, tmp_path, dither):
    clip, cube = media
    spec, info = _spec(clip, cube, tmp_path / "port.mkv",
                       zscale_dither=dither)
    logs = []
    res = run_stage(spec, info, load_lut_table(cube, "cpu"), device="cpu",
                    log_cb=logs.append, batch_size=4)
    assert res.ok, res.error
    assert res.stats.frames_out == 10 and res.stats.batches == 3
    assert "engine: LUT kernel precision=exact" in logs

    jspec = dataclasses.replace(spec, output=tmp_path / "jax.mkv")
    jres = jax_run_stage(jspec, info, prepare_lut(parse_cube_file(cube)),
                         lut_strategy="gather")
    assert jres.ok, jres.error
    got, want = _decoded(spec.output), _decoded(jspec.output)
    assert got[0].shape == (10, 96, 128)
    assert_integer_contract(got, want, f"run_stage dither={dither}")


def test_run_stage_resize_and_cancel(media, tmp_path):
    clip, cube = media
    lut = load_lut_table(cube, "cpu")
    assert load_lut_table(cube, "cpu") is lut  # cached
    spec, info = _spec(clip, cube, tmp_path / "r.mkv", resolution="64x48")
    res = run_stage(spec, info, lut, device="cpu")
    assert res.ok, res.error
    assert _decoded(spec.output)[0].shape == (10, 48, 64)
    # a resize to the source size is the identity and is dropped
    spec, info = _spec(clip, cube, tmp_path / "same.mkv",
                       resolution="128x96")
    assert run_stage(spec, info, lut, device="cpu").ok
    ev = threading.Event()
    ev.set()
    res = run_stage(spec, info, lut, device="cpu", cancel=ev)
    assert not res.ok and res.canceled


def test_run_stage_profiler_trace(media, tmp_path):
    clip, cube = media
    spec, info = _spec(clip, cube, tmp_path / "p.mkv")
    res = run_stage(spec, info, None, device="cpu",
                    profile_dir=str(tmp_path / "prof"))
    assert res.ok, res.error
    assert (tmp_path / "prof" / "render_trace.json").stat().st_size > 0


def test_render_batches_cpu_keeps_order_and_counts():
    fn = make_render_fn(None, RenderConfig(apply_lut=False), "cpu")
    batches = [(*planes(s, 2, 16, 32, 8), c) for s, c in ((1, 2), (2, 1))]
    outs = list(render_batches(iter(batches), fn, torch.device("cpu")))
    assert [o[3] for o in outs] == [2, 1]
    for o, b in zip(outs, batches):
        assert o[0].shape == b[0].shape and o[0].dtype == np.uint8


def test_cli_render_cpu_end_to_end(media, tmp_path):
    clip, cube = media
    out_dir = tmp_path / "cli"
    rc = cli.main(["render", str(clip), "--lut", str(cube), "--out-dir",
                   str(out_dir), "--codec", "ffv1", "--pix-fmt", "yuv420p",
                   "--device", "cpu"])
    assert rc == 0
    (out,) = [p for p in out_dir.iterdir() if p.is_file()]
    got = _decoded(out)
    spec, info = _spec(clip, cube, tmp_path / "ref.mkv", pix_fmt="yuv420p")
    lut = LutTable.from_lut3d(parse_cube_file(cube), "cpu")
    assert run_stage(spec, info, lut, device="cpu").ok
    assert_integer_contract(got, _decoded(spec.output), "CLI vs run_stage")


def test_cli_device_cuda_without_card_raises(media, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    clip, cube = media
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", str(clip), "--lut", str(cube), "--out-dir",
                  str(tmp_path), "--device", "cuda"])


def test_cli_parser_offers_render_and_doctor_only(capsys):
    """The parser offers render and doctor, and now every other subcommand
    of the JAX CLI too; an unknown one is refused."""
    parser = cli.build_parser()
    args = parser.parse_args(["render", "x.mp4"])
    assert args.device == "cuda" and args.fn is cli.cmd_render
    assert parser.parse_args(["doctor"]).fn is cli.cmd_doctor
    args = parser.parse_args(["serve", "--socket", "s"])
    assert args.fn is cli.cmd_serve and args.device == "cuda"
    with pytest.raises(SystemExit):
        parser.parse_args(["bogus"])
    rc = cli.main(["doctor"])
    out = capsys.readouterr().out
    assert "torch" in out and "hostio FFmpeg libs" in out
    assert rc == (0 if torch.cuda.is_available() else 1)
