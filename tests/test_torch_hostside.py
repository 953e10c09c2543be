"""The port's copies of the JAX package's backend-free modules (colorcore,
native_ext, models, plan, hostio, app helpers, utils.fixtures) against
their originals: the copies are the original files byte for byte (their
imports are relative, so nothing needed rewriting), and they compute what
the originals compute on the same inputs. The port's CLI builds its own
parser; its render flags are the JAX parser's plus ``--device``."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import lut_renderer_tpu as jpkg
import lut_renderer_tpu_torch as tpkg
from lut_renderer_tpu import native_ext as jnative
from lut_renderer_tpu.app import cli as jcli
from lut_renderer_tpu.app import naming as jnaming
from lut_renderer_tpu.colorcore import cube as jcube
from lut_renderer_tpu.colorcore import dither as jdither
from lut_renderer_tpu.colorcore import matrices as jmat
from lut_renderer_tpu.hostio import decode as jdecode
from lut_renderer_tpu.hostio import probe as jprobe
from lut_renderer_tpu.models import (
    ProcessingParams as JParams,
    Task as JTask,
    VideoInfo as JInfo,
)
from lut_renderer_tpu.plan import build_pipeline as jpipeline
from lut_renderer_tpu.plan import build_render_spec as jspec
from lut_renderer_tpu_torch import native_ext as tnative
from lut_renderer_tpu_torch.app import cli as tcli
from lut_renderer_tpu_torch.app import naming as tnaming
from lut_renderer_tpu_torch.colorcore import cube as tcube
from lut_renderer_tpu_torch.colorcore import dither as tdither
from lut_renderer_tpu_torch.colorcore import matrices as tmat
from lut_renderer_tpu_torch.hostio import decode as tdecode
from lut_renderer_tpu_torch.hostio import probe as tprobe
from lut_renderer_tpu_torch.models import (
    ProcessingParams as TParams,
    Task as TTask,
    VideoInfo as TInfo,
)
from lut_renderer_tpu_torch.plan import build_pipeline as tpipeline
from lut_renderer_tpu_torch.plan import build_render_spec as tspec
from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

from torch_parity import random_lut

JROOT = Path(jpkg.__file__).parent
TROOT = Path(tpkg.__file__).parent

COPIES = (
    "colorcore/__init__.py", "colorcore/cube.py", "colorcore/matrices.py",
    "colorcore/dither.py", "colorcore/interp.py", "colorcore/metrics.py",
    "native_ext.py",
    "models/__init__.py", "models/params.py", "models/task.py",
    "models/video_info.py",
    "plan/__init__.py", "plan/policy.py", "plan/pipeline.py",
    "hostio/__init__.py", "hostio/ffi.py", "hostio/probe.py",
    "hostio/decode.py", "hostio/encode.py", "hostio/audio.py",
    "app/settings.py", "app/lut_history.py", "app/naming.py",
    "app/estimate.py", "app/defaults.py", "app/taskfactory.py",
    "app/presets.py", "app/monitor.py", "app/termio.py",
    "utils/__init__.py", "utils/fixtures.py",
)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original(rel):
    assert (TROOT / rel).read_bytes() == (JROOT / rel).read_bytes(), (
        f"{rel} drifted from lut_renderer_tpu/{rel}")


# the parameter matrix of the policy drift test: (params, source info)
SOURCES = {
    "none": None,
    "h264_8bit": dict(width=1920, height=1080, pix_fmt="yuv420p",
                      bit_depth=8, fps=25.0, duration=4.0, codec_name="h264",
                      bitrate="8000k", colorspace="bt709"),
    "prores_10bit": dict(width=3840, height=2160, pix_fmt="yuv422p10le",
                         bit_depth=10, fps=23.976, duration=2.0,
                         codec_name="prores", colorspace="bt2020nc",
                         color_primaries="bt2020", color_trc="smpte2084"),
    "full_range_mjpeg": dict(width=640, height=360, pix_fmt="yuvj420p",
                             bit_depth=8, fps=30.0, codec_name="mjpeg",
                             color_range="pc"),
    "vfr_audio": dict(width=1280, height=720, pix_fmt="yuv420p", bit_depth=8,
                      fps=29.97, avg_fps=27.1, r_fps=30.0, is_vfr=True,
                      duration=3.0, audio_codec="aac",
                      audio_sample_rate=48000, audio_channels=2),
}
PARAMS = {
    "fast": dict(),
    "pro": dict(processing_mode="pro"),
    "crf_vp9": dict(video_codec="libvpx-vp9", crf="30"),
    "crf_mpeg4": dict(video_codec="mpeg4", crf="23"),
    "bitrate": dict(bitrate="12M", gop="48"),
    "10bit_prores": dict(video_codec="prores_ks", profile="3",
                         pix_fmt="yuv422p10le"),
    "force_8bit_ordered": dict(bit_depth_policy="force_8bit",
                               zscale_dither="ordered"),
    "no_cfr_inherit": dict(force_cfr=False, inherit_color_metadata=False,
                           lut_output_tags="inherit"),
    "resize_fps": dict(resolution="1280x720", fps="24"),
}


def _pair(params, info):
    jinfo = None if info is None else JInfo(**info)
    tinfo = None if info is None else TInfo(**info)
    return (JParams(**params), jinfo), (TParams(**params), tinfo)


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("lut", [Path("/l/look.cube"), None],
                         ids=["lut", "nolut"])
def test_render_spec_and_pipeline_copies(source, lut):
    for name, params in PARAMS.items():
        (jp, ji), (tp, ti) = _pair(params, SOURCES[source])
        src, out = Path("/in/a.mov"), Path("/out/a.mp4")
        try:
            want = dataclasses.asdict(jspec(src, out, jp, lut, ji))
        except Exception as exc:  # the copy must raise the same way
            with pytest.raises(type(exc)):
                tspec(src, out, tp, lut, ti)
            continue
        assert dataclasses.asdict(tspec(src, out, tp, lut, ti)) == want, name
        tasks = [cls(task_id="t1", source_path=src, output_path=out,
                     lut_path=lut, cover_path=None, params=p, source_info=i,
                     intermediate_path=(Path("/cache/a.mov")
                                        if p.processing_mode == "pro"
                                        else None))
                 for cls, p, i in ((JTask, jp, ji), (TTask, tp, ti))]
        stages = [[dataclasses.asdict(s) for s in fn(t)]
                  for fn, t in ((jpipeline, tasks[0]), (tpipeline, tasks[1]))]
        assert stages[1] == stages[0], name


def test_parse_cube_copy(tmp_path):
    lut = random_lut(9, seed=2, domain=((-0.1, 0.0, 0.0), (1.1, 1.0, 1.0)))
    text = tcube.write_cube_file(tmp_path / "a.cube", lut).read_text()
    assert jcube.write_cube_file(tmp_path / "b.cube", lut).read_text() == text
    got, want = tcube.parse_cube(text), jcube.parse_cube(text)
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.domain_min, want.domain_min)
    assert np.array_equal(got.domain_max, want.domain_max)
    assert got.title == want.title
    got = tcube.parse_cube_file(tmp_path / "a.cube")
    assert np.array_equal(got.table, jcube.parse_cube_file(
        tmp_path / "a.cube").table)


def test_matrices_copy():
    assert tmat.MATRIX_COEFFS == jmat.MATRIX_COEFFS
    assert tmat.DEFAULT_MATRIX == jmat.DEFAULT_MATRIX
    for name in jmat.MATRIX_COEFFS:
        assert tmat.yuv_rgb_coeffs(name) == jmat.yuv_rgb_coeffs(name)
    for depth in (8, 10, 12):
        for full in (False, True):
            assert (tmat._range_params(depth, full)
                    == jmat._range_params(depth, full))
    rng = np.random.default_rng(1)
    y, u, v = (rng.uniform(0, 1023, (4, 8)).astype(np.float32)
               for _ in range(3))
    for a, b in zip(tmat.yuv_to_rgb_planes(y, u, v, "bt2020nc", 10, False),
                    jmat.yuv_to_rgb_planes(y, u, v, "bt2020nc", 10, False)):
        assert np.array_equal(a, b)


def test_dither_copy():
    for order in (1, 2, 3, 4):
        assert np.array_equal(tdither.bayer_offsets(order),
                              jdither.bayer_offsets(order))
    assert np.array_equal(tdither.hash_noise_offsets(16, 24, 3),
                          jdither.hash_noise_offsets(16, 24, 3))


def test_error_diffusion_copy():
    plane = np.random.default_rng(5).uniform(0, 255, (12, 20)).astype(
        np.float32)
    got = tnative.error_diffusion_quantize(plane, 8)
    want = jnative.error_diffusion_quantize(plane, 8)
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)


def test_naming_copy(tmp_path):
    src = tmp_path / "clip.mov"
    src.write_bytes(b"")
    out = tmp_path / "out"
    out.mkdir()
    assert tnaming.default_output_dir(src) == jnaming.default_output_dir(src)
    assert tnaming.output_path_for(src, out) == jnaming.output_path_for(
        src, out)
    assert (tnaming.output_path_for(src, out, "mkv")
            == jnaming.output_path_for(src, out, "mkv"))
    assert tnaming.cover_path_for(src, out) == jnaming.cover_path_for(src, out)
    assert (tnaming.intermediate_path_for(src, out)
            == jnaming.intermediate_path_for(src, out))
    assert (tnaming.collect_video_files([tmp_path])
            == jnaming.collect_video_files([tmp_path]))


def test_hostio_copy_probes_and_decodes_as_the_original(tmp_path):
    clip = make_gradient_clip(tmp_path / "g.mp4", 64, 48, fps=25.0, frames=4,
                              pattern="zoneplate")
    assert (dataclasses.asdict(tprobe.probe_video(clip))
            == dataclasses.asdict(jprobe.probe_video(clip)))
    with tdecode.VideoDecoder(clip) as a, jdecode.VideoDecoder(clip) as b:
        fa, fb = list(a), list(b)
    assert len(fa) == len(fb) == 4
    for x, y in zip(fa, fb):
        for c in "yuv":
            assert np.array_equal(getattr(x, c), getattr(y, c))


def _flags(parser, command):
    sub = next(a for a in parser._actions if a.dest == "command")
    return {(tuple(a.option_strings), a.dest, a.default)
            for a in sub.choices[command]._actions}


def test_port_parser_render_flags_are_the_jax_flags_plus_device():
    port, jax = tcli.build_parser(), jcli.build_parser()
    extra = _flags(port, "render") - _flags(jax, "render")
    assert extra == {(("--device",), "device", "cuda")}
    assert _flags(jax, "render") <= _flags(port, "render")
    sub = next(a for a in port._actions if a.dest == "command")
    assert sorted(sub.choices) == ["doctor", "render"]


def test_port_params_from_args_is_the_jax_one():
    argv = ["render", "x.mp4", "--mode", "pro", "--crf", "20", "--codec",
            "libvpx-vp9", "--interp", "prism", "--dither", "ordered",
            "--no-force-cfr", "--cover", "--bit-depth", "force_8bit"]
    got = tcli._params_from_args(tcli.build_parser().parse_args(argv))
    want = jcli._params_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
