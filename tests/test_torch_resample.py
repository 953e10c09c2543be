"""The port's resize path against the JAX package's: the swscale-matched
bicubic weights (bit-equal) and their band form (the dense matrix back bit
for bit), resample_plane's banded plain version (within 1e-5 of the JAX
einsums, of the dense yardstick and of libswscale's own output; a frame
alone equals it in a batch), the kernel's launch geometry and ctypes
mirror, the TF32 setting and the dense yardstick's switch, whole
frames with a resize through render_yuv_frame and run_stage (the integer
contract: max |d| <= 1 code value on fewer than 1e-3 of pixels; float
planes of error diffusion within 1e-4), the renderer's weight cache and
the executor's identity-resize drop."""

import ctypes
import dataclasses
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lut_renderer_tpu.colorcore import parse_cube_file
from lut_renderer_tpu.engine import run_stage as jax_run_stage
from lut_renderer_tpu.hostio import probe_video
from lut_renderer_tpu.hostio.decode import VideoDecoder
from lut_renderer_tpu.hostio.oracle import ScaleOracle
from lut_renderer_tpu.models import ProcessingParams
from lut_renderer_tpu.ops import render as jrender
from lut_renderer_tpu.ops import resample as jres
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.plan import build_render_spec
from lut_renderer_tpu_torch.colorcore import write_cube_file
from lut_renderer_tpu_torch.engine import run_stage
from lut_renderer_tpu_torch.ops import lut3d
from lut_renderer_tpu_torch.ops import render as trender
from lut_renderer_tpu_torch.ops import resample as tres
from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable
from lut_renderer_tpu_torch.tasks import load_lut_table
from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

from torch_parity import (
    DOMAIN,
    assert_integer_contract,
    planes,
    random_lut,
    to_torch,
)

RESAMPLE_ATOL = 1e-5
FLOAT_PLANE_ATOL = 1e-4


# (src, dst) of one axis, odd and degenerate ones and the cells' resizes
WEIGHT_PAIRS = [(16, 32), (32, 16), (24, 10), (10, 24), (17, 13), (12, 12),
                (1, 4), (3, 1), (2, 7), (64, 9), (1080, 2160), (3840, 1920),
                (2160, 1080)]


@pytest.mark.parametrize("src,dst", WEIGHT_PAIRS)
def test_weights_are_the_jax_weights_bit_for_bit(src, dst):
    got = tres.swscale_bicubic_weights(src, dst)
    want = jres.swscale_bicubic_weights(src, dst)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    for a, b in zip(tres.resample_weights((src, dst), (dst, src)),
                    jres.resample_weights((src, dst), (dst, src))):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        tres.swscale_bicubic_weights(0, dst)


@pytest.mark.parametrize("shape,out_hw", [
    ((20, 24), (10, 12)), ((3, 20, 24), (36, 52)), ((2, 2, 16, 30), (9, 41)),
    ((1, 32, 48), (32, 48)), ((2, 17, 13), (13, 17)), ((3, 64, 64), (9, 9)),
    ((2, 1, 3), (4, 1)), ((2, 3, 1), (1, 4)), ((1, 2, 7), (7, 2)),
    ((1, 216, 384), (4, 6)), ((4, 2, 36, 64), (72, 128))])
def test_resample_plane_matches_jax(shape, out_hw):
    """The banded plain version (resample_plane on a CPU tensor, from the
    dense matrices or from bands_on) within 1e-5 of the JAX einsums and of
    the dense yardstick; each frame equals that frame resampled alone."""
    x = np.random.default_rng(1).random(shape, np.float32)
    wv, wh = jres.resample_weights(shape[-2:], out_hw)
    got = tres.resample_plane(*to_torch(x, wv, wh))
    want = np.asarray(jres.resample_plane(x, wv, wh))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == shape[:-2] + out_hw
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESAMPLE_ATOL)
    dense = tres.resample_plane_dense(*to_torch(x, wv, wh))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                               atol=RESAMPLE_ATOL)
    bv, bh = tres.bands_on(shape[-2:], out_hw[::-1], "cpu")
    assert torch.equal(tres.resample_plane_reference(torch.from_numpy(x),
                                                     bv, bh), got)
    # frame by frame: a frame resamples as it does alone
    flat = got.reshape(-1, *out_hw)
    for i, frame in enumerate(torch.from_numpy(x).reshape(-1, *shape[-2:])):
        assert torch.equal(tres.resample_plane(frame, bv, bh), flat[i])


@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 48), (16, 24)), ((24, 20), (36, 52)), ((30, 44), (44, 30))])
def test_resample_plane_matches_swscale(in_hw, out_hw):
    """The banded plain version against the bundled libswscale's own `-s`
    scaler, as tests/test_resample.py holds the JAX package (smooth content
    in [0.3, 0.7], so swscale's f32 output clamp does not skew it)."""
    (ih, iw), (oh, ow) = in_hw, out_hw
    yy, xx = np.mgrid[0:ih, 0:iw].astype(np.float32)
    plane = (0.5 + 0.12 * np.sin(2 * np.pi * xx / iw * 2.3 + 1.0)
             + 0.08 * np.cos(2 * np.pi * yy / ih * 1.7 + 2.0)
             ).astype(np.float32)
    with ScaleOracle(iw, ih, ow, oh) as orc:
        ref = orc.scale_gray(plane)
    got = tres.resample_plane(*to_torch(
        plane, *tres.resample_weights(in_hw, out_hw)))
    np.testing.assert_allclose(np.clip(got.numpy(), 0, 1), ref, atol=2e-3)


def test_resample_plane_restores_the_callers_tf32_setting():
    """Neither the banded resample nor the dense yardstick leaves the
    caller's TF32 setting changed, and neither result moves with it."""
    mm = torch.backends.cuda.matmul
    x, wv, wh = to_torch(np.random.default_rng(2).random((2, 16, 24),
                                                         np.float32),
                         *tres.resample_weights((16, 24), (8, 40)))
    saved = mm.fp32_precision
    try:
        want = [f(x, wv, wh) for f in (tres.resample_plane,
                                       tres.resample_plane_dense)]
        assert mm.fp32_precision == saved
        mm.allow_tf32 = True
        got = [f(x, wv, wh) for f in (tres.resample_plane,
                                      tres.resample_plane_dense)]
        assert mm.fp32_precision == "tf32" and mm.allow_tf32
        for a, e in zip(got, want):
            assert torch.equal(a, e)
        seen = []
        with tres.ieee_f32_matmul():
            seen.append(mm.fp32_precision)
        assert seen == ["ieee"] and mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = saved


def test_precision_switch_is_serialised_across_threads():
    """Resamples from many threads, each checking the switch holds
    "ieee" for its own block; the caller's setting survives them all."""
    mm = torch.backends.cuda.matmul
    saved = mm.fp32_precision
    errors = []

    def worker():
        try:
            for _ in range(50):
                with tres.ieee_f32_matmul():
                    assert mm.fp32_precision == "ieee"
        except AssertionError as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert mm.fp32_precision == saved


# ---- the band form, its plain version and the kernel's host side ----------

def dense(band) -> np.ndarray:
    """The (dst, src) matrix a Band holds."""
    w = np.zeros((band.dst, band.src), np.float32)
    cols = band.start.numpy()[:, None] + np.arange(band.k)
    w[np.arange(band.dst)[:, None], cols] = band.taps.numpy()
    return w


@pytest.mark.parametrize("src,dst", WEIGHT_PAIRS)
def test_band_rebuilds_the_weights_bit_for_bit(src, dst):
    want = jres.swscale_bicubic_weights(src, dst)
    band = tres.Band.from_dense(tres.swscale_bicubic_weights(src, dst))
    assert np.array_equal(dense(band), want)
    start = band.start.numpy()
    assert band.start.dtype == torch.int32 and band.taps.dtype == torch.float32
    assert np.array_equal(start, band.host_start)
    assert (np.diff(start) >= 0).all() and start.min() >= 0
    assert start.max() + band.k <= src and band.dst == dst
    # K is the widest run of non-zero weights over the rows
    nz = want != 0
    runs = (src - nz[:, ::-1].argmax(1)) - nz.argmax(1)
    assert band.k == runs.max()


def test_band_refuses_starts_that_fall():
    w = np.eye(4, dtype=np.float32)[::-1]
    with pytest.raises(ValueError, match="decrease"):
        tres.Band.from_dense(w)


_CTYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const int*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int}


def test_ctypes_mirror_matches_the_c_struct():
    src = (Path(tres.__file__).parent.parent / "csrc" / "resample.cu"
           ).read_text()
    body = re.search(r"struct ResampleParams \{(.*?)\n\};", src, re.S).group(1)
    want = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            m = re.fullmatch(r"(.+?)\s*(\w+);", line)
            want.append((m.group(2), _CTYPES[m.group(1).replace(" *", "*")]))
    assert tres._ResampleParams._fields_ == want
    from lut_renderer_tpu_torch.ops import _build

    assert "resample.cu" in _build.SOURCES
    assert "resample_launch" in _build.ENTRY_POINTS
    # the kernel's symbol carries `gemm`: the benchmark reads the layer so
    assert "resample_banded_gemm_kernel" in src


@pytest.mark.parametrize("in_hw,out_hw", [((2160, 3840), (1080, 1920)),
                                          ((1080, 1920), (2160, 3840)),
                                          ((4320, 7680), (2160, 3840)),
                                          ((2160, 3840), (720, 1280))])
def test_launch_geometry_fits_two_blocks_an_sm(in_hw, out_hw):
    """The resize shapes take a whole-window tile that leaves room for at
    least two blocks on each SM (228 KB of shared memory each), and every
    tile's window holds its taps."""
    bv, bh = tres.bands_on(in_hw, out_hw[::-1], "cpu")
    for vec in (True, False):
        g = tres.geometry(bv, bh, vec)
        assert g.chunk_h == g.win_h and g.tile_h * g.tile_w >= 512
        nbytes = tres.smem_bytes(g.tile_h, g.tile_w, g.win_w, g.chunk_h,
                                 bv.k, bh.k)
        assert nbytes <= tres.SMEM_BYTES and g.win_w % 4 == 0
        # blocks an SM holds: 2048 threads, 228 KB less 1 KB a block
        assert min(2048 // tres.THREADS, 228 * 1024 // (nbytes + 1024)) >= 2
        for band, tile, win, align in ((bv, g.tile_h, g.win_h, 1),
                                       (bh, g.tile_w, g.win_w, 4 if vec
                                        else 1)):
            s = band.host_start
            for t0 in range(0, band.dst, tile):
                t1 = min(t0 + tile, band.dst) - 1
                lo = s[t0] - s[t0] % align
                assert s[t1] + band.k - lo <= win


def test_launch_geometry_chunks_a_window_too_tall_and_refuses_too_wide():
    bv, bh = tres.bands_on((2160, 3840), (64, 36), "cpu")
    g = tres.geometry(bv, bh, True)
    assert (g.tile_h, g.tile_w) == (1, 1) and 1 <= g.chunk_h < g.win_h
    assert (tres.smem_bytes(1, 1, g.win_w, g.chunk_h, bv.k, bh.k)
            <= tres.SMEM_BYTES
            < tres.smem_bytes(1, 1, g.win_w, g.chunk_h + 1, bv.k, bh.k))
    wide = tres.Band.from_dense(np.full((1, 6200), 1 / 6200, np.float32))
    with pytest.raises(ValueError, match="too wide"):
        tres.geometry(bv, wide, False)


def test_launch_args_refuse_what_the_kernel_cannot_take():
    bv, bh = tres.bands_on((4, 8), (4, 2), "cpu")
    p, out, keep = tres.launch_args(torch.zeros((3, 4, 8)), bv, bh)
    assert out.shape == (3, 2, 4) and (p.frames, p.h, p.w) == (3, 4, 8)
    assert (p.oh, p.ow, p.kv, p.kh) == (2, 4, bv.k, bh.k) and p.vec == 1
    g = tres.geometry(bv, bh, True)
    assert (p.tile_h, p.tile_w, p.win_h, p.win_w, p.chunk_h) == (
        g.tile_h, g.tile_w, g.win_h, g.win_w, g.chunk_h)
    rows = tres.MAX_GRID_YZ * 16 + 1  # one row tile too many
    tall = tres.Band(torch.zeros(rows, dtype=torch.int32),
                     torch.ones((rows, 1)), 1, np.zeros(rows, np.int64))
    with pytest.raises(ValueError, match="split the batch"):
        tres.launch_args(torch.zeros((1, 1, 8)), tall, bh)
    with pytest.raises(ValueError, match="split the batch"):
        tres.launch_args(torch.zeros((tres.MAX_GRID_YZ + 1, 4, 8)), bv, bh)
    with pytest.raises(ValueError, match="cannot take"):
        tres.launch_args(torch.zeros((1, 4, 9)), bv, bh)
    with pytest.raises(ValueError, match="cannot take"):
        tres.resample_plane(torch.zeros((1, 5, 8)), bv, bh)


@pytest.fixture(scope="module")
def lut():
    return random_lut(17, seed=31, domain=DOMAIN)


# RenderConfig overrides, (batch, in h, in w), resize (w, h)
RESIZE_CASES = {
    "420p8_down": (dict(), (2, 32, 64), (32, 16)),
    "420p8_up": (dict(), (1, 16, 32), (64, 48)),
    "422p10_to_420p8": (dict(in_depth=10, in_subsampling="422"),
                        (2, 32, 64), (40, 24)),
    "ordered": (dict(dither="ordered"), (2, 32, 64), (48, 20)),
    "random_444": (dict(dither="random", in_subsampling="444",
                        out_subsampling="444"), (1, 16, 30), (18, 26)),
    "no_lut": (dict(apply_lut=False), (1, 16, 64), (32, 8)),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_render_yuv_frame_resize_matches_jax(lut, case):
    kw, (b, h, w), size = RESIZE_CASES[case]
    cfg = trender.RenderConfig(resize=size, **kw)
    y, u, v = planes(3, b, h, w, cfg.in_depth, cfg.in_subsampling)
    got = trender.render_yuv_frame(*to_torch(y, u, v),
                                   LutTable.from_lut3d(lut, "cpu"), cfg)
    want = jrender.render_yuv_frame(
        y, u, v, prepare_lut(lut),
        jrender.RenderConfig(lut_strategy="gather", resize=size, **kw))
    assert got[0].shape == (b, size[1], size[0])
    assert_integer_contract(got, want, case)


def test_error_diffusion_resize_float_planes_match_jax(lut):
    kw = dict(resize=(48, 24), dither="error_diffusion_host")
    y, u, v = planes(4, 2, 32, 64, 8)
    got = trender.render_yuv_frame(*to_torch(y, u, v),
                                   LutTable.from_lut3d(lut, "cpu"),
                                   trender.RenderConfig(**kw))
    want = jrender.render_yuv_frame(
        y, u, v, prepare_lut(lut),
        jrender.RenderConfig(lut_strategy="gather", **kw))
    for a, e in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == np.shape(e)
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=FLOAT_PLANE_ATOL)


def test_coarse2f_65_resize_matches_jax(monkeypatch):
    """A coarse2f 65^3 LUT with a resize: kernel C's plain version at the
    input size, then the resample, against the JAX coarse2 kernel in
    interpret mode with the same resize."""
    lut65 = random_lut(65, seed=21, domain=DOMAIN)
    calls = []
    real = lut3d.apply_lut_planes_coarse2_reference
    monkeypatch.setattr(lut3d, "apply_lut_planes_coarse2_reference",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    kw = dict(resize=(32, 24), lut_precision="coarse2f")
    y, u, v = planes(6, 1, 16, 64, 8)
    got = trender.make_render_fn(lut65, trender.RenderConfig(**kw),
                                 "cpu")(*to_torch(y, u, v))
    assert len(calls) == 1 and isinstance(calls[0], Coarse2Table)
    want = jrender.render_yuv_frame(y, u, v, prepare_lut(lut65),
                                    jrender.RenderConfig(**kw),
                                    interpret=True)
    assert got[0].shape == (1, 24, 32)
    assert_integer_contract(got, want, "coarse2f 65^3 resize")


def test_forced_fused_with_a_resize_raises(lut):
    y, u, v = to_torch(*planes(1, 1, 16, 64, 8))
    with pytest.raises(ValueError, match="forced"):
        trender.render_yuv_frame(
            y, u, v, LutTable.from_lut3d(lut, "cpu"),
            trender.RenderConfig(resize=(32, 8), phase_layout="fused"))


def test_renderer_caches_the_weights_by_input_size(lut):
    cfg = trender.RenderConfig(resize=(24, 12), dither="ordered")
    fn = trender.make_render_fn(lut, cfg, "cpu")
    renderer = trender._RENDER_FN_CACHE[
        (cfg, LutTable.from_lut3d(lut, "cpu").static_key,
         torch.device("cpu"))]
    sizes = [(16, 32), (16, 64), (32, 64), (8, 16), (24, 48), (16, 32)]
    for h, w in sizes:
        out = fn(*to_torch(*planes(h, 1, h, w, 8)))
        assert out[0].shape == (1, 12, 24)
    assert len(renderer._weights) == renderer.WEIGHTS_MAX
    assert list(renderer._weights)[-1] == (16, 32)  # rebuilt after eviction
    wv, wh = renderer.resize_weights((16, 32))
    assert renderer.resize_weights((16, 32))[0] is wv
    assert np.array_equal(dense(wh), jres.swscale_bicubic_weights(32, 24))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_resample")
    clip = make_gradient_clip(d / "clip.mp4", 128, 96, fps=25.0, frames=6,
                              pattern="zoneplate")
    cube = write_cube_file(d / "look.cube", random_lut(17, seed=32))
    return clip, cube


def _decoded(path):
    with VideoDecoder(path) as dec:
        frames = list(dec)
    return tuple(np.stack([getattr(f, c) for f in frames]) for c in "yuv")


@pytest.mark.parametrize("resolution,dither", [("64x48", "none"),
                                               ("192x144", "ordered")])
def test_run_stage_resize_matches_jax_run_stage(media, tmp_path, resolution,
                                                dither):
    clip, cube = media
    info = probe_video(clip)
    spec = build_render_spec(
        Path(clip), tmp_path / "port.mkv",
        ProcessingParams(video_codec="ffv1", resolution=resolution,
                         zscale_dither=dither), Path(cube), info)
    logs = []
    res = run_stage(spec, info, load_lut_table(cube, "cpu"), device="cpu",
                    log_cb=logs.append)
    assert res.ok, res.error
    assert any(f"128x96 -> {resolution}" in m for m in logs), logs
    jspec = dataclasses.replace(spec, output=tmp_path / "jax.mkv")
    jres_ = jax_run_stage(jspec, info, prepare_lut(parse_cube_file(cube)),
                          lut_strategy="gather")
    assert jres_.ok, jres_.error
    got, want = _decoded(spec.output), _decoded(jspec.output)
    w, h = map(int, resolution.split("x"))
    assert got[0].shape == (6, h, w)
    assert_integer_contract(got, want, f"run_stage resize {resolution}")


def test_run_stage_drops_the_identity_resize(media, tmp_path, monkeypatch):
    """A resize to the source size is the identity and is dropped, so the
    job keeps the fused layout: no resample runs."""
    clip, cube = media
    info = probe_video(clip)
    spec = build_render_spec(
        Path(clip), tmp_path / "same.mkv",
        ProcessingParams(video_codec="ffv1", resolution="128x96"),
        Path(cube), info)
    monkeypatch.setattr(trender, "resample_plane", None)  # fails if run
    res = run_stage(spec, info, load_lut_table(cube, "cpu"), device="cpu")
    assert res.ok, res.error
