"""The plain layout's unpack and pack kernels (csrc/pixel.cu, ops/pixel.py).

On the CPU: which output planes and dither each config takes, the ctypes
mirrors of the params structs, the launch arguments and what they refuse,
the plain halves against render_planes, and the counters left at 0.

On the card (marker ``cuda``, skipped elsewhere): the kernel path bit-equal
to render_planes on the card and on the CPU over depths, geometries,
chroma siting, ranges, dithers and batch sizes, and to1080's render call
enqueued without a host sync. The file imports no jax, so that it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pixel_kernels.py
"""

import ctypes
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch.ops import _build, fused420, lut3d
from lut_renderer_tpu_torch.ops import pixel as px
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.probes.harness import tie_frames

from torch_parity import cuda_device, planes, random_lut, to_torch  # noqa: F401

cuda = pytest.mark.cuda

# RenderConfig overrides, (batch, height, width) and the kind of planes:
# depths 8/10/12 in and out, 4:2:0/4:2:2/4:4:4 both ways, both chroma
# sitings, the range combinations with and without the requantise, the three
# on-device dithers and error diffusion's float planes, batches of 1-3 and
# unbatched planes, random codes and tie-heavy 10 -> 8-bit ones. 70 columns:
# 35 chroma sites a row, no warp's multiple.
GRID = {
    "420p8": (dict(), (2, 18, 70), "random"),
    "420p8_unbatched": (dict(), (0, 18, 70), "random"),
    "420p8_b3_ordered": (dict(dither="ordered"), (3, 18, 70), "random"),
    "420p8_random": (dict(dither="random"), (1, 18, 70), "random"),
    "420p10_to_8_ties": (dict(in_depth=10), (3, 36, 70), "ties"),
    "420p10_to_8_ties_ordered": (dict(in_depth=10, dither="ordered"),
                                 (2, 36, 70), "ties"),
    "420p10_to_8_ties_random": (dict(in_depth=10, dither="random"),
                                (1, 36, 70), "ties"),
    "420p12_to_10": (dict(in_depth=12, out_depth=10, dither="random"),
                     (2, 18, 70), "random"),
    "420p8_to_12": (dict(out_depth=12, dither="ordered"), (1, 18, 70),
                    "random"),
    "420_bilinear": (dict(chroma_up="bilinear"), (2, 18, 70), "random"),
    "420p10_bilinear_full": (dict(in_depth=10, out_depth=10,
                                  chroma_up="bilinear", in_full_range=True),
                             (1, 18, 70), "random"),
    "420p12_bilinear_ties": (dict(in_depth=12, out_depth=8,
                                  chroma_up="bilinear"), (2, 36, 70), "ties"),
    "full_to_limited": (dict(in_full_range=True), (2, 18, 70), "random"),
    "full_to_limited_no_requant": (dict(in_full_range=True,
                                        requantize_intermediate=False),
                                   (2, 18, 70), "random"),
    "limited_to_full_work": (dict(in_depth=10, out_depth=10,
                                  work_full_range=True, out_full_range=True,
                                  dither="random"), (2, 18, 70), "random"),
    "full_throughout": (dict(in_full_range=True, work_full_range=True,
                             out_full_range=True), (1, 18, 70), "random"),
    "422p10_master": (dict(in_depth=10, out_depth=10, in_subsampling="422",
                           out_subsampling="422"), (2, 18, 70), "random"),
    "422p10_to_420p8_ties": (dict(in_depth=10, in_subsampling="422"),
                             (2, 36, 70), "ties"),
    "422_bilinear_is_replication": (dict(in_subsampling="422",
                                         chroma_up="bilinear"),
                                    (1, 18, 70), "random"),
    "444p12_roundtrip": (dict(in_depth=12, out_depth=12, in_subsampling="444",
                              out_subsampling="444", dither="ordered"),
                         (2, 18, 69), "random"),
    "420_to_444": (dict(out_subsampling="444", dither="random"),
                   (3, 18, 70), "random"),
    "444_to_420p10": (dict(in_subsampling="444", out_depth=10),
                      (2, 18, 70), "random"),
    "422_to_444_bt2020": (dict(in_subsampling="422", out_subsampling="444",
                               matrix_in="bt2020nc", matrix_out="bt601"),
                          (1, 18, 70), "random"),
    "420p10_to_8_error_diffusion": (dict(in_depth=10,
                                         dither="error_diffusion_host"),
                                    (2, 36, 70), "ties"),
    "422p10_to_444_error_diffusion": (dict(in_depth=10, out_depth=10,
                                           in_subsampling="422",
                                           out_subsampling="444",
                                           dither="error_diffusion_host"),
                                      (1, 18, 70), "random"),
}


def _grid_inputs(name):
    kw, (b, h, w), kind = GRID[name]
    cfg = RenderConfig(phase_layout="plain", **kw)
    make = tie_frames if kind == "ties" else planes
    frames = make(17, max(b, 1), h, w, cfg.in_depth, cfg.in_subsampling)
    if b == 0:
        frames = tuple(f[0] for f in frames)
    return cfg, frames


def _swap(r, g, b):
    """A LUT step that computes the same on every device: the channels
    rotated, so that chroma is not grey."""
    return g, b, r


# ---- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("dither,depth,want", [
    ("none", 8, (0, 0, torch.uint8)),
    ("ordered", 8, (0, 1, torch.uint8)),
    ("random", 8, (0, 2, torch.uint8)),
    ("none", 10, (1, 0, torch.uint16)),
    ("ordered", 16, (1, 1, torch.uint16)),
    ("error_diffusion_host", 8, (2, 0, torch.float32)),
    ("error_diffusion_host", 12, (2, 0, torch.float32)),
])
def test_pack_output_by_dither_and_depth(dither, depth, want):
    """The pack's (format, dither, dtype): integer planes at the output
    depth with the on-device dithers, and an error-diffusion job's float
    code values with none, for the host to quantise."""
    cfg = RenderConfig(dither=dither, out_depth=depth)
    k = px.pack_constants(cfg)
    rgb = tuple(torch.rand(1, 4, 8) for _ in range(3))
    p, out, _keep = px.pack_args(*rgb, cfg)
    assert (k["format"], k["dither"], out[0].dtype) == want
    assert p.format == want[0] and all(t.dtype == want[2] for t in out)


@pytest.mark.parametrize("name", sorted(GRID))
def test_plain_halves_compose_to_render_planes(name):
    """unpack, the LUT step, pack: render_planes bit for bit on the CPU,
    where render_plain is render_planes itself."""
    cfg, frames = _grid_inputs(name)
    y, u, v = to_torch(*frames)
    want = px.render_planes(y, u, v, cfg, _swap)
    got = px.pack_planes(*_swap(*px.unpack_planes(y, u, v, cfg)), cfg)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e), name
    for a, e in zip(px.render_plain(y, u, v, cfg, _swap), want):
        assert torch.equal(a, e)


def test_counters_stay_at_zero_on_the_cpu():
    """Plain-layout renders on the CPU (a resize, no LUT, error
    diffusion, bilinear siting) launch nothing and count nothing."""
    before = px.launches
    lut = random_lut(5, seed=2)
    y, u, v = to_torch(*planes(3, 2, 16, 32, 8))
    for cfg in (RenderConfig(resize=(16, 8)), RenderConfig(apply_lut=False),
                RenderConfig(dither="error_diffusion_host"),
                RenderConfig(chroma_up="bilinear", dither="ordered")):
        make_render_fn(lut, cfg, "cpu")(y, u, v)
    assert px.launches == before


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "float*": ctypes.c_void_p, "const float*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("struct,mirror", [
    ("PixelUnpackParams", px._UnpackParams),
    ("PixelPackParams", px._PackParams),
])
def test_ctypes_mirror_matches_the_c_struct(struct, mirror):
    src = (_build.CSRC / "pixel.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    want = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            m = re.fullmatch(r"(.+?)\s*(\w+);", line)
            want.append((m.group(2), _CTYPES[m.group(1).replace(" *", "*")]))
    assert mirror._fields_ == want


def test_kernels_are_in_the_render_library_under_their_own_names():
    """Both entries build into the render library; the kernels' symbols
    carry none of the tokens by which the benchmark reads kernels A, B and
    C and the resample, so its pixel_ops_ms counts them."""
    assert "pixel.cu" in _build.SOURCES
    assert {"pixel_unpack_launch", "pixel_pack_launch"} <= set(
        _build.ENTRY_POINTS)
    src = (_build.CSRC / "pixel.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                         src)
    assert kernels == ["pixel_unpack_kernel", "pixel_pack_kernel"]
    structs = re.findall(r"struct (\w+) \{", src)
    for name in kernels + structs:
        low = name.lower()
        assert not any(t in low for t in ("planar_kernel", "fused420_kernel",
                                          "gemm", "xmma", "cutlass",
                                          "splitk", "lut3dparams",
                                          "coarse2params")), name


@pytest.mark.parametrize("kw", [
    dict(), dict(in_depth=10, in_full_range=True),
    dict(in_depth=10, out_depth=8, work_full_range=True, out_full_range=True,
         matrix_in="bt601", matrix_out="bt2020nc"),
    dict(in_full_range=True, requantize_intermediate=False),
])
def test_constants_agree_with_kernel_b(kw):
    """Every constant the two kernels share with kernel B has kernel B's
    value (both from the same double expressions), after the f32 rounding
    of the params."""
    cfg = RenderConfig(**kw)
    kb = fused420.kernel_constants(cfg)
    up, pk = px.unpack_constants(cfg), px.pack_constants(cfg)
    shared = {"norm_ysub": "norm_ysub", "norm_ymul": "norm_ymul",
              "norm_yadd": "norm_yadd", "norm_cmid": "norm_cmid",
              "norm_cmul": "norm_cmul", "maxv_in": "maxv_in",
              "yoff": "in_yoff", "yscale": "in_yscale", "cmid": "in_cmid",
              "cscale": "in_cscale", "crv": "in_crv", "cbu": "in_cbu",
              "gv": "in_gv", "gu": "in_gu", "normalize": "normalize"}
    for mine, theirs in shared.items():
        assert up[mine] == kb[theirs], mine
    assert up["requant"] == (kb["normalize"] and kb["requant"])
    for mine in ("kr", "kg", "kb", "crv", "cbu", "yoff", "yscale", "cmid",
                 "cscale"):
        assert pk[mine] == kb["out_" + mine], mine
    assert pk["maxv"] == kb["maxv_out"] and pk["dither"] == kb["dither"]
    p, _, _ = px.unpack_args(*to_torch(*planes(1, 1, 4, 8, cfg.in_depth)),
                             cfg)
    assert p.gv == np.float32(kb["in_gv"]) and p.sx == p.sy == 1


@pytest.mark.parametrize("kw,shape,depth,in_sub,out", [
    (dict(), (2, 18, 70), 8, "420", ((2, 18, 70), (2, 9, 35))),
    (dict(in_depth=10, in_subsampling="422", out_subsampling="422",
          out_depth=10), (3, 4, 8), 10, "422", ((3, 4, 8), (3, 4, 4))),
    (dict(in_subsampling="444", out_subsampling="444", dither="ordered"),
     (5, 7), 8, "444", ((5, 7), (5, 7))),
])
def test_launch_args_on_cpu_planes(kw, shape, depth, in_sub, out):
    """The params the wrappers would launch with, built on CPU tensors:
    units (chroma sites), sizes, sample widths, the outputs' shapes and
    dtypes, and the Bayer pointer only for the ordered dither."""
    cfg = RenderConfig(**kw)
    b, h, w = (0,) * (3 - len(shape)) + tuple(shape)
    frames = planes(4, b, h, w, depth, in_sub)
    y, u, v = to_torch(*frames)
    p, rgb, keep = px.unpack_args(y, u, v, cfg)
    sites = max(b, 1) * u.shape[-2] * u.shape[-1]
    assert (p.units, p.height, p.width, p.in16) == (sites, h, w,
                                                    int(depth > 8))
    assert all(t.shape == y.shape and t.dtype == torch.float32 for t in rgb)
    assert [p.r, p.g, p.b] == [t.data_ptr() for t in rgb]
    q, yuv, keep = px.pack_args(*rgb, cfg)
    assert tuple(yuv[0].shape) == out[0] and tuple(yuv[1].shape) == out[1]
    assert tuple(yuv[2].shape) == out[1]
    assert q.units == max(b, 1) * out[1][-2] * out[1][-1]
    want_dt = torch.uint16 if cfg.out_depth > 8 else torch.uint8
    assert all(t.dtype == want_dt for t in yuv)
    assert q.format == int(cfg.out_depth > 8)
    assert (q.bayer is not None) == (cfg.dither == "ordered")


def test_launch_args_refuse_what_the_kernels_cannot_take():
    y, u, v = to_torch(*planes(5, 1, 8, 16, 8))
    rgb = px.unpack_planes(y, u, v, RenderConfig())
    bad_cfgs = [dict(in_subsampling="411"), dict(chroma_up="lanczos"),
                dict(in_depth=7), dict(in_depth=17)]
    for kw in bad_cfgs:
        with pytest.raises(ValueError):
            px.unpack_args(y, u, v, RenderConfig(**kw))
    for bad in (u[..., :4], u.to(torch.uint16), u[0]):
        with pytest.raises(ValueError, match="chroma planes"):
            px.unpack_args(y, bad, v, RenderConfig())
    with pytest.raises(ValueError, match="uint8/uint16"):
        px.unpack_args(y.to(torch.int32), u, v, RenderConfig())
    with pytest.raises(ValueError, match="whole chroma sites"):
        px.unpack_args(y[..., :7, :], u, v, RenderConfig())
    for kw in (dict(out_subsampling="440"), dict(dither="blue_noise"),
               dict(out_depth=20)):
        with pytest.raises(ValueError):
            px.pack_args(*rgb, RenderConfig(**kw))
    with pytest.raises(ValueError, match="one shape"):
        px.pack_args(rgb[0], rgb[1][..., :8], rgb[2], RenderConfig())
    with pytest.raises(ValueError, match="float32"):
        px.pack_args(rgb[0].double(), *rgb[1:], RenderConfig())
    with pytest.raises(ValueError, match="whole chroma sites"):
        px.pack_args(*(t[..., :15] for t in rgb), RenderConfig())
    ordered = RenderConfig(dither="ordered")
    with pytest.raises(ValueError, match="Bayer"):
        px.pack_args(*rgb, ordered, torch.zeros(16, 16, dtype=torch.float64))


# ---- on the card -------------------------------------------------------------

def _launched(fn):
    """fn()'s result and the pixel kernels' launches it made."""
    before = px.launches
    out = fn()
    torch.cuda.synchronize()
    return out, px.launches - before


@cuda
@pytest.mark.parametrize("name", sorted(GRID))
def test_kernel_path_bit_equal_to_render_planes(cuda_device, name):
    """render_plain on the card (unpack, the LUT step, pack: 2 launches)
    against render_planes on the card and on the CPU, bit for bit."""
    cfg, frames = _grid_inputs(name)
    dev = to_torch(*frames, device=cuda_device)
    got, n = _launched(lambda: px.render_plain(*dev, cfg, _swap))
    assert n == 2
    want = px.render_planes(*dev, cfg, _swap)
    cpu = px.render_planes(*to_torch(*frames), cfg, _swap)
    for a, e, c in zip(got, want, cpu):
        assert a.dtype == e.dtype and a.shape == e.shape, name
        assert torch.equal(a, e), name
        assert torch.equal(a.cpu(), c), name


@cuda
@pytest.mark.parametrize("depth,sub", [(8, "420"), (10, "422"), (12, "444"),
                                       (16, "420")])
def test_unpack_kernel_bit_equal_to_plain(cuda_device, depth, sub):
    cfg = RenderConfig(in_depth=depth, in_subsampling=sub,
                       in_full_range=True, chroma_up="bilinear")
    frames = planes(23, 2, 18, 70, depth, sub)
    got, n = _launched(lambda: px.unpack_planes(
        *to_torch(*frames, device=cuda_device), cfg))
    assert n == 1
    want = px.unpack_planes_reference(*to_torch(*frames), cfg)
    for a, e in zip(got, want):
        assert torch.equal(a.cpu(), e)


@cuda
def test_planes_off_alignment_and_empty_batches(cuda_device):
    """Integer planes one sample off their allocation and float planes one
    element off; an empty batch launches nothing."""
    cfg = RenderConfig(dither="random")
    frames = planes(29, 2, 18, 70, 8)

    def off(a):
        flat = torch.empty(a.size + 1, dtype=torch.uint8, device=cuda_device)
        flat[1:] = torch.from_numpy(a).flatten().to(cuda_device)
        return flat[1:].view(a.shape)

    got = px.unpack_planes(*(off(a) for a in frames), cfg)
    want = px.unpack_planes_reference(*to_torch(*frames), cfg)
    assert all(torch.equal(a.cpu(), e) for a, e in zip(got, want))
    shifted = []
    for t in got:
        flat = torch.empty(t.numel() + 1, device=cuda_device)
        flat[1:] = t.flatten()
        shifted.append(flat[1:].view(t.shape))
    packed = px.pack_planes(*shifted, cfg)
    assert all(torch.equal(a.cpu(), e) for a, e in zip(
        packed, px.pack_planes_reference(*want, cfg)))
    empty = to_torch(*planes(1, 1, 0, 70, 8), device=cuda_device)
    (out, n) = _launched(lambda: px.render_plain(*empty, cfg))
    assert n == 0 and out[0].shape == (1, 0, 70)


@cuda
def test_error_diffusion_packs_float_planes_on_the_kernel(cuda_device):
    """An error-diffusion job runs both kernels and returns render_planes'
    float code values, unquantised, for the host to quantise."""
    cfg = RenderConfig(dither="error_diffusion_host", phase_layout="plain")
    frames = planes(37, 2, 18, 70, 8)
    got, n = _launched(lambda: px.render_plain(
        *to_torch(*frames, device=cuda_device), cfg, _swap))
    assert n == 2
    want = px.render_planes(*to_torch(*frames), cfg, _swap)
    for a, e in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a.cpu(), e)
    assert got[1].shape == (2, 9, 35)


@cuda
def test_to1080_render_call_does_not_sync_in_ops_pixel(cuda_device):
    """uhd8_c33.to1080's config (4K 420p8 -> 1920x1080, a 33^3 look) twice:
    the second call, with its bands built, runs under the sync debug mode
    "error" without a host sync, and both calls launch the two kernels."""
    cfg = replace(RenderConfig(), resize=(1920, 1080))
    fn = make_render_fn(random_lut(33, seed=4), cfg, cuda_device)
    dev = to_torch(*planes(41, 2, 2160, 3840, 8), device=cuda_device)
    first, n = _launched(lambda: fn(*dev))
    assert n == 2
    mode = torch.cuda.get_sync_debug_mode()
    a_before = lut3d.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = fn(*dev)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert lut3d.launches == a_before + 1
    assert [t.shape for t in second] == [(2, 1080, 1920), (2, 540, 960),
                                         (2, 540, 960)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@cuda
def test_entry_points_refuse_what_they_cannot_take(cuda_device):
    y, u, v = to_torch(*planes(3, 1, 8, 16, 8), device=cuda_device)
    p, _rgb, _keep = px.unpack_args(y, u, v, RenderConfig())
    p.sx = 2
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("pixel_unpack_launch", p, cuda_device)
    rgb = px.unpack_planes(y, u, v, RenderConfig())
    q, _yuv, _keep = px.pack_args(*rgb, RenderConfig(dither="ordered"))
    q.bayer = None
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("pixel_pack_launch", q, cuda_device)
    q, _yuv, _keep = px.pack_args(*rgb, RenderConfig(dither="random"))
    q.format = 2  # float planes take no dither
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("pixel_pack_launch", q, cuda_device)
    with pytest.raises(ValueError, match="chroma planes"):
        px.unpack_planes(y, u.cpu(), v, RenderConfig())
