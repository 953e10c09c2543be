"""Planar pixel ops around the LUT step, in PyTorch: range normalisation,
chroma resampling, YUV<->RGB and dithered quantisation.

Counterpart of lut_renderer_tpu/ops/pixel.py, op for op, so that float
results round the same way and integer planes come out bit-equal. The
matrix math is colorcore.matrices' formulas op for op, each division by a
constant through ``fdiv``, so that the card rounds as the CPU and NumPy do.

These are the glue the JAX package leaves to XLA. ``render_planes`` runs
them as plain tensor ops on either device: the CPU's plain layout, and the
value contract of the kernels that do the same work. The fused kernel
(ops.fused420) does it in one pass on the main path; on a CUDA device the
plain layout (``render_plain``) runs it as two hand-written kernels
(csrc/pixel.cu) around the LUT step and the resample:

* the unpack, ``unpack_planes``: integer planes -> planar f32 RGB at the
  luma size, render_planes' steps before its LUT call;
* the pack, ``pack_planes``: planar f32 RGB -> the output planes, its
  steps after the resample (integer planes, or an error-diffusion job's
  float code values).

Each is one launch whose constants travel in a ctypes params struct, so
the render call enqueues its work without waiting for the card, and each
equals its plain version (``unpack_planes_reference``,
``pack_planes_reference``) bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Callable, Tuple

import numpy as np
import torch

from ..colorcore import matrices as cm
from ..colorcore.dither import bayer_offsets

from . import _build

_U32 = 0xFFFFFFFF

# launches of the unpack and pack kernels by the plain layout on CUDA
# tensors, 2 a batch (reset by callers that check which path ran)
launches = 0


def fdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once in f32, as NumPy divides an f32 array by a Python
    float, on every device. The divisor is a tensor on x's device: PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal instead,
    which moves a value on a rounding tie by an ulp (a 10-bit plane that
    goes to 8 bits lands on k + 0.5 for a quarter of its codes)."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def yuv_planes_to_rgb(y, u, v, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    """YUV code-value planes (co-sited, full resolution) -> RGB in [0, 1]:
    colorcore.matrices.yuv_to_rgb_planes op for op, dividing through
    fdiv."""
    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(matrix)
    y_off, y_scale, c_mid, c_scale = cm._range_params(depth, full_range)
    yn = fdiv(y - y_off, y_scale)
    un = fdiv(u - c_mid, c_scale)
    vn = fdiv(v - c_mid, c_scale)
    r = yn + crv * vn
    b = yn + cbu * un
    g = yn - (kr * crv / kg) * vn - (kb * cbu / kg) * un
    return (torch.clip(r, 0.0, 1.0), torch.clip(g, 0.0, 1.0),
            torch.clip(b, 0.0, 1.0))


def rgb_to_yuv_planes(r, g, b, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    """colorcore.matrices.rgb_to_yuv_planes op for op, dividing through
    fdiv: float code values, unquantised."""
    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(matrix)
    y_off, y_scale, c_mid, c_scale = cm._range_params(depth, full_range)
    yn = kr * r + kg * g + kb * b
    vn = fdiv(r - yn, crv)
    un = fdiv(b - yn, cbu)
    return yn * y_scale + y_off, un * c_scale + c_mid, vn * c_scale + c_mid


def range_normalize(y, u, v, depth: int, in_full: bool, out_full: bool):
    if in_full == out_full:
        return y, u, v
    shift = float(1 << (depth - 8))
    c_mid = float(1 << (depth - 1))
    if in_full and not out_full:
        return (
            y * (219.0 / 255.0) + 16.0 * shift,
            (u - c_mid) * (224.0 / 255.0) + c_mid,
            (v - c_mid) * (224.0 / 255.0) + c_mid,
        )
    return (
        (y - 16.0 * shift) * (255.0 / 219.0),
        (u - c_mid) * (255.0 / 224.0) + c_mid,
        (v - c_mid) * (255.0 / 224.0) + c_mid,
    )


def chroma_upsample_420(c, mode: str = "nearest"):
    """(.., H/2, W/2) chroma -> (.., H, W): 2x2 replication, or the
    centre-sited neighbour mix of the JAX package for "bilinear"."""
    up = c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    if mode == "nearest":
        return up
    if mode == "bilinear":
        # edge padding of the two trailing axes
        p = torch.cat([up[..., :1, :], up, up[..., -1:, :]], dim=-2)
        p = torch.cat([p[..., :, :1], p, p[..., :, -1:]], dim=-1)
        return (
            up * 0.5
            + 0.125 * (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
                       + p[..., 1:-1, :-2] + p[..., 1:-1, 2:])
        )
    raise ValueError(f"unknown chroma upsample mode {mode!r}")


def chroma_downsample_420(c):
    """(.., H, W) -> (.., H/2, W/2) by the 2x2 mean, column pairs first."""
    a = c[..., :, 0::2] + c[..., :, 1::2]
    return (a[..., 0::2, :] + a[..., 1::2, :]) * 0.25


def chroma_resample_422_to_444(c):
    return c.repeat_interleave(2, dim=-1)


def chroma_downsample_422(c):
    return (c[..., :, 0::2] + c[..., :, 1::2]) * 0.5


def hash_noise_offsets(h: int, w: int, plane_seed: int = 0,
                       row_stride: int = 1, row_offset: int = 0,
                       device=None) -> torch.Tensor:
    """(h, w) zero-mean offsets in (-0.5, 0.5): the murmur3-finalizer
    position hash of colorcore.dither.hash_noise_offsets, bit for bit.

    uint32 wraparound is done in int64 masked to 32 bits. A product of two
    32-bit values can pass 2**63 and wrap in int64; its low 32 bits, which
    the mask keeps, are still those of the uint32 product."""
    rows = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    rows = rows * row_stride + row_offset
    cols = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    x = (((rows * 0x9E3779B1) & _U32) ^ ((cols * 0x85EBCA77) & _U32)
         ^ ((plane_seed * 0xC2B2AE3D) & _U32))
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (2.0 ** -24) - 0.5


def ordered_offsets(h: int, w: int, row_stride: int = 1, row_offset: int = 0,
                    device=None) -> torch.Tensor:
    """(h, w) tiled 16x16 Bayer offsets; plane row r sits at absolute row
    r*row_stride + row_offset."""
    pat = bayer_offsets(4)
    if row_stride != 1 or row_offset:
        if pat.shape[0] % row_stride or not 0 <= row_offset < row_stride:
            raise ValueError(
                f"row_stride {row_stride} must divide the {pat.shape[0]}-row "
                f"dither tile (offset < stride)")
        pat = pat[row_offset::row_stride]
    th, tw = pat.shape
    tiled = torch.from_numpy(pat).repeat(-(-h // th), -(-w // tw))
    return tiled[:h, :w].to(device)


def quantize_plane(x, depth: int, dither: str = "none", plane_seed: int = 0,
                   row_stride: int = 1, row_offset: int = 0):
    """Float code values -> integer plane at `depth` bits (uint8, or uint16
    above 8 bits): round half up after the dither offset.

    The rounding runs in float32 and the cast goes through int32, since
    PyTorch supports few ops on uint16."""
    maxv = (1 << depth) - 1
    h, w = x.shape[-2], x.shape[-1]
    if dither == "ordered":
        x = x + ordered_offsets(h, w, row_stride, row_offset, x.device)
    elif dither == "random":
        x = x + hash_noise_offsets(h, w, plane_seed, row_stride, row_offset,
                                   x.device)
    out = torch.clip(torch.floor(x + 0.5), 0, maxv).to(torch.int32)
    return out.to(torch.uint8 if depth <= 8 else torch.uint16)


def _upsample(u, v, subsampling: str, mode: str):
    if subsampling == "420":
        return chroma_upsample_420(u, mode), chroma_upsample_420(v, mode)
    if subsampling == "422":
        return chroma_resample_422_to_444(u), chroma_resample_422_to_444(v)
    return u, v


def _downsample(u, v, subsampling: str):
    if subsampling == "420":
        return chroma_downsample_420(u), chroma_downsample_420(v)
    if subsampling == "422":
        return chroma_downsample_422(u), chroma_downsample_422(v)
    return u, v


LutFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def render_planes(y, u, v, cfg, lut_fn: LutFn = None,
                  resize_fn: LutFn = None):
    """The plain layout of ops/render.render_yuv_frame (JAX): integer
    planes -> normalise -> 4:4:4 -> RGB -> `lut_fn` -> `resize_fn` -> YUV
    -> chroma downsample -> quantise. `lut_fn` None skips the LUT,
    `resize_fn` None keeps the size (the JAX package resamples the RGB
    planes between the LUT and RGB->YUV).

    With ``cfg.dither == "error_diffusion_host"`` the float planes return
    unquantised; the executor finishes them on the host."""
    yf, uf, vf = (t.to(torch.float32) for t in (y, u, v))
    yf, uf, vf = range_normalize(yf, uf, vf, cfg.in_depth, cfg.in_full_range,
                                 cfg.work_full_range)
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf, uf, vf = (torch.clip(torch.floor(t + 0.5), 0, maxv)
                      for t in (yf, uf, vf))
    uf, vf = _upsample(uf, vf, cfg.in_subsampling, cfg.chroma_up)
    r, g, b = yuv_planes_to_rgb(yf, uf, vf, cfg.matrix_in, cfg.in_depth,
                                cfg.work_full_range)
    if lut_fn is not None:
        r, g, b = lut_fn(r, g, b)
    if resize_fn is not None:
        r, g, b = resize_fn(r, g, b)
    yo, uo, vo = rgb_to_yuv_planes(r, g, b, cfg.matrix_out, cfg.out_depth,
                                   cfg.out_full_range)
    uo, vo = _downsample(uo, vo, cfg.out_subsampling)
    if cfg.dither == "error_diffusion_host":
        return yo, uo, vo
    # distinct plane seeds decorrelate the "random" dither across Y/U/V
    return (quantize_plane(yo, cfg.out_depth, cfg.dither, plane_seed=1),
            quantize_plane(uo, cfg.out_depth, cfg.dither, plane_seed=2),
            quantize_plane(vo, cfg.out_depth, cfg.dither, plane_seed=3))


# ---------------------------------------------------------------------------
# the two kernels of the plain layout on a CUDA device (csrc/pixel.cu)
# ---------------------------------------------------------------------------

_SHIFTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}  # (x, y)
# cfg.dither -> the pack's dither; error diffusion runs on the host
_DITHERS = {"none": 0, "ordered": 1, "random": 2, "error_diffusion_host": 0}
# the pack's output planes: uint8, uint16, or float32 code values
# unquantised (an error-diffusion job's, which the host quantises)
_FORMATS = (torch.uint8, torch.uint16, torch.float32)
_MAX_PIXELS = (1 << 31) - 1  # the kernels index in int32


def unpack_planes_reference(y, u, v, cfg):
    """Plain version of the unpack kernel, on any device: render_planes'
    steps before its LUT call."""
    yf, uf, vf = (t.to(torch.float32) for t in (y, u, v))
    yf, uf, vf = range_normalize(yf, uf, vf, cfg.in_depth, cfg.in_full_range,
                                 cfg.work_full_range)
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf, uf, vf = (torch.clip(torch.floor(t + 0.5), 0, maxv)
                      for t in (yf, uf, vf))
    uf, vf = _upsample(uf, vf, cfg.in_subsampling, cfg.chroma_up)
    return yuv_planes_to_rgb(yf, uf, vf, cfg.matrix_in, cfg.in_depth,
                             cfg.work_full_range)


def pack_planes_reference(r, g, b, cfg):
    """Plain version of the pack kernel, on any device: render_planes'
    steps after its resample."""
    yo, uo, vo = rgb_to_yuv_planes(r, g, b, cfg.matrix_out, cfg.out_depth,
                                   cfg.out_full_range)
    uo, vo = _downsample(uo, vo, cfg.out_subsampling)
    if cfg.dither == "error_diffusion_host":
        return yo, uo, vo
    return tuple(quantize_plane(p, cfg.out_depth, cfg.dither, plane_seed=seed)
                 for seed, p in ((1, yo), (2, uo), (3, vo)))


class _UnpackParams(ctypes.Structure):
    """Mirror of PixelUnpackParams in csrc/pixel.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("y", "u", "v", "r", "g", "b")]
        + [(name, ctypes.c_int) for name in
           ("units", "height", "width", "in16", "sx", "sy", "bilinear",
            "normalize", "requant")]
        + [(name, ctypes.c_float) for name in
           ("norm_ysub", "norm_ymul", "norm_yadd", "norm_cmid", "norm_cmul",
            "maxv_in", "yoff", "yscale", "cmid", "cscale", "crv", "cbu", "gv",
            "gu")]
    )


class _PackParams(ctypes.Structure):
    """Mirror of PixelPackParams in csrc/pixel.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in
         ("r", "g", "b", "y", "u", "v", "bayer")]
        + [(name, ctypes.c_int) for name in
           ("units", "height", "width", "format", "sx", "sy", "dither")]
        + [(name, ctypes.c_float) for name in
           ("kr", "kg", "kb", "crv", "cbu", "yoff", "yscale", "cmid",
            "cscale", "maxv")]
    )


def _shifts(subsampling: str) -> Tuple[int, int]:
    if subsampling not in _SHIFTS:
        raise ValueError(f"the pixel kernels take {sorted(_SHIFTS)} chroma, "
                         f"got {subsampling!r}")
    return _SHIFTS[subsampling]


def _check_depth(depth: int) -> None:
    if not 8 <= depth <= 16:
        raise ValueError(f"the pixel kernels take 8 to 16 bits, got {depth}")


@functools.lru_cache(maxsize=64)
def unpack_constants(cfg) -> types.MappingProxyType:
    """The unpack kernel's per-config fields, computed in double as
    render_planes computes its Python scalars (ctypes rounds each to f32
    once, as PyTorch rounds a scalar operand). Read-only: the cache hands
    the same mapping to every caller. Raises on a config the kernel does
    not take."""
    sx, sy = _shifts(cfg.in_subsampling)
    if cfg.in_subsampling == "420" and cfg.chroma_up not in ("nearest",
                                                             "bilinear"):
        raise ValueError(f"unknown chroma upsample mode {cfg.chroma_up!r}")
    _check_depth(cfg.in_depth)
    normalize = cfg.in_full_range != cfg.work_full_range
    shift = float(1 << (cfg.in_depth - 8))
    c_mid = float(1 << (cfg.in_depth - 1))
    if cfg.in_full_range and not cfg.work_full_range:
        ysub, ymul, yadd, cmul = 0.0, 219.0 / 255.0, 16.0 * shift, 224.0 / 255.0
    else:
        ysub, ymul, yadd, cmul = 16.0 * shift, 255.0 / 219.0, 0.0, 255.0 / 224.0
    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(cfg.matrix_in)
    yoff, yscale, cmid, cscale = cm._range_params(cfg.in_depth,
                                                  cfg.work_full_range)
    return types.MappingProxyType(dict(
        sx=sx, sy=sy,
        bilinear=int(cfg.in_subsampling == "420"
                     and cfg.chroma_up == "bilinear"),
        normalize=int(normalize),
        requant=int(normalize and bool(cfg.requantize_intermediate)),
        norm_ysub=ysub, norm_ymul=ymul, norm_yadd=yadd, norm_cmid=c_mid,
        norm_cmul=cmul, maxv_in=float((1 << cfg.in_depth) - 1),
        yoff=yoff, yscale=yscale, cmid=cmid, cscale=cscale, crv=crv, cbu=cbu,
        gv=kr * crv / kg, gu=kb * cbu / kg))


@functools.lru_cache(maxsize=64)
def pack_constants(cfg) -> types.MappingProxyType:
    """The pack kernel's per-config fields, as unpack_constants: an
    error-diffusion job writes float32 planes (``format`` 2) and no dither.
    Raises on a config the kernel does not take."""
    sx, sy = _shifts(cfg.out_subsampling)
    if cfg.dither not in _DITHERS:
        raise ValueError(f"the pack kernel takes dither {sorted(_DITHERS)}, "
                         f"got {cfg.dither!r}")
    _check_depth(cfg.out_depth)
    fmt = 2 if cfg.dither == "error_diffusion_host" else int(cfg.out_depth > 8)
    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(cfg.matrix_out)
    yoff, yscale, cmid, cscale = cm._range_params(cfg.out_depth,
                                                  cfg.out_full_range)
    return types.MappingProxyType(dict(
        format=fmt, sx=sx, sy=sy, dither=_DITHERS[cfg.dither], kr=kr, kg=kg,
        kb=kb, crv=crv, cbu=cbu, yoff=yoff, yscale=yscale, cmid=cmid,
        cscale=cscale, maxv=float((1 << cfg.out_depth) - 1)))


def _frames(shape, what: str) -> int:
    """Frames of a (..., H, W) stack; raises at 2^31 pixels or more."""
    frames = int(np.prod(shape[:-2], dtype=np.int64))
    if frames * shape[-2] * shape[-1] > _MAX_PIXELS:
        raise ValueError(f"the {what} kernel takes at most {_MAX_PIXELS} "
                         f"pixels a launch (int32 indices), got "
                         f"{tuple(shape)}; split the batch")
    return frames


def _site_shape(shape, sx: int, sy: int, what: str):
    """(..., H >> sy, W >> sx) for planes of `shape`, which must cover
    whole chroma sites."""
    if len(shape) < 2:
        raise ValueError(f"the {what} kernel takes (..., H, W) planes, got "
                         f"{tuple(shape)}")
    h, w = shape[-2:]
    if h % (1 << sy) or w % (1 << sx):
        raise ValueError(f"the {what} kernel takes {h}x{w} planes only in "
                         f"whole chroma sites of {1 << sy}x{1 << sx}")
    return tuple(shape[:-2]) + (h >> sy, w >> sx)


def unpack_args(y, u, v, cfg):
    """Check the integer planes for the unpack kernel and allocate its RGB
    planes: (params, (r, g, b), keep). ``keep`` holds every tensor the
    params point to; it must outlive the launch."""
    k = unpack_constants(cfg)
    if y.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"the unpack kernel takes uint8/uint16 planes, got "
                         f"{y.dtype}")
    chroma = _site_shape(y.shape, k["sx"], k["sy"], "unpack")
    for t in (u, v):
        if t.device != y.device or t.dtype != y.dtype \
                or tuple(t.shape) != chroma:
            raise ValueError(f"the unpack kernel takes {cfg.in_subsampling} "
                             f"chroma planes of {chroma} {y.dtype} on "
                             f"{y.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    frames = _frames(y.shape, "unpack")
    y, u, v = (t.contiguous() for t in (y, u, v))
    r, g, b = (torch.empty(y.shape, dtype=torch.float32, device=y.device)
               for _ in range(3))
    h, w = y.shape[-2:]
    p = _UnpackParams(
        y=y.data_ptr(), u=u.data_ptr(), v=v.data_ptr(), r=r.data_ptr(),
        g=g.data_ptr(), b=b.data_ptr(),
        units=frames * chroma[-2] * chroma[-1], height=h, width=w,
        in16=int(y.dtype == torch.uint16), **k)
    return p, (r, g, b), (y, u, v)


def pack_args(r, g, b, cfg, bayer=None):
    """Check the RGB planes for the pack kernel and allocate its output
    planes: (params, (y, u, v), keep). ``bayer``: the device's 16x16
    ordered-dither offsets (ops/fused420.bayer_tensor), made here when
    None and the dither is ordered."""
    k = pack_constants(cfg)
    for t in (g, b):
        if t.device != r.device or t.shape != r.shape:
            raise ValueError("the pack kernel takes three planes of one "
                             "shape on one device")
    if any(t.dtype != torch.float32 for t in (r, g, b)):
        raise ValueError("the pack kernel takes float32 planes")
    chroma = _site_shape(r.shape, k["sx"], k["sy"], "pack")
    frames = _frames(r.shape, "pack")
    dev = r.device
    bayer_ptr = None
    if k["dither"] == _DITHERS["ordered"]:
        if bayer is None:
            from .fused420 import bayer_tensor

            bayer = bayer_tensor(dev)
        if bayer.device != dev or bayer.dtype != torch.float32 \
                or tuple(bayer.shape) != (16, 16) \
                or not bayer.is_contiguous():
            raise ValueError(f"the Bayer offsets must be a contiguous "
                             f"float32 (16, 16) tensor on {dev}")
        bayer_ptr = bayer.data_ptr()
    r, g, b = (t.contiguous() for t in (r, g, b))
    out_dt = _FORMATS[k["format"]]
    yo = torch.empty(r.shape, dtype=out_dt, device=dev)
    uo, vo = (torch.empty(chroma, dtype=out_dt, device=dev) for _ in range(2))
    h, w = r.shape[-2:]
    p = _PackParams(
        r=r.data_ptr(), g=g.data_ptr(), b=b.data_ptr(), y=yo.data_ptr(),
        u=uo.data_ptr(), v=vo.data_ptr(), bayer=bayer_ptr,
        units=frames * chroma[-2] * chroma[-1], height=h, width=w, **k)
    return p, (yo, uo, vo), (r, g, b, bayer)


def _launch(entry: str, p, device) -> None:
    global launches
    if p.units:
        _build.launch(entry, p, device)
        launches += 1


def unpack_planes(y, u, v, cfg):
    """Integer (y, u, v) planes at cfg.in_depth with cfg.in_subsampling
    chroma -> (r, g, b) float32 planes at the luma size: the unpack kernel
    on CUDA tensors (raising on what it does not take), the plain version
    on CPU tensors."""
    if y.device.type == "cuda":
        p, out, _keep = unpack_args(y, u, v, cfg)
        _launch("pixel_unpack_launch", p, y.device)
        return out
    if y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    return unpack_planes_reference(y, u, v, cfg)


def pack_planes(r, g, b, cfg, bayer=None):
    """Float32 (r, g, b) planes -> (y, u, v) planes at cfg.out_depth with
    cfg.out_subsampling chroma: integer planes dithered as cfg.dither, or
    an error-diffusion job's float code values. The pack kernel on CUDA
    tensors (``bayer``: the device's ordered-dither offsets; raising on
    what it does not take), the plain version on CPU tensors."""
    if r.device.type == "cuda":
        p, out, _keep = pack_args(r, g, b, cfg, bayer)
        _launch("pixel_pack_launch", p, r.device)
        return out
    if r.device.type != "cpu":
        raise ValueError(f"unsupported device {r.device}")
    return pack_planes_reference(r, g, b, cfg)


def render_plain(y, u, v, cfg, lut_fn: LutFn = None, resize_fn: LutFn = None,
                 bayer=None):
    """The plain layout on the planes' device: render_planes on the CPU;
    on a CUDA device the same function as the unpack kernel, `lut_fn`,
    `resize_fn` and the pack kernel, bit-equal. ``bayer``: the device's
    ordered-dither offsets, for the pack."""
    if y.device.type != "cuda":
        return render_planes(y, u, v, cfg, lut_fn, resize_fn)
    r, g, b = unpack_planes(y, u, v, cfg)
    if lut_fn is not None:
        r, g, b = lut_fn(r, g, b)
    if resize_fn is not None:
        r, g, b = resize_fn(r, g, b)
    return pack_planes(r, g, b, cfg, bayer)
