"""Planar pixel ops around the LUT step, in PyTorch: range normalisation,
chroma resampling, YUV<->RGB and dithered quantisation.

Counterpart of lut_renderer_tpu/ops/pixel.py, op for op, so that float
results round the same way and integer planes come out bit-equal. The
matrix math is colorcore.matrices itself, called with ``xp=torch``.

These run as plain tensor ops on either device: they are the glue the JAX
package leaves to XLA. The fused kernel (ops.fused420) does the same work
in one pass on the main path.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..colorcore import matrices as cm
from ..colorcore.dither import bayer_offsets

_U32 = 0xFFFFFFFF


def yuv_planes_to_rgb(y, u, v, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    """YUV code-value planes (co-sited, full resolution) -> RGB in [0, 1]."""
    return cm.yuv_to_rgb_planes(y, u, v, matrix, depth, full_range, xp=torch)


def rgb_to_yuv_planes(r, g, b, matrix: str = "bt709", depth: int = 8,
                      full_range: bool = False):
    return cm.rgb_to_yuv_planes(r, g, b, matrix, depth, full_range, xp=torch)


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


def render_planes(y, u, v, cfg, lut_fn: LutFn = None):
    """The plain layout of ops/render.render_yuv_frame (JAX), without
    resize: integer planes -> normalise -> 4:4:4 -> RGB -> `lut_fn` ->
    YUV -> chroma downsample -> quantise. `lut_fn` None skips the LUT.

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
    yo, uo, vo = rgb_to_yuv_planes(r, g, b, cfg.matrix_out, cfg.out_depth,
                                   cfg.out_full_range)
    uo, vo = _downsample(uo, vo, cfg.out_subsampling)
    if cfg.dither == "error_diffusion_host":
        return yo, uo, vo
    # distinct plane seeds decorrelate the "random" dither across Y/U/V
    return (quantize_plane(yo, cfg.out_depth, cfg.dither, plane_seed=1),
            quantize_plane(uo, cfg.out_depth, cfg.dither, plane_seed=2),
            quantize_plane(vo, cfg.out_depth, cfg.dither, plane_seed=3))
