"""The least time the card could take for a kernel's work, from shapes.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``,
``FLOPS_PER_PX``, ``bound``, and phase 6's banded count of the resample),
so that a later change to the program cannot move the yardstick. A share
of the roofline is ``bound / measured time``; it is reported against these
published peaks with the card's power limit beside it.

Each input byte and each output byte is counted once. The LUT counts as its
N^3 x 3 float32 entries (``chip_smoke.table_bytes`` counted the program's
table as stored, padded to four channels). The resample counts the banded
taps of its weights (their non-zeros), so its share reads the same work
whatever implements it.
"""

from __future__ import annotations

import numpy as np

from .frames import chroma_shape

# NVIDIA H100 SXM peaks (data sheet, 700 W): device memory and f32 outside
# the tensor cores. (chip_smoke.py)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per pixel, counted from the sources (a division, a
# min/max and a floor count one each): the domain mapping 8 per channel,
# the tetrahedral sum 25; kernel C adds the corner weights (4), the
# per-axis remap (36), the 8-corner coarse sum (48) and the residual's
# dequantisation (12); kernel B adds YUV->RGB (20), RGB->YUV (15) and the
# quantise/downsample (8) per luma pixel. (chip_smoke.py)
FLOPS_PER_PX = {"A": 60, "C": 160, "B": 103, "B coarse2": 203}


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the two floors.
    (chip_smoke.bound)"""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lut_bytes(n: int) -> int:
    """The LUT's own entries: N^3 RGB float32 triples."""
    return n ** 3 * 3 * 4


def yuv_bytes(frames: int, h: int, w: int, depth: int, sub: str) -> int:
    """Bytes of `frames` integer YUV frames (uint8, or uint16 above 8 bits)."""
    hc, wc = chroma_shape(h, w, sub)
    per = 1 if depth <= 8 else 2
    return frames * per * (h * w + 2 * hc * wc)


def kernel_b_bound(frames: int, h: int, w: int, pipe: dict, n: int):
    """Kernel B (YUV -> YUV in one pass) on `frames` (h, w) frames: the
    integer planes in and out once, the LUT once; FLOPS_PER_PX["B"] per
    luma pixel."""
    nbytes = (yuv_bytes(frames, h, w, pipe["in_depth"], pipe["in_subsampling"])
              + yuv_bytes(frames, h, w, pipe["out_depth"],
                          pipe["out_subsampling"]) + lut_bytes(n))
    return bound(nbytes, FLOPS_PER_PX["B"] * frames * h * w)


def kernel_a_bound(frames: int, h: int, w: int, n: int):
    """Kernel A (LUT on planar f32 RGB) on `frames` (h, w) frames: three f32
    planes in and three out, the LUT once; FLOPS_PER_PX["A"] a pixel."""
    px = frames * h * w
    return bound(24 * px + lut_bytes(n), FLOPS_PER_PX["A"] * px)


def resample_banded_flops(wv: np.ndarray, wh: np.ndarray, frames: int,
                          planes: int = 3) -> int:
    """Operations of ``Wv @ x @ Wh^T`` counted by the weights' non-zero
    taps: the vertical pass (out_h x h by h x w) then the horizontal one
    (out_h x w by w x out_w), a multiply and an add a tap.
    (chip_smoke.py phase 6)"""
    w = wh.shape[1]
    oh = wv.shape[0]
    return planes * frames * 2 * (int(np.count_nonzero(wv)) * w
                                  + int(np.count_nonzero(wh)) * oh)


def resample_bound(wv: np.ndarray, wh: np.ndarray, frames: int,
                   planes: int = 3):
    """The resample of `frames` frames of `planes` f32 planes: each plane
    in and out once, and its banded operations."""
    (oh, h), (ow, w) = wv.shape, wh.shape
    nbytes = planes * frames * 4 * (h * w + oh * ow)
    return bound(nbytes, resample_banded_flops(wv, wh, frames, planes))
