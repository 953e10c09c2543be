"""Kernel B's trilinear instantiation: its roofline count and its symbol.

The trilinear cell's readers take these beside ``roofline.kernel_b_bound``
and ``readers.is_kernel_b``, whose counts and picks stay as they are: they
hold the tetrahedral cells' yardstick.
"""

from __future__ import annotations

import re

from .roofline import FLOPS_PER_PX, bound, lut_bytes, yuv_bytes

# f32 operations a luma pixel, counted from lut_interp.cuh's trilinear
# branch by roofline.py's rule: in place of the tetrahedral sum (25), seven
# lerps over three channels, each two products and an add (63), and the
# three weights 1 - d (3): 66, so 103 - 25 + 66 = 144
FLOPS_PER_PX_TRILINEAR = FLOPS_PER_PX["B"] - 25 + 7 * 3 * 3 + 3

# kernel B on the exact table as CUPTI names it on the card,
# ``void (anonymous namespace)::fused420_kernel<OSY, OSX, lutk::LutArgs,
# INTERP, STAGE>(Fused420Params)``: its INTERP argument
_KERNEL_B = re.compile(r"fused420_kernel<\d+, \d+, lutk::LutArgs, (\d+), \d+>")
# lutk::kTrilinear (csrc/lut_interp.cuh)
TRILINEAR = 1


def kernel_b_trilinear_bound(frames: int, h: int, w: int, pipe: dict,
                             n: int):
    """(ms, "bytes" or "operations") of kernel B's trilinear instantiation
    on `frames` (h, w) frames: the bytes of ``roofline.kernel_b_bound``
    (the integer planes in and out once, the LUT once) and
    FLOPS_PER_PX_TRILINEAR operations a luma pixel."""
    nbytes = (yuv_bytes(frames, h, w, pipe["in_depth"], pipe["in_subsampling"])
              + yuv_bytes(frames, h, w, pipe["out_depth"],
                          pipe["out_subsampling"]) + lut_bytes(n))
    return bound(nbytes, FLOPS_PER_PX_TRILINEAR * frames * h * w)


def is_kernel_b_trilinear(name: str) -> bool:
    """Kernel B's trilinear instantiation on the exact table: INTERP 1
    among the symbol's template arguments."""
    m = _KERNEL_B.search(name)
    return m is not None and int(m.group(1)) == TRILINEAR
