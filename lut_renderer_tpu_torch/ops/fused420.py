"""Whole-frame YUV -> YUV render in one kernel: kernel B and its plain version.

Counterpart of lut_renderer_tpu/ops/fused420.py. On CUDA tensors
``render_fused420`` launches kernel B (csrc/fused420.cuh), which replaces
the JAX package's fused pallas_call: integer planes in, quantised integer
planes out, the chroma downsample done in the kernel. Kernel B comes in
two table kinds, by the table it is given: the exact ``LutTable``
(csrc/fused420.cu) and the coarse + residual ``Coarse2Table`` (kernel C's
LUT step, csrc/fused420_coarse2.cu), each with its own launch count and
one instantiation per interpolation and output geometry.
``launch_geometry`` picks its work units and whether the planes move as
vectors. On CPU tensors it runs ``render_fused420_reference``: the plain
layout of ops.pixel with the table's plain LUT, which is the value
contract the JAX fused kernel is held to.

It covers every nearest-sited {420, 422, 444} -> {420, 422, 444} geometry
at 8 or 10 bits, full or limited range with the intermediate requantise,
``none``/``ordered``/``random`` dither and all five interpolations. The JAX
package's two TPU-only gates are gone: the VMEM fit of the table and the
N > 97 Mosaic compile limit, so a 129^3 LUT renders fused too. Widths
need no lane padding: the kernel indexes exact shapes.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple, Union

import numpy as np
import torch

from ..colorcore import matrices as cm
from ..colorcore.dither import bayer_offsets

from . import _build
from .lut3d import INTERP_CODES, apply_lut_planes_coarse2_reference, \
    apply_lut_planes_reference, canonical_interp, check_table, \
    resid_interp_for
from .pixel import render_planes
from .prepare import Coarse2Table, LutTable

# kernel launches by render_fused420 on CUDA tensors, of the exact and the
# coarse2 instantiation (reset by callers that check which path ran), and
# the exact instantiation's launches by interpolation ({name: count}, its
# counts add up to `launches`)
launches = 0
coarse2_launches = 0
launches_by_interp: dict = {}

# luma columns of a kernel B work unit (csrc/fused420.cuh): on the vector
# path, and on the scalar path
UNIT_COLS, SCALAR_COLS = 8, 2
_INT32 = 1 << 31
_MAX_UNITS = _INT32 - (1 << 24)  # the kernel's unit loop stays in int32

_SUB_SHIFTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}  # (x, y)
_DITHER_CODES = {"none": 0, "ordered": 1, "random": 2}


def fused420_applicable(y, u, cfg, lut) -> bool:
    """True when the frame can take kernel B: a LUT in play, no resize, a
    dither the kernel finishes itself, nearest chroma siting, even height,
    an even width unless 4:4:4 in and out, and chroma planes of the
    geometry ``cfg`` names."""
    if not (cfg.resize is None
            and cfg.dither in _DITHER_CODES
            and cfg.apply_lut
            and lut is not None
            and y.ndim >= 2):
        return False
    in_sub, out_sub = cfg.in_subsampling, cfg.out_subsampling
    if in_sub not in _SUB_SHIFTS or out_sub not in _SUB_SHIFTS:
        return False
    if in_sub == "420" and cfg.chroma_up != "nearest":
        return False
    H, W = int(y.shape[-2]), int(y.shape[-1])
    if H % 2:
        return False
    if W % 2 and (in_sub != "444" or out_sub != "444"):
        return False
    sx, sy = _SUB_SHIFTS[in_sub]
    return int(u.shape[-2]) == H >> sy and int(u.shape[-1]) == W >> sx


def render_fused420_reference(y, u, v, lut: Union[LutTable, Coarse2Table],
                              cfg):
    """Plain PyTorch version of kernel B, on any device, with the plain
    version of the table's own LUT kernel."""
    plain = (apply_lut_planes_coarse2_reference
             if isinstance(lut, Coarse2Table) else apply_lut_planes_reference)
    return render_planes(y, u, v, cfg,
                         lambda r, g, b: plain(r, g, b, lut, cfg.interp))


class _Fused420Params(ctypes.Structure):
    """Mirror of Fused420Params in csrc/fused420.cuh."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in
         ("y", "u", "v", "yo", "uo", "vo", "table", "bayer", "coarse",
          "resid", "rscale")]
        + [(name, ctypes.c_int) for name in
           ("batch", "height", "width", "in16", "out16", "in_sx", "in_sy",
            "out_sx", "out_sy", "n", "m", "interp", "resid_interp",
            "normalize", "requant", "dither")]
        + [("dmin", ctypes.c_float * 3), ("dmax", ctypes.c_float * 3)]
        + [(name, ctypes.c_float) for name in
           ("norm_ysub", "norm_ymul", "norm_yadd", "norm_cmid", "norm_cmul",
            "maxv_in", "maxv_out",
            "in_yoff", "in_yscale", "in_cmid", "in_cscale", "in_crv",
            "in_cbu", "in_gv", "in_gu",
            "out_kr", "out_kg", "out_kb", "out_crv", "out_cbu", "out_yoff",
            "out_yscale", "out_cmid", "out_cscale")]
        + [(name, ctypes.c_int) for name in
           ("units", "units_per_row", "vec")]
    )


class Geometry(NamedTuple):
    """How kernel B covers a frame: ``units`` work units, each of ``cols``
    luma columns by the output chroma row's height (2 rows for 4:2:0 out,
    else 1) and the output chroma sites under them; ``units_per_row`` of
    them side by side per output chroma row; ``vec``: the planes load and
    store as vectors (else sample by sample)."""

    units: int
    units_per_row: int
    vec: bool
    cols: int


def launch_geometry(batch: int, height: int, width: int, out_sy: int,
                    aligned: bool) -> Geometry:
    """Kernel B's work units for `batch` frames of height x width with
    output chroma rows of 1 << out_sy luma rows. Vectors need every row
    to start on a vector (width a multiple of UNIT_COLS) and planes whose
    base addresses are 16-byte ``aligned``; otherwise the kernel's scalar
    path takes the frame in units of SCALAR_COLS columns, the last one cut
    at an odd width."""
    if height * width >= _INT32:
        raise ValueError(f"kernel B takes frames under 2^31 pixels, got "
                         f"{height}x{width}")
    vec = aligned and width % UNIT_COLS == 0
    cols = UNIT_COLS if vec else SCALAR_COLS
    per_row = -(-width // cols)
    units = batch * (height >> out_sy) * per_row
    if units > _MAX_UNITS:
        raise ValueError(f"kernel B takes at most {_MAX_UNITS} work units "
                         f"per launch, got {units}")
    return Geometry(units, per_row, vec, cols)


@functools.lru_cache(maxsize=64)
def kernel_constants(cfg) -> types.MappingProxyType:
    """The per-config scalars of kernel B, computed in double as
    colorcore.matrices and ops.pixel compute them before their f32
    arithmetic (ctypes rounds each to f32 once). Read-only: the cache
    hands the same mapping to every caller."""
    c = {}
    shift = float(1 << (cfg.in_depth - 8))
    c_mid = float(1 << (cfg.in_depth - 1))
    c["normalize"] = int(cfg.in_full_range != cfg.work_full_range)
    c["requant"] = int(bool(cfg.requantize_intermediate))
    if cfg.in_full_range and not cfg.work_full_range:
        ysub, ymul, yadd, cmul = 0.0, 219.0 / 255.0, 16.0 * shift, 224.0 / 255.0
    else:
        ysub, ymul, yadd, cmul = 16.0 * shift, 255.0 / 219.0, 0.0, 255.0 / 224.0
    c.update(norm_ysub=ysub, norm_ymul=ymul, norm_yadd=yadd, norm_cmid=c_mid,
             norm_cmul=cmul)
    c["maxv_in"] = float((1 << cfg.in_depth) - 1)
    c["maxv_out"] = float((1 << cfg.out_depth) - 1)

    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(cfg.matrix_in)
    yoff, yscale, cmid, cscale = cm._range_params(cfg.in_depth,
                                                  cfg.work_full_range)
    c.update(in_yoff=yoff, in_yscale=yscale, in_cmid=cmid, in_cscale=cscale,
             in_crv=crv, in_cbu=cbu, in_gv=kr * crv / kg, in_gu=kb * cbu / kg)

    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs(cfg.matrix_out)
    yoff, yscale, cmid, cscale = cm._range_params(cfg.out_depth,
                                                  cfg.out_full_range)
    c.update(out_kr=kr, out_kg=kg, out_kb=kb, out_crv=crv, out_cbu=cbu,
             out_yoff=yoff, out_yscale=yscale, out_cmid=cmid,
             out_cscale=cscale)
    c["interp"] = INTERP_CODES[canonical_interp(cfg.interp)]
    c["dither"] = _DITHER_CODES[cfg.dither]
    c["in_sx"], c["in_sy"] = _SUB_SHIFTS[cfg.in_subsampling]
    c["out_sx"], c["out_sy"] = _SUB_SHIFTS[cfg.out_subsampling]
    return types.MappingProxyType(c)


def bayer_tensor(device) -> torch.Tensor:
    """The 16x16 ordered-dither offsets kernel B reads, on `device`."""
    return torch.from_numpy(np.ascontiguousarray(bayer_offsets(4))).to(device)


def launch_args(y, u, v, lut: Union[LutTable, Coarse2Table], cfg, bayer):
    """Check the operands of kernel B on a CUDA device and allocate its
    outputs: (params, (yo, uo, vo), keep). ``keep`` holds every tensor the
    params point to; it must outlive the launch."""
    dev = y.device
    check_table(lut, dev)
    if y.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"kernel B takes uint8/uint16 planes, got {y.dtype}")
    for t in (u, v):
        if t.device != dev or t.dtype != y.dtype or t.shape != u.shape:
            raise ValueError("chroma planes must match each other and y in "
                             "device and dtype")
    if not fused420_applicable(y, u, cfg, lut):
        raise ValueError(f"kernel B does not apply to cfg={cfg}, "
                         f"y={tuple(y.shape)}, u={tuple(u.shape)}")
    lead = y.shape[:-2]
    H, W = int(y.shape[-2]), int(y.shape[-1])
    B = int(np.prod(lead, dtype=np.int64)) if lead else 1
    y, u, v = (t.contiguous() for t in (y, u, v))
    k = kernel_constants(cfg)
    out_dt = torch.uint8 if cfg.out_depth <= 8 else torch.uint16
    shape_c = lead + (H >> k["out_sy"], W >> k["out_sx"])
    yo = torch.empty(lead + (H, W), dtype=out_dt, device=dev)
    uo = torch.empty(shape_c, dtype=out_dt, device=dev)
    vo = torch.empty(shape_c, dtype=out_dt, device=dev)
    if k["dither"] == _DITHER_CODES["ordered"]:
        if bayer is None:
            bayer = bayer_tensor(dev)
        bayer_ptr = bayer.data_ptr()
    else:
        bayer_ptr = None
    coarse2 = isinstance(lut, Coarse2Table)
    if coarse2:
        tables = dict(coarse=lut.coarse.data_ptr(),
                      resid=lut.resid.data_ptr(),
                      rscale=lut.resid_scale.data_ptr(), m=lut.coarse_size,
                      resid_interp=INTERP_CODES[
                          resid_interp_for(lut, cfg.interp)])
    else:
        tables = dict(table=lut.table.data_ptr())
    planes = (y, u, v, yo, uo, vo)
    geom = launch_geometry(B, H, W, k["out_sy"],
                           all(t.data_ptr() % 16 == 0 for t in planes))
    p = _Fused420Params(
        y=y.data_ptr(), u=u.data_ptr(), v=v.data_ptr(), yo=yo.data_ptr(),
        uo=uo.data_ptr(), vo=vo.data_ptr(), bayer=bayer_ptr, batch=B,
        height=H, width=W, in16=int(y.dtype == torch.uint16),
        out16=int(out_dt == torch.uint16), n=lut.size,
        dmin=(ctypes.c_float * 3)(*lut.domain_min),
        dmax=(ctypes.c_float * 3)(*lut.domain_max), units=geom.units,
        units_per_row=geom.units_per_row, vec=int(geom.vec), **tables, **k)
    return p, (yo, uo, vo), (y, u, v, bayer)


def entry_point(lut) -> str:
    """The library entry that launches kernel B for `lut`'s table kind."""
    return ("fused420_coarse2_launch" if isinstance(lut, Coarse2Table)
            else "fused420_launch")


def _fused420_cuda(y, u, v, lut: Union[LutTable, Coarse2Table], cfg, bayer):
    global launches, coarse2_launches
    p, out, _keep = launch_args(y, u, v, lut, cfg, bayer)
    _build.launch(entry_point(lut), p, y.device)
    if isinstance(lut, Coarse2Table):
        coarse2_launches += 1
    else:
        launches += 1
        interp = canonical_interp(cfg.interp)
        launches_by_interp[interp] = launches_by_interp.get(interp, 0) + 1
    return out


def render_fused420(y, u, v, lut: Union[LutTable, Coarse2Table], cfg,
                    bayer=None):
    """One render of a (batched) frame in a geometry fused420_applicable
    accepts. CUDA tensors launch kernel B (``bayer``: the device's Bayer
    tensor, made here when None); CPU tensors run the plain version."""
    if y.device.type == "cuda":
        return _fused420_cuda(y, u, v, lut, cfg, bayer)
    if y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    return render_fused420_reference(y, u, v, lut, cfg)
