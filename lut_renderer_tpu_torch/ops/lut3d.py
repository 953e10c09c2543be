"""3D-LUT application to planar float RGB: kernels A and C and their plain
versions.

Counterpart of lut_renderer_tpu/ops/lut3d.py::apply_lut_planes, which
dispatches here by the kind of table:

* ``LutTable``: on a CUDA tensor kernel A (csrc/lut3d.cu), which replaces
  the JAX package's ``_run_fused`` (its int8 and bf16 pallas_call
  launches): one thread per pixel reads the cell's corners straight from
  the (N, N, N, 4) f32 table, exact in f32. Every non-coarse tier of the
  JAX package approximates this one function. On a CPU tensor
  ``apply_lut_planes_reference``, the plain PyTorch re-expression of
  colorcore.interp (which cannot take ``xp=torch``: it calls ``.astype``).
* ``Coarse2Table``: on a CUDA tensor kernel C (csrc/coarse2.cu), which
  replaces ``_run_coarse2_fused``: the coarse + residual decomposition of a
  big LUT at a ``coarse2*`` tier. On a CPU tensor
  ``apply_lut_planes_coarse2_reference``, which states the same function
  on the fine grid.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..colorcore.interp import INTERP_MODES

from . import _build
from .prepare import Coarse2Table, LutTable, upsample2_linear

# kernel launches by apply_lut_planes on CUDA tensors, kernel A and kernel
# C (reset by callers that check which path ran)
launches = 0
coarse2_launches = 0

INTERP_CODES = {name: i for i, name in enumerate(INTERP_MODES)}


def canonical_interp(interp: str) -> str:
    """Unknown names fall back to tetrahedral, as the reference's
    validation does (JAX ops/lut3d.py:896-897)."""
    return interp if interp in INTERP_CODES else "tetrahedral"


# ---------------------------------------------------------------------------
# plain PyTorch version (colorcore.interp, op for op)
# ---------------------------------------------------------------------------

def _prepare(rgb, lut: LutTable):
    n = lut.size
    x = torch.clip(rgb, 0.0, 1.0)
    dmin = torch.tensor(lut.domain_min, dtype=torch.float32, device=x.device)
    dmax = torch.tensor(lut.domain_max, dtype=torch.float32, device=x.device)
    span = dmax - dmin
    x = torch.clip((x - dmin) / span, 0.0, 1.0)
    return x * (n - 1), n


def _cell(scaled, n):
    prev = torch.floor(scaled).to(torch.int64)
    nxt = torch.clamp(prev + 1, max=n - 1)
    d = scaled - prev.to(scaled.dtype)
    return prev, nxt, d[..., 0:1], d[..., 1:2], d[..., 2:3]


def _corners(table, prev, nxt):
    idx = (prev, nxt)

    def c(i, j, k):
        return table[idx[i][..., 0], idx[j][..., 1], idx[k][..., 2], :3]

    return c


def _nearest(rgb, lut):
    scaled, n = _prepare(rgb, lut)
    i = torch.clip(torch.floor(scaled + 0.5), 0, n - 1).to(torch.int64)
    return lut.table[i[..., 0], i[..., 1], i[..., 2], :3]


def _trilinear(rgb, lut):
    scaled, n = _prepare(rgb, lut)
    prev, nxt, dr, dg, db = _cell(scaled, n)
    c = _corners(lut.table, prev, nxt)
    c00 = c(0, 0, 0) * (1 - db) + c(0, 0, 1) * db
    c01 = c(0, 1, 0) * (1 - db) + c(0, 1, 1) * db
    c10 = c(1, 0, 0) * (1 - db) + c(1, 0, 1) * db
    c11 = c(1, 1, 0) * (1 - db) + c(1, 1, 1) * db
    c0 = c00 * (1 - dg) + c01 * dg
    c1 = c10 * (1 - dg) + c11 * dg
    return c0 * (1 - dr) + c1 * dr


def _tetrahedral(rgb, lut):
    scaled, n = _prepare(rgb, lut)
    prev, nxt, dr, dg, db = _cell(scaled, n)
    c = _corners(lut.table, prev, nxt)
    c000, c001, c010, c011 = c(0, 0, 0), c(0, 0, 1), c(0, 1, 0), c(0, 1, 1)
    c100, c101, c110, c111 = c(1, 0, 0), c(1, 0, 1), c(1, 1, 0), c(1, 1, 1)
    # FFmpeg's 6-case decomposition, strict comparisons
    rg, gb, rb, bg, br = dr > dg, dg > db, dr > db, db > dg, db > dr
    m1 = rg & gb
    m2 = rg & ~gb & rb
    m3 = rg & ~gb & ~rb
    m4 = ~rg & bg
    m5 = ~rg & ~bg & br
    where = torch.where
    return where(
        m1, (1 - dr) * c000 + (dr - dg) * c100 + (dg - db) * c110 + db * c111,
        where(
            m2, (1 - dr) * c000 + (dr - db) * c100 + (db - dg) * c101 + dg * c111,
            where(
                m3, (1 - db) * c000 + (db - dr) * c001 + (dr - dg) * c101 + dg * c111,
                where(
                    m4, (1 - db) * c000 + (db - dg) * c001 + (dg - dr) * c011 + dr * c111,
                    where(
                        m5, (1 - dg) * c000 + (dg - db) * c010 + (db - dr) * c011 + dr * c111,
                        (1 - dg) * c000 + (dg - dr) * c010 + (dr - db) * c110 + db * c111,
                    ),
                ),
            ),
        ),
    )


def _pyramid(rgb, lut):
    scaled, n = _prepare(rgb, lut)
    prev, nxt, dr, dg, db = _cell(scaled, n)
    c = _corners(lut.table, prev, nxt)
    c000, c111 = c(0, 0, 0), c(1, 1, 1)
    m1 = (dg > dr) & (db > dr)
    m2 = (dr > dg) & (db > dg)
    case1 = (c000 + (c111 - c(0, 1, 1)) * dr + (c(0, 1, 0) - c000) * dg
             + (c(0, 0, 1) - c000) * db
             + (c(0, 1, 1) - c(0, 0, 1) - c(0, 1, 0) + c000) * dg * db)
    case2 = (c000 + (c(1, 0, 0) - c000) * dr + (c111 - c(1, 0, 1)) * dg
             + (c(0, 0, 1) - c000) * db
             + (c(1, 0, 1) - c(1, 0, 0) - c(0, 0, 1) + c000) * dr * db)
    case3 = (c000 + (c(1, 0, 0) - c000) * dr + (c(0, 1, 0) - c000) * dg
             + (c111 - c(1, 1, 0)) * db
             + (c(1, 1, 0) - c(1, 0, 0) - c(0, 1, 0) + c000) * dr * dg)
    return torch.where(m1, case1, torch.where(m2, case2, case3))


def _prism(rgb, lut):
    scaled, n = _prepare(rgb, lut)
    prev, nxt, dr, dg, db = _cell(scaled, n)
    c = _corners(lut.table, prev, nxt)
    m = db > dr

    def plane(gi):
        v00, v01, v10, v11 = c(0, gi, 0), c(0, gi, 1), c(1, gi, 0), c(1, gi, 1)
        upper = (1 - db) * v00 + (db - dr) * v01 + dr * v11
        lower = (1 - dr) * v00 + (dr - db) * v10 + db * v11
        return torch.where(m, upper, lower)

    return plane(0) * (1 - dg) + plane(1) * dg


_FUNCS = {
    "nearest": _nearest,
    "trilinear": _trilinear,
    "tetrahedral": _tetrahedral,
    "pyramid": _pyramid,
    "prism": _prism,
}


def apply_lut_planes_reference(r, g, b, lut: LutTable,
                               interp: str = "tetrahedral"):
    """Plain PyTorch version of kernel A, on any device."""
    rgb = torch.stack([r, g, b], dim=-1).to(torch.float32)
    out = _FUNCS[canonical_interp(interp)](rgb, lut.to(rgb.device))
    return out[..., 0], out[..., 1], out[..., 2]


def resid_interp_for(lut: Coarse2Table, interp: str) -> str:
    """The residual term's interpolation: trilinear under a ``_tri`` tier
    (JAX lut3d.py:794-796), else the render's own."""
    return "trilinear" if lut.resid_trilinear else canonical_interp(interp)


def apply_lut_planes_coarse2_reference(r, g, b, lut: Coarse2Table,
                                       interp: str = "tetrahedral"):
    """Plain PyTorch version of kernel C, on any device: the interp of the
    upsampled coarse table U(C) plus the interp of the dequantised residual
    (trilinear under a ``_tri`` tier), both on the fine N grid. Kernel C
    evaluates the coarse term on the coarse grid instead."""
    rgb = torch.stack([r, g, b], dim=-1).to(torch.float32)
    lut = lut.to(rgb.device)
    fine = LutTable(upsample2_linear(lut.coarse), lut.domain_min,
                    lut.domain_max)
    resid = LutTable(lut.resid_table(), lut.domain_min, lut.domain_max)
    out = (_FUNCS[canonical_interp(interp)](rgb, fine)
           + _FUNCS[resid_interp_for(lut, interp)](rgb, resid))
    return out[..., 0], out[..., 1], out[..., 2]


# ---------------------------------------------------------------------------
# kernels A and C
# ---------------------------------------------------------------------------

class _Lut3dParams(ctypes.Structure):
    """Mirror of Lut3dParams in csrc/lut3d.cu."""

    _fields_ = [
        ("r", ctypes.c_void_p), ("g", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("ro", ctypes.c_void_p),
        ("go", ctypes.c_void_p), ("bo", ctypes.c_void_p),
        ("table", ctypes.c_void_p), ("npix", ctypes.c_longlong),
        ("n", ctypes.c_int), ("interp", ctypes.c_int),
        ("dmin", ctypes.c_float * 3), ("dmax", ctypes.c_float * 3),
    ]


class _Coarse2Params(ctypes.Structure):
    """Mirror of Coarse2Params in csrc/coarse2.cu."""

    _fields_ = [
        ("r", ctypes.c_void_p), ("g", ctypes.c_void_p),
        ("b", ctypes.c_void_p), ("ro", ctypes.c_void_p),
        ("go", ctypes.c_void_p), ("bo", ctypes.c_void_p),
        ("coarse", ctypes.c_void_p), ("resid", ctypes.c_void_p),
        ("rscale", ctypes.c_void_p), ("npix", ctypes.c_longlong),
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("interp", ctypes.c_int),
        ("resid_interp", ctypes.c_int),
        ("dmin", ctypes.c_float * 3), ("dmax", ctypes.c_float * 3),
    ]


def _check(t: torch.Tensor, dtype, shape, device, what: str) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous {dtype} {shape} tensor on {device}; "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def check_table(lut, device: torch.device) -> None:
    """Raise unless every tensor of `lut` (a LutTable or a Coarse2Table) has
    the layout its kernel reads, on `device`."""
    n = lut.size
    if isinstance(lut, Coarse2Table):
        m = lut.coarse_size
        if 2 * m - 1 != n:
            raise ValueError(f"coarse table {m}^3 does not match N={n}")
        _check(lut.coarse, torch.float32, (m, m, m, 4), device, "coarse table")
        _check(lut.resid, torch.int8, (n, n, n, 4), device, "residual table")
        _check(lut.resid_scale, torch.float32, (n, 4), device,
               "residual scales")
        return
    _check(lut.table, torch.float32, (n, n, n, 4), device, "LUT table")


def _check_planes(r, g, b, what: str) -> None:
    for t in (r, g, b):
        if (t.device != r.device or t.dtype != torch.float32
                or t.shape != r.shape or not t.is_contiguous()):
            raise ValueError(f"{what} takes three contiguous float32 planes "
                             f"of one shape on one device")


def _coarse2_cuda(r, g, b, lut: Coarse2Table, interp: str):
    global coarse2_launches
    dev = r.device
    check_table(lut, dev)
    _check_planes(r, g, b, "kernel C")
    ro, go, bo = (torch.empty_like(r) for _ in range(3))
    p = _Coarse2Params(
        r.data_ptr(), g.data_ptr(), b.data_ptr(),
        ro.data_ptr(), go.data_ptr(), bo.data_ptr(),
        lut.coarse.data_ptr(), lut.resid.data_ptr(),
        lut.resid_scale.data_ptr(), r.numel(), lut.size, lut.coarse_size,
        INTERP_CODES[interp], INTERP_CODES[resid_interp_for(lut, interp)],
        (ctypes.c_float * 3)(*lut.domain_min),
        (ctypes.c_float * 3)(*lut.domain_max))
    _build.launch("coarse2_launch", p, dev)
    coarse2_launches += 1
    return ro, go, bo


def _lut3d_cuda(r, g, b, lut: LutTable, interp: str):
    global launches
    dev = r.device
    check_table(lut, dev)
    _check_planes(r, g, b, "kernel A")
    ro, go, bo = (torch.empty_like(r) for _ in range(3))
    p = _Lut3dParams(
        r.data_ptr(), g.data_ptr(), b.data_ptr(),
        ro.data_ptr(), go.data_ptr(), bo.data_ptr(),
        lut.table.data_ptr(), r.numel(), lut.size, INTERP_CODES[interp],
        (ctypes.c_float * 3)(*lut.domain_min),
        (ctypes.c_float * 3)(*lut.domain_max))
    _build.launch("lut3d_launch", p, dev)
    launches += 1
    return ro, go, bo


def apply_lut_planes(r, g, b, lut: Union[LutTable, Coarse2Table],
                     interp: str = "tetrahedral"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply a LutTable or a Coarse2Table to same-shaped float planes in
    [0, 1].

    CUDA tensors launch kernel A or kernel C by the table's kind (raising
    if it cannot build or launch); CPU tensors run the plain version."""
    interp = canonical_interp(interp)
    coarse2 = isinstance(lut, Coarse2Table)
    if r.device.type == "cuda":
        planes = (r.contiguous(), g.contiguous(), b.contiguous())
        if coarse2:
            return _coarse2_cuda(*planes, lut, interp)
        return _lut3d_cuda(*planes, lut, interp)
    if r.device.type != "cpu":
        raise ValueError(f"unsupported device {r.device}")
    if coarse2:
        return apply_lut_planes_coarse2_reference(r, g, b, lut, interp)
    return apply_lut_planes_reference(r, g, b, lut, interp)
