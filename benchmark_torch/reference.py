"""The plain reference of a render: integer YUV planes in, integer YUV
planes out, in plain PyTorch operations.

It follows the published definitions and FFmpeg's behaviour, and imports
nothing of the program: the limited/full-range code values and the
YUV <-> RGB matrices of ITU-R BT.709, BT.601 and BT.2020; 2x2 chroma
replication up and 2x2 means down (4:2:0), 2x1 for 4:2:2; FFmpeg
``lut3d``'s tetrahedral, trilinear and nearest interpolation (inputs
clipped to [0, 1] and scaled by N - 1, strict comparisons between the
fractions); libswscale's default bicubic (Keys B = 0, C = 0.6) for a
resize, applied to the RGB planes after the LUT; the 16x16 Bayer ordered
dither or a position-hash dither, then rounding half up.

``precision`` selects the arithmetic: ``"float32"`` (IEEE float32, matrix
products with TF32 off; the precision every configuration states),
``"tf32"`` (float32, with the resample's matrix operands rounded to TF32's
10-bit mantissa, as the tensor cores round them) and ``"bfloat16"`` (every
floating operation in bfloat16). The two lower ones are the controls: a
comparison that cannot tell them from the program is not a check.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PRECISIONS = ("float32", "tf32", "bfloat16")

# (Kr, Kb) of each matrix name
MATRICES = {
    "bt709": (0.2126, 0.0722),
    "bt601": (0.299, 0.114),
    "smpte170m": (0.299, 0.114),
    "bt470bg": (0.299, 0.114),
    "bt2020nc": (0.2627, 0.0593),
    "bt2020c": (0.2627, 0.0593),
}


def _range(depth: int, full: bool):
    """(y offset, y scale, chroma middle, chroma scale) in code values."""
    k = float(1 << (depth - 8))
    mid = float(1 << (depth - 1))
    if full:
        top = float((1 << depth) - 1)
        return 0.0, top, mid, top
    return 16.0 * k, 219.0 * k, mid, 224.0 * k


def _coeffs(matrix: str):
    kr, kb = MATRICES[matrix]
    kg = 1.0 - kr - kb
    return kr, kg, kb, 2.0 * (1.0 - kr), 2.0 * (1.0 - kb)


def _div(x, c: float):
    """x / c, one correctly rounded division in x's type."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _up(c, sub: str):
    if sub == "420":
        return c.repeat_interleave(2, -2).repeat_interleave(2, -1)
    if sub == "422":
        return c.repeat_interleave(2, -1)
    return c


def _down(c, sub: str):
    if sub == "420":
        pairs = c[..., :, 0::2] + c[..., :, 1::2]
        return (pairs[..., 0::2, :] + pairs[..., 1::2, :]) * 0.25
    if sub == "422":
        return (c[..., :, 0::2] + c[..., :, 1::2]) * 0.5
    return c


def _lut(r, g, b, table, interp: str):
    """FFmpeg lut3d on planes in [0, 1]; `table` (N, N, N, 3) [r, g, b]."""
    n = table.shape[0]
    flat = table.reshape(-1, 3)
    s = [torch.clip(c, 0.0, 1.0) * (n - 1) for c in (r, g, b)]
    if interp == "nearest":
        i = [torch.clip(torch.floor(c + 0.5), 0, n - 1).long() for c in s]
        out = flat[(i[0] * n + i[1]) * n + i[2]]
        return out[..., 0], out[..., 1], out[..., 2]
    lo = [torch.floor(c) for c in s]
    d = [c - f for c, f in zip(s, lo)]
    i0 = [f.long() for f in lo]
    i1 = [torch.clamp(i + 1, max=n - 1) for i in i0]

    def at(ri, gi, bi):
        return flat[(ri * n + gi) * n + bi]

    c000 = at(i0[0], i0[1], i0[2])
    c111 = at(i1[0], i1[1], i1[2])
    c100 = at(i1[0], i0[1], i0[2])
    c010 = at(i0[0], i1[1], i0[2])
    c001 = at(i0[0], i0[1], i1[2])
    c110 = at(i1[0], i1[1], i0[2])
    c101 = at(i1[0], i0[1], i1[2])
    c011 = at(i0[0], i1[1], i1[2])
    dr, dg, db = (x[..., None] for x in d)
    if interp == "trilinear":
        c00 = c000 * (1 - db) + c001 * db
        c01 = c010 * (1 - db) + c011 * db
        c10 = c100 * (1 - db) + c101 * db
        c11 = c110 * (1 - db) + c111 * db
        c0 = c00 * (1 - dg) + c01 * dg
        c1 = c10 * (1 - dg) + c11 * dg
        out = c0 * (1 - dr) + c1 * dr
    elif interp == "tetrahedral":
        # FFmpeg's six tetrahedra, chosen by strict comparisons
        rg, gb, rb = dr > dg, dg > db, dr > db
        t1 = (1 - dr) * c000 + (dr - dg) * c100 + (dg - db) * c110 + db * c111
        t2 = (1 - dr) * c000 + (dr - db) * c100 + (db - dg) * c101 + dg * c111
        t3 = (1 - db) * c000 + (db - dr) * c001 + (dr - dg) * c101 + dg * c111
        t4 = (1 - db) * c000 + (db - dg) * c001 + (dg - dr) * c011 + dr * c111
        t5 = (1 - dg) * c000 + (dg - db) * c010 + (db - dr) * c011 + dr * c111
        t6 = (1 - dg) * c000 + (dg - dr) * c010 + (dr - db) * c110 + db * c111
        out = torch.where(
            rg, torch.where(gb, t1, torch.where(rb, t2, t3)),
            torch.where(db > dg, t4, torch.where(db > dr, t5, t6)))
    else:
        raise ValueError(f"the reference has no {interp!r} interpolation")
    return out[..., 0], out[..., 1], out[..., 2]


def _keys(x: float) -> float:
    """Keys' cubic with B = 0, C = 0.6 at |x|, times 6."""
    b, c = 0.0, 0.6
    if x < 1.0:
        return ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x * x
                + (6 - 2 * b))
    if x < 2.0:
        return ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x * x
                + (-12 * b - 48 * c) * x + (8 * b + 24 * c))
    return 0.0


@functools.lru_cache(maxsize=16)
def bicubic_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 matrix of libswscale's SWS_BICUBIC on one axis:
    16.16 fixed-point steps, the filter widened by src/dst on a downscale,
    taps past the border folded onto the edge sample, each row normalised
    to sum 1 (libswscale/utils.c initFilter)."""
    step = (src * 65536 + (dst >> 1)) // dst
    up = step <= 65536
    size = 5 if up else 1 + (4 * src + dst - 1) // dst
    size = max(1, min(size, src - 2)) if src > 2 else 1
    w = np.zeros((dst, src), np.float64)
    for i in range(dst):
        centre = (2 * i + 1) * step - 65536
        num = centre - (size - 2) * 65536
        first = abs(num) // 131072 * (1 if num >= 0 else -1)
        for j in range(size):
            dist = abs((first + j) * 131072 - centre) << 13
            if not up:
                dist = dist * dst // src
            w[i, min(max(first + j, 0), src - 1)] += _keys(dist / 2.0 ** 30)
        total = w[i].sum()
        if total != 0.0:
            w[i] /= total
        else:
            w[i, min(max(first, 0), src - 1)] = 1.0
    return w.astype(np.float32)


def _tf32(x):
    """float32 rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, as the tensor cores take a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _resample(x, wv, wh, precision: str):
    """Wv @ x @ Wh^T frame by frame, the vertical product first."""
    if precision == "tf32":
        wv, wh = _tf32(wv), _tf32(wh)
    out = []
    for frame in x.reshape(-1, *x.shape[-2:]):
        if precision == "tf32":
            frame = _tf32(frame)
        mid = wv @ frame
        if precision == "tf32":
            mid = _tf32(mid)
        out.append(mid @ wh.t())
    return torch.stack(out).reshape(*x.shape[:-2], wv.shape[0], wh.shape[0])


def bayer16() -> np.ndarray:
    """The 16x16 Bayer matrix as offsets (m + 0.5) / 256 - 0.5."""
    m = np.zeros((1, 1), np.int64)
    for _ in range(4):
        m = np.block([[4 * m, 4 * m + 2], [4 * m + 3, 4 * m + 1]])
    return ((m.astype(np.float32) + 0.5) / 256.0 - 0.5).astype(np.float32)


def _hash_offsets(h: int, w: int, plane_seed: int, device):
    """Offsets in (-0.5, 0.5) from a murmur3-finalizer hash of (row,
    column, plane seed), in uint32 arithmetic held in int64."""
    m = 0xFFFFFFFF
    rows = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    x = (((rows * 0x9E3779B1) & m) ^ ((cols * 0x85EBCA77) & m)
         ^ ((plane_seed * 0xC2B2AE3D) & m))
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & m
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & m
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * 2.0 ** -24 - 0.5


def _quantize(x, depth: int, dither: str, plane_seed: int):
    h, w = x.shape[-2:]
    if dither == "ordered":
        tile = torch.from_numpy(bayer16()).to(x.device, x.dtype)
        x = x + tile.repeat(-(-h // 16), -(-w // 16))[:h, :w]
    elif dither == "random":
        x = x + _hash_offsets(h, w, plane_seed, x.device).to(x.dtype)
    elif dither != "none":
        raise ValueError(f"the reference has no {dither!r} dither")
    top = (1 << depth) - 1
    q = torch.clip(torch.floor(x + 0.5), 0, top).to(torch.int32)
    return q.to(torch.uint8) if depth <= 8 else q


def render(y, u, v, table, pipe: dict, resize=None,
           precision: str = "float32"):
    """One batch (B, H, W) of integer planes through the reference.

    ``table``: the LUT (N, N, N, 3) as a float32 tensor on the planes'
    device, or None for no LUT. ``pipe``: the configuration's stated
    pipeline (in/out depth, subsampling and range, the working range, the
    matrices, the interpolation, the dither). ``resize``: (out_w, out_h)
    or None. Returns uint8 planes at 8 bits, else int32 code values."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    depth, sub = pipe["in_depth"], pipe["in_subsampling"]
    yf, uf, vf = (t.to(dt) for t in (y, u, v))
    if pipe["in_full_range"] != pipe["work_full_range"]:
        # swscale's range conversion, the 8-bit ratios at every depth, then
        # back to integer codes
        k, mid = float(1 << (depth - 8)), float(1 << (depth - 1))
        if pipe["in_full_range"]:
            yf = yf * (219.0 / 255.0) + 16.0 * k
            uf, vf = ((c - mid) * (224.0 / 255.0) + mid for c in (uf, vf))
        else:
            yf = (yf - 16.0 * k) * (255.0 / 219.0)
            uf, vf = ((c - mid) * (255.0 / 224.0) + mid for c in (uf, vf))
        if pipe.get("requantize_intermediate", True):
            top = float((1 << depth) - 1)
            yf, uf, vf = (torch.clip(torch.floor(t + 0.5), 0, top)
                          for t in (yf, uf, vf))
    uf, vf = _up(uf, sub), _up(vf, sub)
    kr, kg, kb, crv, cbu = _coeffs(pipe["matrix_in"])
    y_off, y_scale, mid, c_scale = _range(depth, pipe["work_full_range"])
    yn = _div(yf - y_off, y_scale)
    un = _div(uf - mid, c_scale)
    vn = _div(vf - mid, c_scale)
    r = torch.clip(yn + crv * vn, 0.0, 1.0)
    g = torch.clip(yn - (kr * crv / kg) * vn - (kb * cbu / kg) * un, 0.0, 1.0)
    b = torch.clip(yn + cbu * un, 0.0, 1.0)
    if table is not None:
        r, g, b = _lut(r, g, b, table.to(dt), pipe["interp"])
    if resize is not None:
        ow, oh = resize
        h, w = r.shape[-2:]
        wv = torch.from_numpy(bicubic_weights(h, oh)).to(r.device, dt)
        wh = torch.from_numpy(bicubic_weights(w, ow)).to(r.device, dt)
        r, g, b = (_resample(p, wv, wh, precision) for p in (r, g, b))
    kr, kg, kb, crv, cbu = _coeffs(pipe["matrix_out"])
    odepth = pipe["out_depth"]
    y_off, y_scale, mid, c_scale = _range(odepth, pipe["out_full_range"])
    yn = kr * r + kg * g + kb * b
    vn = _div(r - yn, crv)
    un = _div(b - yn, cbu)
    yo = yn * y_scale + y_off
    uo = _down(un * c_scale + mid, pipe["out_subsampling"])
    vo = _down(vn * c_scale + mid, pipe["out_subsampling"])
    return tuple(_quantize(p, odepth, pipe["dither"], seed)
                 for p, seed in ((yo, 1), (uo, 2), (vo, 3)))
