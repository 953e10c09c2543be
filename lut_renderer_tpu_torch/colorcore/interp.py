"""Reference 3D-LUT interpolators (nearest / trilinear / tetrahedral).

Semantics replicate FFmpeg's `lut3d` filter (libavfilter vf_lut3d), which is
what the reference invokes for every frame (reference: src/lut_renderer/
ffmpeg.py:242-247; accepted interp set with tetrahedral fallback at
ffmpeg.py:243-244). Specifically:

  * input channels are sanitized to [0,1] and scaled by (N-1)
    (for non-unit DOMAIN_MIN/MAX the input is first mapped through the domain);
  * PREV(x) = trunc(x), NEXT(x) = min(trunc(x)+1, N-1), d = scaled - PREV;
  * nearest uses NEAR(x) = trunc(x + 0.5);
  * tetrahedral uses FFmpeg's 6-case decomposition with *strict* comparisons
    (d.r > d.g, etc.) — tie behavior matters for bit-exactness.

These are the golden implementations every TPU kernel is tested against. They
are written against an `xp` module (numpy or jax.numpy) so the same code is the
NumPy oracle and a jit-able JAX fallback.
"""

from __future__ import annotations

import numpy as np

INTERP_MODES = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")


def _prepare(rgb, lut_table, domain_min, domain_max, xp):
    n = lut_table.shape[0]
    x = xp.clip(rgb, 0.0, 1.0)
    dmin = xp.asarray(domain_min, dtype=x.dtype)
    dmax = xp.asarray(domain_max, dtype=x.dtype)
    span = dmax - dmin
    # Non-unit domain: map through the domain before scaling (FFmpeg prelut).
    x = xp.clip((x - dmin) / span, 0.0, 1.0)
    scaled = x * (n - 1)
    return scaled, n


def _gather(lut_table, ri, gi, bi):
    """lut_table[ri, gi, bi] -> (..., 3). Works for numpy and jax arrays."""
    return lut_table[ri, gi, bi]


def apply_lut_nearest(rgb, lut_table, domain_min=(0, 0, 0), domain_max=(1, 1, 1), xp=np):
    scaled, n = _prepare(rgb, lut_table, domain_min, domain_max, xp)
    idx = xp.clip(xp.floor(scaled + 0.5), 0, n - 1).astype(xp.int32)
    return _gather(lut_table, idx[..., 0], idx[..., 1], idx[..., 2])


def apply_lut_trilinear(rgb, lut_table, domain_min=(0, 0, 0), domain_max=(1, 1, 1), xp=np):
    scaled, n = _prepare(rgb, lut_table, domain_min, domain_max, xp)
    prev = xp.floor(scaled).astype(xp.int32)
    nxt = xp.minimum(prev + 1, n - 1)
    d = scaled - prev.astype(scaled.dtype)
    dr, dg, db = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    r0, g0, b0 = prev[..., 0], prev[..., 1], prev[..., 2]
    r1, g1, b1 = nxt[..., 0], nxt[..., 1], nxt[..., 2]

    c000 = _gather(lut_table, r0, g0, b0)
    c001 = _gather(lut_table, r0, g0, b1)
    c010 = _gather(lut_table, r0, g1, b0)
    c011 = _gather(lut_table, r0, g1, b1)
    c100 = _gather(lut_table, r1, g0, b0)
    c101 = _gather(lut_table, r1, g0, b1)
    c110 = _gather(lut_table, r1, g1, b0)
    c111 = _gather(lut_table, r1, g1, b1)

    c00 = c000 * (1 - db) + c001 * db
    c01 = c010 * (1 - db) + c011 * db
    c10 = c100 * (1 - db) + c101 * db
    c11 = c110 * (1 - db) + c111 * db
    c0 = c00 * (1 - dg) + c01 * dg
    c1 = c10 * (1 - dg) + c11 * dg
    return c0 * (1 - dr) + c1 * dr


def apply_lut_tetrahedral(rgb, lut_table, domain_min=(0, 0, 0), domain_max=(1, 1, 1), xp=np):
    scaled, n = _prepare(rgb, lut_table, domain_min, domain_max, xp)
    prev = xp.floor(scaled).astype(xp.int32)
    nxt = xp.minimum(prev + 1, n - 1)
    d = scaled - prev.astype(scaled.dtype)
    dr, dg, db = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    r0, g0, b0 = prev[..., 0], prev[..., 1], prev[..., 2]
    r1, g1, b1 = nxt[..., 0], nxt[..., 1], nxt[..., 2]

    c000 = _gather(lut_table, r0, g0, b0)
    c001 = _gather(lut_table, r0, g0, b1)
    c010 = _gather(lut_table, r0, g1, b0)
    c011 = _gather(lut_table, r0, g1, b1)
    c100 = _gather(lut_table, r1, g0, b0)
    c101 = _gather(lut_table, r1, g0, b1)
    c110 = _gather(lut_table, r1, g1, b0)
    c111 = _gather(lut_table, r1, g1, b1)

    # FFmpeg's 6-case tetrahedral decomposition (strict comparisons).
    rg = dr > dg
    gb = dg > db
    rb = dr > db
    bg = db > dg
    br = db > dr

    # Case masks (mutually exclusive, exhaustive):
    m1 = rg & gb                       # d.r > d.g > d.b      -> c100, c110
    m2 = rg & ~gb & rb                 # d.r > d.b >= d.g     -> c100, c101
    m3 = rg & ~gb & ~rb                # d.b >= d.r > d.g     -> c001, c101
    m4 = ~rg & bg                      # d.b > d.g >= d.r     -> c001, c011
    m5 = ~rg & ~bg & br                # d.g >= d.b > d.r     -> c010, c011
    m6 = ~rg & ~bg & ~br               # d.g >= d.r >= d.b    -> c010, c110

    where = xp.where
    out = where(
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
    del m6
    return out


def _corners(lut_table, prev, nxt):
    r0, g0, b0 = prev[..., 0], prev[..., 1], prev[..., 2]
    r1, g1, b1 = nxt[..., 0], nxt[..., 1], nxt[..., 2]
    g = _gather
    return {
        (0, 0, 0): g(lut_table, r0, g0, b0),
        (0, 0, 1): g(lut_table, r0, g0, b1),
        (0, 1, 0): g(lut_table, r0, g1, b0),
        (0, 1, 1): g(lut_table, r0, g1, b1),
        (1, 0, 0): g(lut_table, r1, g0, b0),
        (1, 0, 1): g(lut_table, r1, g0, b1),
        (1, 1, 0): g(lut_table, r1, g1, b0),
        (1, 1, 1): g(lut_table, r1, g1, b1),
    }


def apply_lut_pyramid(rgb, lut_table, domain_min=(0, 0, 0), domain_max=(1, 1, 1), xp=np):
    """FFmpeg interp_pyramid: bilinear over two axes on the prev-plane of the
    smallest-delta axis, plus a linear step along that axis via c111 minus
    the all-next-except-X corner."""
    scaled, n = _prepare(rgb, lut_table, domain_min, domain_max, xp)
    prev = xp.floor(scaled).astype(xp.int32)
    nxt = xp.minimum(prev + 1, n - 1)
    d = scaled - prev.astype(scaled.dtype)
    dr, dg, db = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    c = _corners(lut_table, prev, nxt)

    m1 = ((dg > dr) & (db > dr))
    m2 = ((dr > dg) & (db > dg))
    case1 = (
        c[0, 0, 0]
        + (c[1, 1, 1] - c[0, 1, 1]) * dr
        + (c[0, 1, 0] - c[0, 0, 0]) * dg
        + (c[0, 0, 1] - c[0, 0, 0]) * db
        + (c[0, 1, 1] - c[0, 0, 1] - c[0, 1, 0] + c[0, 0, 0]) * dg * db
    )
    case2 = (
        c[0, 0, 0]
        + (c[1, 0, 0] - c[0, 0, 0]) * dr
        + (c[1, 1, 1] - c[1, 0, 1]) * dg
        + (c[0, 0, 1] - c[0, 0, 0]) * db
        + (c[1, 0, 1] - c[1, 0, 0] - c[0, 0, 1] + c[0, 0, 0]) * dr * db
    )
    case3 = (
        c[0, 0, 0]
        + (c[1, 0, 0] - c[0, 0, 0]) * dr
        + (c[0, 1, 0] - c[0, 0, 0]) * dg
        + (c[1, 1, 1] - c[1, 1, 0]) * db
        + (c[1, 1, 0] - c[1, 0, 0] - c[0, 1, 0] + c[0, 0, 0]) * dr * dg
    )
    return xp.where(m1, case1, xp.where(m2, case2, case3))


def apply_lut_prism(rgb, lut_table, domain_min=(0, 0, 0), domain_max=(1, 1, 1), xp=np):
    """FFmpeg interp_prism: simplex (triangle) interpolation in the (r, b)
    plane, linear along g between the two g-planes."""
    scaled, n = _prepare(rgb, lut_table, domain_min, domain_max, xp)
    prev = xp.floor(scaled).astype(xp.int32)
    nxt = xp.minimum(prev + 1, n - 1)
    d = scaled - prev.astype(scaled.dtype)
    dr, dg, db = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    c = _corners(lut_table, prev, nxt)

    m = db > dr

    def plane(gi):
        # triangle weights over (r, b) within the g=gi plane
        v00 = c[0, gi, 0]
        v01 = c[0, gi, 1]
        v10 = c[1, gi, 0]
        v11 = c[1, gi, 1]
        upper = (1 - db) * v00 + (db - dr) * v01 + dr * v11   # db > dr
        lower = (1 - dr) * v00 + (dr - db) * v10 + db * v11   # dr >= db
        return xp.where(m, upper, lower)

    f0 = plane(0)
    f1 = plane(1)
    return f0 * (1 - dg) + f1 * dg


_FUNCS = {
    "nearest": apply_lut_nearest,
    "trilinear": apply_lut_trilinear,
    "tetrahedral": apply_lut_tetrahedral,
    "pyramid": apply_lut_pyramid,
    "prism": apply_lut_prism,
}


def apply_lut(rgb, lut, interp: str = "tetrahedral", xp=np):
    """Apply a Lut3D (or raw (N,N,N,3) table) to rgb (..., 3) in [0,1].

    Unknown interp names fall back to tetrahedral, mirroring the reference's
    validation fallback (src/lut_renderer/ffmpeg.py:243-244).
    """
    fn = _FUNCS.get(interp, apply_lut_tetrahedral)
    table = getattr(lut, "table", lut)
    dmin = getattr(lut, "domain_min", (0.0, 0.0, 0.0))
    dmax = getattr(lut, "domain_max", (1.0, 1.0, 1.0))
    return fn(rgb, table, dmin, dmax, xp=xp)
