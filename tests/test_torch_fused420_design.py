"""The host-visible pieces of kernel B's design (csrc/fused420.cu,
csrc/lut_interp.cuh), each held against the reference on the CPU.

(a) The select-based tetrahedral: sorted deltas x >= y >= z chosen by the
    strict comparisons, the two middle corners' offsets, one sum
    (1 - x)*c000 + (x - y)*cA + (y - z)*cB + z*c111. Its NumPy mirror
    equals colorcore.interp's six-case tetrahedral and the JAX gather path
    bit for bit, on seeded inputs and on ties (dr == dg, dg == db, all
    equal, 0 and 1, the domain max); the select-based corner weights of
    the coarse2 term equal the branchy ones.
(b) The per-code tables each block computes (range normalisation, the
    requantise and the per-code division of YUV -> RGB) equal the
    per-pixel formula of render_fused420_reference for every code.
(c) The launch geometry (ops/fused420.launch_geometry) with the kernel's
    unit -> pixel mapping covers every luma pixel and every output chroma
    site exactly once.
(d) The kernel's division by an output-matrix constant (a reciprocal, a
    product and two FMA corrections, csrc/fused420.cuh Divisor) equals the
    IEEE division, each FMA evaluated exactly in rational arithmetic.

All three are bit-exact: the kernel keeps the reference's f32 operations
and their order."""

import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch

from lut_renderer_tpu.colorcore import interp as cinterp
from lut_renderer_tpu.ops.lut3d import apply_lut_planes as jax_apply
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.colorcore import matrices as cm
from lut_renderer_tpu_torch.ops import fused420, pixel
from lut_renderer_tpu_torch.ops.render import RenderConfig

from torch_parity import DOMAIN, random_lut, rgb_planes

F32 = np.float32


# ---------------------------------------------------------------------------
# (a) the tetrahedral as selects
# ---------------------------------------------------------------------------

def _cell(rgb, n, dmin, dmax):
    """colorcore.interp._prepare, then PREV/NEXT and the deltas, per
    channel: (prev, next, d) each (..., 3)."""
    x = np.clip(rgb, F32(0), F32(1))
    x = np.clip((x - np.asarray(dmin, F32)) / (np.asarray(dmax, F32)
                                              - np.asarray(dmin, F32)),
                F32(0), F32(1))
    scaled = x * F32(n - 1)
    prev = np.floor(scaled).astype(np.int32)
    return prev, np.minimum(prev + 1, n - 1), scaled - prev.astype(F32)


def _tetra_case(dr, dg, db):
    """lut_interp.cuh tetra_case: (x, y, z, A's axes, B's axes)."""
    rg, gb, rb, bg, br = dr > dg, dg > db, dr > db, db > dg, db > dr
    ar = rg & (gb | rb)
    ag = ~rg & ~bg
    ab = ~ar & ~ag
    zg = rg & ~gb
    zr = ~rg & (bg | br)
    zb = ~zg & ~zr
    yr, yg = ~ar & ~zr, ~ag & ~zg
    x = np.where(ar, dr, np.where(ag, dg, db))
    y = np.where(yr, dr, np.where(yg, dg, db))
    z = np.where(zr, dr, np.where(zg, dg, db))
    return x, y, z, (ar, ag, ab), (~zr, ~zg, ~zb)


def tetra_select(rgb, table, dmin=(0, 0, 0), dmax=(1, 1, 1)):
    """NumPy mirror of interp_cell<kTetrahedral>: (..., 3) rgb -> (..., 3)."""
    n = table.shape[0]
    prev, nxt, d = _cell(rgb, n, dmin, dmax)
    dr, dg, db = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    x, y, z, a, b = _tetra_case(dr, dg, db)

    def corner(axes):
        idx = [np.where(axes[k][..., 0], nxt[..., k], prev[..., k])
               for k in range(3)]
        return table[idx[0], idx[1], idx[2]]

    c000 = table[prev[..., 0], prev[..., 1], prev[..., 2]]
    c111 = table[nxt[..., 0], nxt[..., 1], nxt[..., 2]]
    return ((F32(1) - x) * c000 + (x - y) * corner(a) + (y - z) * corner(b)
            + z * c111)


def _tie_inputs(n, dmax):
    """(P, 3) rgb whose deltas tie: r == g, g == b, all three equal, grid
    points (every delta 0), 0 and 1, and the domain max."""
    rng = np.random.default_rng(n)
    v = rng.uniform(0, 1, 64).astype(F32)
    w = rng.uniform(0, 1, 64).astype(F32)
    grid = (np.arange(n, dtype=F32) / F32(n - 1))
    rows = [np.stack([v, v, w], -1), np.stack([w, v, v], -1),
            np.stack([v, w, v], -1), np.stack([v, v, v], -1),
            np.stack([grid, grid[::-1], grid], -1),
            np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1]], F32),
            np.tile(np.asarray(dmax, F32), (4, 1))]
    # ties inside one cell: the same fraction on each axis, other cells
    frac = rng.uniform(0, 1, 32).astype(F32)
    cells = rng.integers(0, n - 1, (32, 3)).astype(F32)
    rows.append((cells + frac[:, None]) / F32(n - 1))
    return np.concatenate(rows).astype(F32)


@pytest.mark.parametrize("n,domain", [(2, None), (17, None), (33, None),
                                      (17, DOMAIN)])
def test_tetra_select_equals_six_cases(n, domain):
    lut = random_lut(n, seed=n, domain=domain)
    dmin, dmax = lut.domain_min, lut.domain_max
    rgb = np.concatenate([
        np.moveaxis(rgb_planes(n, (16, 32)), 0, -1).reshape(-1, 3),
        _tie_inputs(n, dmax)])
    got = tetra_select(rgb, lut.table, dmin, dmax)
    want = cinterp.apply_lut_tetrahedral(rgb, lut.table, dmin, dmax)
    np.testing.assert_array_equal(got, want)
    jout = jax_apply(*rgb.T.copy(), prepare_lut(lut), "tetrahedral",
                     strategy="gather")
    np.testing.assert_array_equal(got, np.stack([np.asarray(c) for c in jout],
                                                -1))


def _weights_branchy(dr, dg, db):
    """The six-case corner weights of the tetrahedral, as branches: (8,)
    in corner order (r, g, b) = 000, 001, ..., 111."""
    w = np.zeros((2, 2, 2), F32)
    one = F32(1)
    if dr > dg:
        if dg > db:
            w[0, 0, 0], w[1, 0, 0], w[1, 1, 0], w[1, 1, 1] = (
                one - dr, dr - dg, dg - db, db)
        elif dr > db:
            w[0, 0, 0], w[1, 0, 0], w[1, 0, 1], w[1, 1, 1] = (
                one - dr, dr - db, db - dg, dg)
        else:
            w[0, 0, 0], w[0, 0, 1], w[1, 0, 1], w[1, 1, 1] = (
                one - db, db - dr, dr - dg, dg)
    elif db > dg:
        w[0, 0, 0], w[0, 0, 1], w[0, 1, 1], w[1, 1, 1] = (
            one - db, db - dg, dg - dr, dr)
    elif db > dr:
        w[0, 0, 0], w[0, 1, 0], w[0, 1, 1], w[1, 1, 1] = (
            one - dg, dg - db, db - dr, dr)
    else:
        w[0, 0, 0], w[0, 1, 0], w[1, 1, 0], w[1, 1, 1] = (
            one - dg, dg - dr, dr - db, db)
    return w.reshape(8)


def _weights_select(dr, dg, db):
    """NumPy mirror of cell_weights<kTetrahedral>, vectorised: (P, 8)."""
    x, y, z, a, b = _tetra_case(dr, dg, db)
    w = np.zeros(dr.shape + (8,), F32)
    for i, j, k in itertools.product((0, 1), repeat=3):
        is_a = (a[0] == i) & (a[1] == j) & (a[2] == k)
        is_b = (b[0] == i) & (b[1] == j) & (b[2] == k)
        w[..., 4 * i + 2 * j + k] = np.where(is_a, x - y,
                                             np.where(is_b, y - z, F32(0)))
    w[..., 0] = F32(1) - x
    w[..., 7] = z
    return w


def test_cell_weights_select_equals_branchy():
    n = 33
    rgb = np.concatenate([
        np.moveaxis(rgb_planes(3, (16, 32)), 0, -1).reshape(-1, 3),
        _tie_inputs(n, (1, 1, 1))])
    _, _, d = _cell(rgb, n, (0, 0, 0), (1, 1, 1))
    got = _weights_select(d[:, 0], d[:, 1], d[:, 2])
    want = np.stack([_weights_branchy(*row) for row in d])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (b) the per-code tables
# ---------------------------------------------------------------------------

def code_tables(cfg):
    """The block prologue of csrc/fused420.cu in NumPy f32, the kernel's
    constants rounded to f32 as ctypes rounds them: (yn, cn) for every
    code value below min(2^in_depth, 1024)."""
    k = {name: F32(v) for name, v in fused420.kernel_constants(cfg).items()}
    codes = np.arange(min(1 << cfg.in_depth, 1024), dtype=F32)

    def norm(x, sub, mul, add, off, scale):
        if int(k["normalize"]):
            x = (x - sub) * mul + add
            if int(k["requant"]):
                x = np.minimum(np.maximum(np.floor(x + F32(0.5)), F32(0)),
                               k["maxv_in"])
        return (x - off) / scale

    yn = norm(codes, k["norm_ysub"], k["norm_ymul"], k["norm_yadd"],
              k["in_yoff"], k["in_yscale"])
    cn = norm(codes, k["norm_cmid"], k["norm_cmul"], k["norm_cmid"],
              k["in_cmid"], k["in_cscale"])
    return yn, cn


def _reference_planes(cfg, y, u, v):
    """render_planes' steps up to the LUT, on co-sited planes."""
    yf, uf, vf = pixel.range_normalize(y, u, v, cfg.in_depth,
                                       cfg.in_full_range, cfg.work_full_range)
    if cfg.requantize_intermediate and cfg.in_full_range != cfg.work_full_range:
        maxv = float((1 << cfg.in_depth) - 1)
        yf, uf, vf = (torch.clip(torch.floor(t + 0.5), 0, maxv)
                      for t in (yf, uf, vf))
    return yf, uf, vf


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("in_full,work_full", [(False, False), (True, False),
                                               (False, True)])
@pytest.mark.parametrize("requant", [True, False])
def test_code_tables_equal_per_pixel_formula(depth, in_full, work_full,
                                             requant):
    for matrix in ("bt709", "bt601", "bt2020nc"):
        cfg = RenderConfig(in_depth=depth, in_full_range=in_full,
                           work_full_range=work_full,
                           requantize_intermediate=requant, matrix_in=matrix)
        yn, cn = code_tables(cfg)
        codes = torch.arange(len(yn), dtype=torch.float32)
        yf, uf, _ = _reference_planes(cfg, codes, codes, codes)
        y_off, y_scale, c_mid, c_scale = cm._range_params(depth, work_full)
        np.testing.assert_array_equal(yn, ((yf - y_off) / y_scale).numpy())
        np.testing.assert_array_equal(cn, ((uf - c_mid) / c_scale).numpy())

        # the kernel's per-pixel RGB from the tables, every code in every
        # plane, against the reference's yuv_to_rgb_planes
        rng = np.random.default_rng(depth)
        y, u, v = (torch.from_numpy(np.asarray(c, np.int64)) for c in
                   (np.arange(len(yn)), rng.permutation(len(yn)),
                    rng.permutation(len(yn))))
        k = {name: F32(val) for name, val in
             fused420.kernel_constants(cfg).items()}
        ynp, unp, vnp = yn[y.numpy()], cn[u.numpy()], cn[v.numpy()]
        clip = lambda t: np.minimum(np.maximum(t, F32(0)), F32(1))  # noqa: E731
        got = (clip(ynp + k["in_crv"] * vnp), clip(ynp - k["in_gv"] * vnp
                                                   - k["in_gu"] * unp),
               clip(ynp + k["in_cbu"] * unp))
        want = pixel.yuv_planes_to_rgb(
            *_reference_planes(cfg, *(t.float() for t in (y, u, v))),
            matrix, depth, work_full)
        for a, e in zip(got, want):
            np.testing.assert_array_equal(a, e.numpy())


# ---------------------------------------------------------------------------
# (c) the launch geometry
# ---------------------------------------------------------------------------

def _written(geom, batch, height, width, out_sx, out_sy):
    """How often the kernel's unit loop writes each luma pixel and each
    output chroma site: its index arithmetic, unit by unit."""
    hc_out, wc_out = height >> out_sy, width >> out_sx
    cols = fused420.UNIT_COLS if geom.vec else fused420.SCALAR_COLS
    assert geom.cols == cols
    sites = cols >> out_sx
    unit = np.arange(geom.units)
    t = unit // geom.units_per_row
    c0 = (unit - t * geom.units_per_row) * cols
    bb = t // hc_out
    i = t - bb * hc_out
    if geom.vec:  # every vector lies inside its row
        assert (c0 + cols <= width).all()
        assert ((c0 >> out_sx) + sites <= wc_out).all()
    luma = np.zeros((batch, height, width), np.int64)
    chroma = np.zeros((batch, hc_out, wc_out), np.int64)
    for dy in range(1 << out_sy):
        for c in range(cols):
            ok = c0 + c < width
            np.add.at(luma, (bb[ok], ((i << out_sy) + dy)[ok], (c0 + c)[ok]),
                      1)
    for s in range(sites):
        col = (c0 >> out_sx) + s
        ok = col < wc_out
        np.add.at(chroma, (bb[ok], i[ok], col[ok]), 1)
    return luma, chroma


_SUBS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


@pytest.mark.parametrize("width", [1920, 3840, 641, 1922])
@pytest.mark.parametrize("batch", [1, 3])
def test_launch_geometry_covers_every_site_once(width, batch):
    height = 6
    seen = 0
    for in_sub, out_sub in itertools.product(_SUBS, repeat=2):
        cfg = RenderConfig(in_subsampling=in_sub, out_subsampling=out_sub)
        sx, sy = _SUBS[in_sub]
        y = torch.zeros((batch, height, width), dtype=torch.uint8)
        u = torch.zeros((batch, height >> sy, width >> sx), dtype=torch.uint8)
        if not fused420.fused420_applicable(y, u, cfg, object()):
            assert width % 2 and (in_sub, out_sub) != ("444", "444")
            continue
        out_sx, out_sy = _SUBS[out_sub]
        for aligned in (True, False):
            geom = fused420.launch_geometry(batch, height, width, out_sy,
                                            aligned)
            assert geom.vec == (aligned and width % 8 == 0)
            luma, chroma = _written(geom, batch, height, width, out_sx,
                                    out_sy)
            assert (luma == 1).all(), (in_sub, out_sub, width)
            assert (chroma == 1).all(), (in_sub, out_sub, width)
            seen += 1
    assert seen >= 2


def test_launch_geometry_rejects_frames_past_int32():
    with pytest.raises(ValueError):
        fused420.launch_geometry(1, 1 << 16, 1 << 15, 1, True)
    with pytest.raises(ValueError):
        fused420.launch_geometry(1 << 12, 1 << 14, 1 << 14, 0, True)


# ---------------------------------------------------------------------------
# (d) the division sequence
# ---------------------------------------------------------------------------

def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even, subnormals kept."""
    if x == 0:
        return F32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    e = max(e, -126)  # 2^e <= x < 2^(e+1), or the subnormal range
    m = x / Fraction(2) ** (e - 23)  # 24 significant bits before the point
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return F32(sign * n * 2.0 ** (e - 23))


def _fma(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def divide(a, c, y):
    """Divisor::div: q = a y, then q += (a - c q) y twice, by FMA."""
    q = F32(a) * F32(y)
    q = _fma(_fma(-c, q, a), y, q)
    return _fma(_fma(-c, q, a), y, q)


@pytest.mark.parametrize("matrix", ["bt709", "bt601", "bt2020nc"])
def test_division_sequence_equals_ieee_division(matrix):
    rng = np.random.default_rng(len(matrix))
    # numerators o.x - yo_n and o.z - yo_n: within [-1, 1], plus their
    # edges, exact quotients and tiny values
    a = np.concatenate([
        rng.uniform(-1, 1, 1500).astype(F32),
        (rng.integers(-1 << 20, 1 << 20, 300) * F32(2.0 ** -20)).astype(F32),
        np.array([0, 1, -1, 0.5, 2.0 ** -60, -(2.0 ** -60), 1 - 2.0 ** -24],
                 F32)])
    k = fused420.kernel_constants(RenderConfig(matrix_out=matrix))
    for c in (F32(k["out_crv"]), F32(k["out_cbu"])):
        y = F32(1) / c
        a = np.concatenate([a, (c * a[:200]).astype(F32)])
        got = np.array([divide(x, c, y) for x in a], F32)
        np.testing.assert_array_equal(got, a / c)
