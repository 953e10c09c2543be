"""The host-visible pieces of kernels A and C's design (csrc/planar_lut.cuh,
lut3d.cu, coarse2.cu), each held against the reference on the CPU.

(a) The wrapper's params: launch_args lays out the planes, the table and
    the interps as the C structs read them, and picks the vector path
    from the planes' alignment.
(b) The corner codes and select-based sums of the five interps (a NumPy
    mirror of cell_of and combine) equal colorcore.interp bit for bit, on
    seeded inputs and on ties; so does kernel C's residual term
    (resid_load, resid_sum: each corner's int8 times the scale of its own
    r index) over the dequantised residual table.
(c) The host dispatch: kernel A instantiates each of the 5 interps,
    kernel C each of the 9 (interp, residual interp) pairs, and every
    interp and tier the wrapper passes reaches the instantiation of its
    own pair.
(d) The ctypes mirrors of the params equal the C structs; the wrapper's
    int32 guard and vector-path choice; the probes' stage names, and the
    entries of the render library and of the probes' own; the probe
    imports without jax and without building.

All are bit-exact: the kernels keep the plain version's f32 operations and
their order."""

import re
import subprocess
import sys
from pathlib import Path

import ctypes
import numpy as np
import pytest
import torch

from lut_renderer_tpu.colorcore import interp as cinterp
from lut_renderer_tpu_torch.colorcore import Lut3D
from lut_renderer_tpu_torch.ops import lut3d
from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable

from test_torch_fused420_design import _cell, _tetra_case, _tie_inputs
from torch_parity import DOMAIN, INTERPS, random_lut, rgb_planes

F32 = np.float32
REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "lut_renderer_tpu_torch" / "csrc"


# ---------------------------------------------------------------------------
# (a) the params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["A", "C"])
@pytest.mark.parametrize("offset", [0, 1])
def test_launch_args_lay_out_the_params(kind, offset):
    lut = LutTable.from_lut3d(random_lut(49, seed=3, domain=DOMAIN), "cpu")
    if kind == "C":
        lut = Coarse2Table.from_lut_table(lut, "coarse2f_tri")
    g = torch.Generator().manual_seed(offset)
    base = [torch.rand(160, generator=g) for _ in range(3)]
    planes = [t[offset:offset + 150] for t in base]
    p, out, keep = lut3d.launch_args(*planes, lut, "prism")
    assert (p.npix, p.n, p.vec) == (150, 49, int(offset == 0))
    assert [p.r, p.g, p.b] == [t.data_ptr() for t in planes]
    assert [p.ro, p.go, p.bo] == [t.data_ptr() for t in out]
    assert all(t.shape == planes[0].shape for t in out)
    assert (tuple(p.dmin), tuple(p.dmax)) == (lut.domain_min, lut.domain_max)
    assert p.interp == lut3d.INTERP_CODES["prism"]
    if kind == "C":
        assert (p.m, p.resid_interp) == (25, lut3d.INTERP_CODES["trilinear"])
        assert [p.coarse, p.resid, p.rscale] == [
            lut.coarse.data_ptr(), lut.resid.data_ptr(),
            lut.resid_scale.data_ptr()]
    else:
        assert p.table == lut.table.data_ptr()
    assert keep[3] is lut


# ---------------------------------------------------------------------------
# (b) corner codes and the select-based sums
# ---------------------------------------------------------------------------

def cells(rgb, n, interp, dmin, dmax):
    """NumPy mirror of cell_of: (r0, g0, b0, r1, g1, b1, dr, dg, db, codes
    (P, K), extra) per pixel."""
    top = n - 1
    prev, nxt, d = _cell(rgb, n, dmin, dmax)
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    idx = [prev[:, k] for k in range(3)] + [nxt[:, k] for k in range(3)]
    extra = {}
    p = len(rgb)
    if interp == "nearest":
        x = np.clip(rgb, F32(0), F32(1))
        x = np.clip((x - np.asarray(dmin, F32))
                    / (np.asarray(dmax, F32) - np.asarray(dmin, F32)),
                    F32(0), F32(1)) * F32(n - 1)
        near = np.clip(np.floor(x + F32(0.5)).astype(np.int32), 0, top)
        idx = [near[:, k] for k in range(3)] * 2
        codes = np.zeros((p, 1), np.int32)
    elif interp == "trilinear":
        codes = np.tile(np.arange(8, dtype=np.int32), (p, 1))
    elif interp == "pyramid":
        c1 = (dg > dr) & (db > dr)
        c2 = ~c1 & (dr > dg) & (db > dg)
        extra = dict(c1=c1, c2=c2, c3=~c1 & ~c2)
        codes = np.stack([np.zeros(p, np.int32), np.full(p, 7, np.int32),
                          np.where(c1, 1, 4), np.where(c2, 1, 2),
                          np.where(c1, 3, np.where(c2, 5, 6))], 1)
    elif interp == "prism":
        up = db > dr
        extra = dict(up=up)
        codes = np.stack([np.zeros(p, np.int32), np.where(up, 1, 4),
                          np.full(p, 5, np.int32), np.full(p, 2, np.int32),
                          np.where(up, 3, 6), np.full(p, 7, np.int32)], 1)
    else:
        x, y, z, a, b = _tetra_case(dr, dg, db)
        extra = dict(x=x, y=y, z=z)
        code = [(ax[0].astype(np.int32) << 2) | (ax[1].astype(np.int32) << 1)
                | ax[2].astype(np.int32) for ax in (a, b)]
        codes = np.stack([np.zeros(p, np.int32), code[0], code[1],
                          np.full(p, 7, np.int32)], 1)
    return idx, (dr, dg, db), codes, extra


def corner(idx, code):
    """(r, g, b) of each pixel's corner `code` (P,)."""
    r0, g0, b0, r1, g1, b1 = idx
    return (np.where(code & 4, r1, r0), np.where(code & 2, g1, g0),
            np.where(code & 1, b1, b0))


def combine(interp, v, d, extra):
    """NumPy mirror of combine: v (P, K, 3) corner values in code order."""
    dr, dg, db = (t[:, None] for t in d)
    one = F32(1)
    if interp == "nearest":
        return v[:, 0]
    if interp == "trilinear":
        c = [v[:, 2 * i] * (one - db) + v[:, 2 * i + 1] * db for i in range(4)]
        c0 = c[0] * (one - dg) + c[1] * dg
        c1 = c[2] * (one - dg) + c[3] * dg
        return c0 * (one - dr) + c1 * dr
    if interp == "pyramid":
        c1, c2, c3 = (extra[k][:, None] for k in ("c1", "c2", "c3"))
        d1, pm, qm = v[:, 1] - v[:, 4], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]
        tr = np.where(c1, d1, pm)
        tg = np.where(c2, d1, qm)
        tb = np.where(c1, pm, np.where(c2, qm, d1))
        m1, m2 = np.where(c1, dg, dr), np.where(c3, dg, db)
        return (v[:, 0] + tr * dr + tg * dg + tb * db
                + (v[:, 4] - v[:, 2] - v[:, 3] + v[:, 0]) * m1 * m2)
    if interp == "prism":
        up = extra["up"][:, None]
        w0 = np.where(up, one - db, one - dr)
        w1 = np.where(up, db - dr, dr - db)
        w2 = np.where(up, dr, db)
        f0 = w0 * v[:, 0] + w1 * v[:, 1] + w2 * v[:, 2]
        f1 = w0 * v[:, 3] + w1 * v[:, 4] + w2 * v[:, 5]
        return f0 * (one - dg) + f1 * dg
    x, y, z = (extra[k][:, None] for k in ("x", "y", "z"))
    return ((one - x) * v[:, 0] + (x - y) * v[:, 1] + (y - z) * v[:, 2]
            + z * v[:, 3])


def _inputs(n, dmax, seed):
    rgb = np.concatenate([
        np.moveaxis(rgb_planes(seed, (16, 32)), 0, -1).reshape(-1, 3),
        _tie_inputs(n, dmax)])
    rgb[:6, 2] = F32(1.0)  # the top edge
    return rgb.astype(F32)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("n,domain", [(17, DOMAIN), (33, None)])
def test_corner_codes_and_sums_equal_colorcore(interp, n, domain):
    lut = random_lut(n, seed=n + 1, domain=domain)
    dmin, dmax = lut.domain_min, lut.domain_max
    rgb = _inputs(n, dmax, n)
    idx, d, codes, extra = cells(rgb, n, interp, dmin, dmax)
    v = np.stack([lut.table[corner(idx, codes[:, j])]
                  for j in range(codes.shape[1])], 1)
    got = combine(interp, v, d, extra)
    want = cinterp.apply_lut(rgb, lut, interp)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("n,tier", [(49, "coarse2x"), (65, "coarse2f")])
def test_residual_corners_and_scales_equal_colorcore(interp, n, tier):
    """resid_load and resid_sum: each corner's int8 times the scale of its
    own r index (r1 where the code has bit 4), summed by combine, equals
    colorcore.interp over the dequantised residual table."""
    t = Coarse2Table.from_lut_table(
        LutTable.from_lut3d(random_lut(n, seed=5, domain=DOMAIN), "cpu"),
        tier)
    rgb = _inputs(n, t.domain_max, 6)
    idx, d, codes, extra = cells(rgb, n, interp, t.domain_min, t.domain_max)
    q = t.resid.numpy()[..., :3].astype(F32)
    scale = t.resid_scale.numpy()[:, :3]
    v = np.stack([q[corner(idx, codes[:, j])]
                  * scale[np.where(codes[:, j] & 4, idx[3], idx[0])]
                  for j in range(codes.shape[1])], 1)
    got = combine(interp, v, d, extra)
    table = q * scale[:, None, None]
    assert np.array_equal(table, t.resid_table().numpy()[..., :3])
    want = cinterp.apply_lut(
        rgb, Lut3D(table=table, domain_min=np.asarray(t.domain_min, F32),
                   domain_max=np.asarray(t.domain_max, F32)), interp)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (c) the host dispatch
# ---------------------------------------------------------------------------

def _dispatch(source: str, arity: int):
    """{case label: [instantiations in the order of the return]} of an
    entry point's switch, label None for ``default``."""
    cases = re.split(r"\n\s*(case lutk::k\w+:|default:)", source)
    pat = r"run<" + ", ".join([r"lutk::k(\w+)"] * arity) + ">"
    out = {}
    for label, body in zip(cases[1::2], cases[2::2]):
        key = re.match(r"case lutk::k(\w+):", label)
        out[key.group(1).lower() if key else None] = [
            tuple(x.lower() for x in m) if arity > 1 else m.lower()
            for m in re.findall(pat, body)]
    return out


def test_kernel_a_instantiates_each_interp():
    table = _dispatch((CSRC / "lut3d.cu").read_text(), 1)
    assert sorted(sum(table.values(), [])) == sorted(INTERPS)
    for interp in INTERPS:
        key = interp if interp in table else None
        assert table[key] == [interp]


def _kernel_c_choice(table, interp, resid):
    """The (interp, residual interp) instantiation coarse2_launch runs:
    the first of a ``tri ? ... : ...`` pair when the residual interp is
    trilinear."""
    runs = table[interp if interp in table else None]
    return runs[0] if resid == "trilinear" else runs[-1]


def test_kernel_c_instantiates_nine_pairs():
    table = _dispatch((CSRC / "coarse2.cu").read_text(), 2)
    pairs = set(sum(table.values(), []))
    assert pairs == ({(i, i) for i in INTERPS}
                     | {(i, "trilinear") for i in INTERPS})
    assert len(pairs) == 9


@pytest.mark.parametrize("tier", ["coarse2f", "coarse2", "coarse2x",
                                  "coarse2_tri", "coarse2f_tri",
                                  "coarse2x_tri"])
def test_every_interp_and_tier_reaches_its_instantiation(tier):
    table = _dispatch((CSRC / "coarse2.cu").read_text(), 2)
    lut = Coarse2Table.from_lut_table(
        LutTable.from_lut3d(random_lut(49, seed=2), "cpu"), tier)
    for interp in INTERPS + ("unknown",):
        run = lut3d.canonical_interp(interp)
        resid = lut3d.resid_interp_for(lut, interp)
        assert resid == ("trilinear" if tier.endswith("_tri") else run)
        assert _kernel_c_choice(table, run, resid) == (run, resid)


# ---------------------------------------------------------------------------
# (d) params, guards and the probe
# ---------------------------------------------------------------------------

_CTYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const float4*": ctypes.c_void_p, "const char4*": ctypes.c_void_p,
           "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "float": ctypes.c_float}


def c_struct_fields(name: str):
    """[(field, ctypes type)] of `struct name` in csrc/planar_lut.cuh."""
    src = (CSRC / "planar_lut.cuh").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*(\w+)(?:\[(\d+)\])?;", line)
        ctype = _CTYPES[m.group(1).replace(" *", "*").strip()]
        fields.append((m.group(2),
                       ctype * int(m.group(3)) if m.group(3) else ctype))
    return fields


@pytest.mark.parametrize("struct,mirror", [("Lut3dParams", lut3d._Lut3dParams),
                                           ("Coarse2Params",
                                            lut3d._Coarse2Params)])
def test_ctypes_mirrors_match_the_c_structs(struct, mirror):
    want = c_struct_fields(struct)
    got = list(mirror._fields_)
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, a), (_, e) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(e)
        assert getattr(a, "_type_", a) == getattr(e, "_type_", e)


def test_int32_guard_and_vector_path():
    lut3d.check_pixel_count((1 << 31) - 1)
    with pytest.raises(ValueError, match="int32"):
        lut3d.check_pixel_count(1 << 31)
    plane = torch.zeros(64)
    assert lut3d.vector_io(plane, plane[4:])
    assert not lut3d.vector_io(plane, plane[1:])


def test_stage_entry_points():
    from lut_renderer_tpu_torch.ops import _build
    from lut_renderer_tpu_torch.probes import harness, kernel_ac, kernel_b

    exact = LutTable.from_lut3d(random_lut(5, seed=1), "cpu")
    big = Coarse2Table.from_lut_table(
        LutTable.from_lut3d(random_lut(49, seed=1), "cpu"), "coarse2f")
    assert kernel_ac.entry_point(exact, "full") == "lut3d_launch"
    assert kernel_ac.entry_point(big, "resid") == "coarse2_resid_launch"
    with pytest.raises(ValueError):
        kernel_ac.entry_point(exact, "coarse")
    with pytest.raises(ValueError):
        kernel_ac.entry_point(big, "color")
    with pytest.raises(ValueError):
        kernel_b.entry_point(exact, "weights")
    r = torch.zeros(8)
    with pytest.raises(ValueError, match="tetrahedral"):
        kernel_ac.prepared_launch(r, r, r, exact, "trilinear", "io")
    # full launches from the render library, a stage from the probes'
    for probe in (kernel_ac, kernel_b):
        for table in (exact, big):
            for stage in probe.STAGES:
                try:
                    name = probe.entry_point(table, stage)
                except ValueError:
                    assert probe is kernel_ac and table is exact
                    assert stage in ("coarse", "resid")
                    continue
                lib = (_build.ENTRY_POINTS if stage == "full"
                       else harness.PROBE_ENTRY_POINTS)
                assert name in lib, (stage, name)
    assert lut3d.entry_point(big) == "coarse2_launch"


_EXTERN = re.compile(r'extern "C".*\bint\s+(\w+)\(')
_MACRO = re.compile(r"#define\s+(\w+)\((\w+),")


def _c_entries(path):
    """The extern "C" functions a CUDA source defines, directly or through
    a macro of its own."""
    text = path.read_text()
    names = _EXTERN.findall(text)
    for macro, param in _MACRO.findall(text):
        if param in names:  # the macro's body, not an entry
            names.remove(param)
            names += re.findall(rf"^{macro}\((\w+),", text, re.M)
    return names


def test_each_library_defines_exactly_its_entries():
    """The render library's sources define its entries, each in one file,
    and nothing else; the probes' sources define exactly their 8 stage
    entries; every source of csrc/ is in one of the two."""
    from lut_renderer_tpu_torch.ops import _build
    from lut_renderer_tpu_torch.probes import harness

    render = {s: _c_entries(_build.CSRC / s) for s in _build.SOURCES}
    for name in _build.ENTRY_POINTS:
        assert len([s for s, e in render.items() if name in e]) == 1, name
    assert sorted(n for e in render.values() for n in e) == sorted(
        _build.ENTRY_POINTS)
    probes = [n for s in harness.PROBE_SOURCES
              for n in _c_entries(_build.CSRC / s)]
    assert len(probes) == 8
    assert sorted(probes) == sorted(harness.PROBE_ENTRY_POINTS)
    assert set(_build.SOURCES) | set(harness.PROBE_SOURCES) == {
        p.name for p in _build.CSRC.glob("*.cu")}


def test_probe_imports_without_jax_or_a_build():
    code = (
        "import sys\n"
        "from lut_renderer_tpu_torch.probes import kernel_ac, kernel_b\n"
        "from lut_renderer_tpu_torch.ops import _build\n"
        "assert _build._LIB is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lut_renderer_tpu')]\n"
        "assert not bad, bad\n"
        "assert kernel_ac.main([]) == 1 and kernel_b.main([]) == 1\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
    assert "runs on the card only" in res.stderr
