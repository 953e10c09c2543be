"""Parity contract 3 on the port: FFmpeg's own lut3d filter (the bundled
libavfilter, driven by the port's copy of hostio/oracle.py) against the
port's plain LUT twin and its whole-frame render on the CPU.

Mirrors tests/test_oracle_parity.py, tests/test_bigcube.py's oracle cases
and tests/test_chain_parity.py case for case, with their bounds: dE76 <
0.01 and max |d| < 1e-5 on float planes for the exact table, 2 16-bit
LSBs on the rgb48 path, dE76 < 0.5 (the contract's budget) for the
reduced coarse2 tiers, and each chain case's max |d| / mean |d| in code
values. The chain cases run on the fused layout (kernel B's plain twin on
CPU tensors) and on the plain layout (kernel A's). A test skips only
where hostio reports that the FFmpeg libraries do not load.
"""

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch.colorcore import (
    Lut3D,
    max_delta_e76,
    parse_cube_file,
    write_cube_file,
)
from lut_renderer_tpu_torch.hostio.ffi import FFIUnavailable, get_ffi
from lut_renderer_tpu_torch.hostio.oracle import ChainOracle, Lut3DOracle
from lut_renderer_tpu_torch.ops.lut3d import apply_lut_planes
from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig, render_yuv_frame

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

INTERPS = ("tetrahedral", "trilinear", "nearest", "pyramid", "prism")
LAYOUTS = ("fused", "plain")


@pytest.fixture(autouse=True)
def ffmpeg_libs():
    """Skips where hostio cannot load the FFmpeg libraries."""
    try:
        get_ffi()
    except FFIUnavailable as exc:
        pytest.skip(f"FFmpeg libraries unavailable: {exc}")


def _perturbed(n, amp, seed):
    rng = np.random.default_rng(seed)
    lut = Lut3D.identity(n)
    lut.table = np.clip(
        lut.table + rng.uniform(-amp, amp, lut.table.shape).astype(np.float32),
        0, 1)
    return lut


def _cube(tmp_path_factory, name, lut):
    """The LUT written as a .cube, and the port's table parsed from that
    file: what FFmpeg reads is what the port renders."""
    path = write_cube_file(tmp_path_factory.mktemp("oracle") / name, lut)
    return path, LutTable.from_lut3d(parse_cube_file(path), "cpu")


def _port(rgb, table, interp):
    """(H, W, 3) float32 through the port's LUT on CPU tensors."""
    planes = [torch.from_numpy(np.ascontiguousarray(rgb[..., c]))
              for c in range(3)]
    return np.stack([p.numpy() for p in apply_lut_planes(*planes, table,
                                                         interp)], -1)


def _ffmpeg(path, rgb, interp):
    h, w = rgb.shape[:2]
    with Lut3DOracle(path, interp, "gbrpf32le", w, h) as oracle:
        return oracle.apply_rgb_float(rgb)


def _de76(a, b):
    return max_delta_e76(np.clip(a, 0, 1), np.clip(b, 0, 1))


@pytest.fixture(scope="module")
def cube33(tmp_path_factory):
    return _cube(tmp_path_factory, "p33.cube", _perturbed(33, 0.05, 7))


# ---- the LUT alone, float planes (tests/test_oracle_parity.py) ------------

@pytest.mark.parametrize("interp", INTERPS)
def test_port_lut_vs_ffmpeg_lut3d(cube33, interp):
    path, table = cube33
    rgb = np.random.default_rng(1234).uniform(0, 1, (128, 128, 3)) \
        .astype(np.float32)
    ffm, ours = _ffmpeg(path, rgb, interp), _port(rgb, table, interp)
    de = _de76(ffm, ours)
    assert de < 0.01, f"{interp}: dE76 {de} (budget is 0.5; we hold 0.01)"
    assert float(np.abs(ffm - ours).max()) < 1e-5


def test_port_lut_gradient_extremes(cube33):
    """Lattice-edge and extreme inputs through the real filter."""
    path, table = cube33
    ramp = np.linspace(0, 1, 128 * 128, dtype=np.float32)
    rgb = np.stack([ramp, ramp[::-1], np.abs(1 - 2 * ramp)], -1) \
        .reshape(128, 128, 3)
    ffm = _ffmpeg(path, rgb, "tetrahedral")
    assert _de76(ffm, _port(rgb, table, "tetrahedral")) < 0.01


def test_port_lut_rgb48_path(cube33):
    """FFmpeg's integer path (rgb48, the format it takes for 8- and 10-bit
    video): the port on normalised input within 2 16-bit LSBs."""
    path, table = cube33
    rgb16 = np.random.default_rng(3).integers(0, 65536, (64, 64, 3),
                                              dtype=np.uint16)
    with Lut3DOracle(path, "tetrahedral", "rgb48le", 64, 64) as oracle:
        out16 = oracle.apply_rgb48(rgb16)
    ours = _port(rgb16.astype(np.float32) / 65535.0, table, "tetrahedral")
    got = out16.astype(np.float32) / 65535.0
    assert float(np.abs(got - ours).max()) < 2.0 / 65535.0


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
def test_port_lut_65cube(tmp_path_factory, interp):
    """65^3 (config 2's size)."""
    path, table = _cube(tmp_path_factory, "p65.cube",
                        _perturbed(65, 0.03, 13))
    rgb = np.random.default_rng(13).uniform(0, 1, (64, 64, 3)) \
        .astype(np.float32)
    assert _de76(_ffmpeg(path, rgb, interp), _port(rgb, table, interp)) < 0.01


# ---- the big-cube class, exact and coarse2 tables (tests/test_bigcube.py) -

_BIG = {97: (11, 64), 129: (13, 32)}  # N: (LUT seed, frame side)


@pytest.fixture(scope="module")
def bigcube(tmp_path_factory):
    """N -> (.cube path, the port's exact table, seeded (S, S, 3) RGB)."""
    out = {}
    for n, (seed, side) in _BIG.items():
        path, table = _cube(tmp_path_factory, f"p{n}.cube",
                            _perturbed(n, 0.03, seed))
        rgb = np.random.default_rng(seed).uniform(0, 1, (side, side, 3)) \
            .astype(np.float32)
        out[n] = (path, table, rgb)
    return out


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("tier", ["exact", "coarse2f", "coarse2x"])
@pytest.mark.parametrize("n", sorted(_BIG))
def test_port_bigcube_vs_ffmpeg_lut3d(bigcube, n, tier, interp):
    """The exact table holds the float bound (dE76 < 0.01); the coarse +
    residual tables, like the JAX package's reduced tiers at 129^3, the
    contract's budget (dE76 < 0.5)."""
    path, table, rgb = bigcube[n]
    if tier != "exact":
        table = Coarse2Table.from_lut_table(table, tier)
    de = _de76(_ffmpeg(path, rgb, interp), _port(rgb, table, interp))
    assert de < (0.01 if tier == "exact" else 0.5), (n, tier, interp, de)


# ---- the whole frame against FFmpeg's filter chain ------------------------
# (tests/test_chain_parity.py: scale tagging -> [format] -> lut3d -> format)

H, W = 72, 96


def _smooth_planes(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    y = 16 + 200 * (0.5 + 0.4 * np.sin(xx / w * 5 + rng.uniform(0, 6))
                    * np.cos(yy / h * 4))
    u = 128 + 90 * np.sin(xx / w * 3)[0:h:2, 0:w:2]
    v = 128 + 90 * np.cos(yy / h * 2)[0:h:2, 0:w:2]
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def grade(tmp_path_factory):
    """A smooth 17^3 grade: (.cube path, the port's table)."""
    n = 17
    ax = np.linspace(0, 1, n, dtype=np.float64)
    r, g, b = np.meshgrid(ax, ax, ax, indexing="ij")
    tbl = np.stack(
        [np.clip(r ** 0.92 * 1.05, 0, 1),
         np.clip(g * 0.97 + 0.01, 0, 1),
         np.clip(b ** 1.06 * 0.95 + 0.02, 0, 1)],
        axis=-1).astype(np.float32)
    return _cube(tmp_path_factory, "grade.cube", Lut3D(table=tbl))


def _escape(p) -> str:
    return str(p).replace("\\", "\\\\").replace("'", "\\'")


def _chain(filters, y, u, v, pix_fmt="yuv420p"):
    with ChainOracle(W, H, filters, pix_fmt=pix_fmt) as orc:
        return orc.apply_yuv(y, u, v)


def _ours(y, u, v, table, layout, **kw):
    """render_yuv_frame on CPU tensors, with the JAX chain tests'
    RenderConfig fields; "fused" is forced, so a config kernel B cannot
    take raises instead of falling back."""
    cfg = RenderConfig(lut_strategy="gather", lut_precision="exact",
                       phase_layout=layout, **kw)
    out = render_yuv_frame(*(torch.from_numpy(p) for p in (y, u, v)), table,
                           cfg)
    return tuple(o.numpy() for o in out)


def _assert_close(ffm, ours, max_y, max_c, mean_y):
    for name, a, b, lim in (("y", ffm[0], ours[0], max_y),
                            ("u", ffm[1], ours[1], max_c),
                            ("v", ffm[2], ours[2], max_c)):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                           b.shape)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= lim, f"{name}: max|d|={d.max()} > {lim}"
    dy = np.abs(ffm[0].astype(np.int32) - ours[0].astype(np.int32))
    assert dy.mean() <= mean_y, f"y mean|d|={dy.mean():.3f} > {mean_y}"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
def test_chain_bt709_tagged(grade, interp, layout):
    """The production case: scale tags bt709, lut3d converts via the tag."""
    path, table = grade
    y, u, v = _smooth_planes()
    ffm = _chain([("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
                  ("lut3d", f"file='{_escape(path)}':interp={interp}"),
                  ("format", "pix_fmts=yuv420p")], y, u, v)
    _assert_close(ffm, _ours(y, u, v, table, layout, interp=interp),
                  max_y=3, max_c=2, mean_y=1.8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chain_untagged_uses_bt601(grade, layout):
    """Without the scale tag FFmpeg's auto-inserted conversion falls back
    to bt601, the matrix the policy models for untagged sources; bt709
    does not match, so the tagged case is not vacuous."""
    path, table = grade
    y, u, v = _smooth_planes(seed=1)
    ffm = _chain([("lut3d", f"file='{_escape(path)}':interp=tetrahedral"),
                  ("format", "pix_fmts=yuv420p")], y, u, v)
    _assert_close(ffm, _ours(y, u, v, table, layout, matrix_in="bt601",
                             matrix_out="bt601"),
                  max_y=3, max_c=2, mean_y=1.8)
    oy = _ours(y, u, v, table, layout)[0]
    assert np.abs(ffm[0].astype(np.int32) - oy.astype(np.int32)).max() > 5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chain_residual_is_ffmpeg_8bit_intermediate(grade, layout):
    """FFmpeg through a 16-bit RGB intermediate: luma within 2 and
    frac(|d| > 1) <= 1e-3, so the tagged chain's residual is FFmpeg's own
    8-bit RGB quantisation (the port stays f32)."""
    path, table = grade
    y, u, v = _smooth_planes()
    ffm = _chain([("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
                  ("format", "pix_fmts=gbrp16le"),
                  ("lut3d", f"file='{_escape(path)}':interp=tetrahedral"),
                  ("format", "pix_fmts=yuv420p")], y, u, v)
    ours = _ours(y, u, v, table, layout)
    dy = np.abs(ffm[0].astype(np.int32) - ours[0].astype(np.int32))
    assert dy.max() <= 2
    assert (dy > 1).mean() <= 1e-3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chain_fullrange_normalization(grade, layout):
    """A full-range source: scale=in_range=pc:out_range=tv and a format
    step before lut3d, against in_full_range + requantize_intermediate."""
    path, table = grade
    y, u, v = _smooth_planes(seed=2)
    ffm = _chain([("scale", "in_range=pc:out_range=tv:in_color_matrix=bt709:"
                            "out_color_matrix=bt709"),
                  ("format", "pix_fmts=yuv420p"),
                  ("lut3d", f"file='{_escape(path)}':interp=tetrahedral"),
                  ("format", "pix_fmts=yuv420p")], y, u, v)
    _assert_close(ffm, _ours(y, u, v, table, layout, in_full_range=True,
                             work_full_range=False,
                             requantize_intermediate=True),
                  max_y=3, max_c=2, mean_y=1.8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chain_10bit(grade, layout):
    """yuv420p10le through the tagged chain against in_depth = out_depth
    = 10; bounds in 10-bit code values."""
    path, table = grade
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    y = 64 + 800 * (0.5 + 0.4 * np.sin(xx / W * 5) * np.cos(yy / H * 4))
    u = 512 + 360 * np.sin(xx / W * 3)[0:H:2, 0:W:2]
    v = 512 + 360 * np.cos(yy / H * 2)[0:H:2, 0:W:2]
    y = np.clip(y + rng.normal(0, 2, y.shape), 0, 1023).astype(np.uint16)
    u = np.clip(u, 0, 1023).astype(np.uint16)
    v = np.clip(v, 0, 1023).astype(np.uint16)
    ffm = _chain([("scale", "in_color_matrix=bt709:out_color_matrix=bt709"),
                  ("lut3d", f"file='{_escape(path)}':interp=tetrahedral"),
                  ("format", "pix_fmts=yuv420p10le")], y, u, v,
                 pix_fmt="yuv420p10le")
    _assert_close(ffm, _ours(y, u, v, table, layout, in_depth=10,
                             out_depth=10),
                  max_y=6, max_c=4, mean_y=2.0)
