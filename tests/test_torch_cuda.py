"""Kernels A, B and C, the banded resample kernel and the device loop on the
card, against their plain PyTorch versions on the same inputs. Every test here needs a CUDA device
(marker ``cuda``) and skips elsewhere.

The file imports no jax, so that it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-5 absolute on LUT output; the integer contract (max |d| <=
1 code value on fewer than 1e-3 of pixels) on rendered planes. The plain
versions run PyTorch's CUDA ops, which divide by a scalar through its
reciprocal where the kernels divide exactly."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch.engine.executor import render_batches
from lut_renderer_tpu_torch.ops import fused420, lut3d
from lut_renderer_tpu_torch.ops.prepare import Coarse2Table, LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.probes.harness import plain_rgb, tie_frames

from torch_parity import (  # noqa: F401
    CASES,
    DOMAIN,
    INTERPS,
    LUT_ATOL,
    assert_integer_contract,
    case_inputs,
    cuda_device,
    planes,
    random_lut,
    rgb_planes,
    to_torch,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("n,shape", [(33, (64, 256)), (65, (17, 301))])
def test_kernel_a_matches_plain(cuda_device, interp, n, shape):
    lut = LutTable.from_lut3d(random_lut(n, seed=8, domain=DOMAIN),
                              cuda_device)
    r, g, b = to_torch(*rgb_planes(8, shape), device=cuda_device)
    before = lut3d.launches
    got = lut3d.apply_lut_planes(r, g, b, lut, interp)
    torch.cuda.synchronize()
    assert lut3d.launches == before + 1
    want = lut3d.apply_lut_planes_reference(r, g, b, lut, interp)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=LUT_ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_b_matches_plain(cuda_device, name):
    cfg, yuv = case_inputs(name)
    lut = LutTable.from_lut3d(random_lut(17, seed=3), cuda_device)
    dev = to_torch(*yuv, device=cuda_device)
    before = fused420.launches
    got = fused420.render_fused420(*dev, lut, cfg)
    torch.cuda.synchronize()
    assert fused420.launches == before + 1
    want = fused420.render_fused420_reference(*dev, lut, cfg)
    assert_integer_contract(got, want, name)
    # the card and the CPU compute the same planes
    cpu = fused420.render_fused420(*to_torch(*yuv), lut.to("cpu"), cfg)
    assert_integer_contract(got, cpu, name + " vs CPU")


def _coarse2(n, tier, device, seed=8):
    lut = LutTable.from_lut3d(random_lut(n, seed=seed, domain=DOMAIN), device)
    return Coarse2Table.from_lut_table(lut, tier)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("tier", ["coarse2f", "coarse2", "coarse2x",
                                  "coarse2f_tri"])
def test_kernel_c_matches_plain(cuda_device, interp, tier):
    """Every (interp, residual interp) instantiation: the render's own
    under three tiers, trilinear under coarse2f_tri."""
    lut = _coarse2(65, tier, cuda_device)
    rgb = rgb_planes(9, (17, 301))
    rgb[:, 2, :40] = 1.0  # the top edge of the grid (coarse line M clamps)
    rgb[0, 3, :40] = np.float32(DOMAIN[1][0])
    r, g, b = to_torch(*rgb, device=cuda_device)
    before = lut3d.coarse2_launches
    got = lut3d.apply_lut_planes(r, g, b, lut, interp)
    torch.cuda.synchronize()
    assert lut3d.coarse2_launches == before + 1
    want = lut3d.apply_lut_planes_coarse2_reference(r, g, b, lut, interp)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=LUT_ATOL)


@pytest.mark.parametrize("tier", ["coarse2f", "coarse2", "coarse2x"])
def test_coarse2_table_built_on_card_equals_cpu_build(cuda_device, tier):
    card = _coarse2(65, tier, cuda_device)
    cpu = _coarse2(65, tier, "cpu")
    for name in ("coarse", "resid", "resid_scale"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))


def test_kernel_c_129(cuda_device):
    lut = _coarse2(129, "coarse2f", cuda_device, seed=11)
    r, g, b = to_torch(*rgb_planes(10, (64, 257)), device=cuda_device)
    got = lut3d.apply_lut_planes(r, g, b, lut)
    want = lut3d.apply_lut_planes_coarse2_reference(r, g, b, lut)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=LUT_ATOL)


@pytest.mark.parametrize("name", ["main_420p8", "10bit_full_range",
                                  "422p10_to_420p8", "444_roundtrip",
                                  "random", "prism"])
def test_kernel_b_coarse2_matches_plain(cuda_device, name):
    cfg, yuv = case_inputs(name)
    lut = _coarse2(65, "coarse2f", cuda_device, seed=3)
    dev = to_torch(*yuv, device=cuda_device)
    before = (fused420.launches, fused420.coarse2_launches)
    got = fused420.render_fused420(*dev, lut, cfg)
    torch.cuda.synchronize()
    assert (fused420.launches, fused420.coarse2_launches) == (
        before[0], before[1] + 1)
    want = fused420.render_fused420_reference(*dev, lut, cfg)
    assert_integer_contract(got, want, name)
    cpu = fused420.render_fused420(*to_torch(*yuv), lut.to("cpu"), cfg)
    assert_integer_contract(got, cpu, name + " vs CPU")


def test_wrapper_rejects_bad_operands(cuda_device):
    lut = LutTable.from_lut3d(random_lut(5, seed=1), "cpu")
    r = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):
        lut3d.apply_lut_planes(r, r, r, lut)  # table on the CPU
    with pytest.raises(ValueError):  # a coarse2 table on the CPU
        lut3d.apply_lut_planes(r, r, r, _coarse2(65, "coarse2f", "cpu"))
    y, u, v = to_torch(*planes(1, 1, 16, 64, 8), device=cuda_device)
    with pytest.raises(ValueError):
        fused420.render_fused420(y, u[..., :8], v, lut.to(cuda_device),
                                 RenderConfig())


@pytest.mark.parametrize("layout,module,counter,n,tier", [
    ("auto", fused420, "launches", 17, "auto"),
    ("plain", lut3d, "launches", 17, "auto"),
    ("auto", fused420, "coarse2_launches", 65, "coarse2f"),
    ("plain", lut3d, "coarse2_launches", 65, "coarse2f"),
])
def test_render_batches_on_card(cuda_device, layout, module, counter, n,
                                tier):
    lut = random_lut(n, seed=5)
    cfg = RenderConfig(phase_layout=layout, dither="ordered",
                       lut_precision=tier)
    batches = [(*planes(s, 2, 32, 96, 8), 2) for s in range(3)]
    before = getattr(module, counter)
    fn = make_render_fn(lut, cfg, cuda_device)
    got = list(render_batches(iter(batches), fn, cuda_device))
    assert getattr(module, counter) == before + len(batches)
    cpu_fn = make_render_fn(lut, replace(cfg, phase_layout="plain"), "cpu")
    want = list(render_batches(iter(batches), cpu_fn, torch.device("cpu")))
    for g, w in zip(got, want):
        assert g[3] == w[3]
        assert_integer_contract(g[:3], w[:3], layout)
        assert all(isinstance(a, np.ndarray) for a in g[:3])


@pytest.mark.parametrize("layout,split", [("auto", False), ("plain", False),
                                          ("auto", True)])
def test_render_batches_staged_ahead_keeps_every_output(cuda_device, layout,
                                                        split):
    """Through the staging thread, with a consumer that holds every output
    and planes that differ in every batch: each output is bit-equal to the
    same render function on that batch alone, and within the integer
    contract of the CPU path; also with the batch split over two streams
    of the card, staged through the first device as on several cards."""
    from lut_renderer_tpu_torch.parallel import make_sharded_render_fn

    lut = random_lut(17, seed=6)
    cfg = RenderConfig(phase_layout=layout, dither="ordered")
    batches = [(*planes(40 + s, 2, 32, 96, 8), 2 if s < 8 else 1)
               for s in range(9)]
    if split:
        fn = make_sharded_render_fn(lut, cfg, [cuda_device, cuda_device])
    else:
        fn = make_render_fn(lut, cfg, cuda_device)
    got = list(render_batches(iter(batches), fn, cuda_device))
    assert [g[3] for g in got] == [b[3] for b in batches]
    cpu_fn = make_render_fn(lut, replace(cfg, phase_layout="plain"), "cpu")
    want = list(render_batches(iter(batches), cpu_fn, torch.device("cpu")))
    for g, w, b in zip(got, want, batches):
        alone = fn(*to_torch(*b[:3], device=cuda_device))
        for a, e in zip(g[:3], alone):
            assert np.array_equal(a, e.cpu().numpy())
        assert_integer_contract(g[:3], w[:3], layout)


_GEOMETRIES = {"420": dict(), "422": dict(out_subsampling="422"),
               "444": dict(in_subsampling="444", out_subsampling="444")}


def _kernel_b_vs_plain(cfg, yuv, lut, what, device):
    dev = to_torch(*yuv, device=device)
    counter = "coarse2_launches" if isinstance(lut, Coarse2Table) \
        else "launches"
    before = getattr(fused420, counter)
    got = fused420.render_fused420(*dev, lut, cfg)
    torch.cuda.synchronize()
    assert getattr(fused420, counter) == before + 1
    want = fused420.render_fused420_reference(*dev, lut, cfg)
    assert_integer_contract(got, want, what)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_kernel_b_each_instantiation(cuda_device, interp, geometry):
    """Every (interp, output geometry) instantiation of kernel B."""
    cfg = RenderConfig(interp=interp, dither="ordered",
                       **_GEOMETRIES[geometry])
    lut = LutTable.from_lut3d(random_lut(17, seed=4, domain=DOMAIN),
                              cuda_device)
    yuv = planes(12, 2, 16, 256, 8, cfg.in_subsampling)
    _kernel_b_vs_plain(cfg, yuv, lut, f"{interp} {geometry}", cuda_device)


@pytest.mark.parametrize("geometry,width", [("420", 1922), ("422", 1926),
                                            ("444", 641), ("444", 1925),
                                            ("420", 6)])
@pytest.mark.parametrize("depth", [8, 10])
def test_kernel_b_scalar_tail(cuda_device, geometry, width, depth):
    """Widths that are not a multiple of 8 take the scalar path."""
    cfg = RenderConfig(in_depth=depth, out_depth=depth, dither="random",
                       **_GEOMETRIES[geometry])
    lut = LutTable.from_lut3d(random_lut(17, seed=5), cuda_device)
    yuv = planes(13, 1, 8, width, depth, cfg.in_subsampling)
    _kernel_b_vs_plain(cfg, yuv, lut, f"{geometry} width {width}",
                       cuda_device)


def test_kernel_b_unaligned_planes_take_the_scalar_path(cuda_device):
    cfg = RenderConfig()
    lut = LutTable.from_lut3d(random_lut(17, seed=6), cuda_device)
    y, u, v = to_torch(*planes(14, 3, 16, 256, 8), device=cuda_device)
    # frames 1-2 of a batch of 3 start at an odd byte offset of the storage
    flat = [torch.cat([t.new_zeros(1), t.flatten()])[1:] for t in (y, u, v)]
    views = [f[t[0].numel():].view(2, *t.shape[1:]) for f, t in
             zip(flat, (y, u, v))]
    assert views[0].data_ptr() % 16
    got = fused420.render_fused420(*views, lut, cfg)
    want = fused420.render_fused420_reference(*views, lut, cfg)
    assert_integer_contract(got, want, "unaligned")


@pytest.mark.parametrize("interp", INTERPS)
def test_kernel_b_tie_heavy_planes(cuda_device, interp):
    """Deltas that tie and land on cell boundaries of an 18^3 LUT (N - 1
    = 17 divides 255 under full range): held against the plain version on
    the CPU, which divides exactly as the kernel does. (The plain version
    on the card divides through a reciprocal; on planes of so few distinct
    codes one code that rounds the other way covers a large share of the
    pixels.)"""
    cfg = RenderConfig(in_full_range=True, work_full_range=True,
                       out_full_range=True, interp=interp)
    lut = LutTable.from_lut3d(random_lut(18, seed=7), cuda_device)
    yuv = tie_frames(21, 2, 16, 192)
    got = fused420.render_fused420(*to_torch(*yuv, device=cuda_device), lut,
                                   cfg)
    want = fused420.render_fused420(*to_torch(*yuv), lut.to("cpu"), cfg)
    assert_integer_contract(got, want, f"ties {interp}")


@pytest.mark.parametrize("table", ["exact", "coarse2f"])
def test_kernel_b_uniform_random_planes(cuda_device, table):
    """Uniform-random 8-bit codes: neighbouring pixels in unrelated cells."""
    cfg = RenderConfig(lut_precision=table)
    lut = LutTable.from_lut3d(random_lut(65, seed=9), cuda_device)
    if table != "exact":
        lut = Coarse2Table.from_lut_table(lut, table)
    rng = np.random.default_rng(22)
    yuv = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                for s in ((2, 64, 512), (2, 32, 256), (2, 32, 256)))
    _kernel_b_vs_plain(cfg, yuv, lut, f"uniform {table}", cuda_device)


def test_kernel_b_coarse2_422p10_random_dither(cuda_device):
    cfg = RenderConfig(in_depth=10, out_depth=10, in_subsampling="422",
                       out_subsampling="422", dither="random",
                       lut_precision="coarse2f")
    lut = _coarse2(65, "coarse2f", cuda_device, seed=10)
    yuv = planes(15, 2, 16, 264, 10, "422")
    _kernel_b_vs_plain(cfg, yuv, lut, "coarse2 422p10 random", cuda_device)


@pytest.mark.parametrize("stage", ["io", "color", "full"])
def test_kernel_b_probe_stages_launch(cuda_device, stage):
    """The stage probe's builds (io and color from the probes' library,
    full from the render library) run and count no launch; full equals the
    production kernel bit for bit."""
    from lut_renderer_tpu_torch.probes import kernel_b

    cfg = RenderConfig()
    lut = LutTable.from_lut3d(random_lut(17, seed=11), cuda_device)
    yuv = to_torch(*planes(16, 2, 16, 256, 8), device=cuda_device)
    before = fused420.launches
    launch, got = kernel_b.prepared_launch(*yuv, lut, cfg, stage)
    launch()
    torch.cuda.synchronize()
    assert fused420.launches == before
    if stage == "full":
        want = fused420.render_fused420(*yuv, lut, cfg)
        for a, e in zip(got, want):
            assert torch.equal(a, e)
    elif stage == "io":  # the identity colour math: y out is y in
        assert torch.equal(got[0], yuv[0])


def _planar_table(kind, device, n=65):
    lut = LutTable.from_lut3d(random_lut(n, seed=12, domain=DOMAIN), device)
    return lut if kind == "A" else Coarse2Table.from_lut_table(lut,
                                                              "coarse2f")


def _plain_lut(table):
    return (lut3d.apply_lut_planes_coarse2_reference
            if isinstance(table, Coarse2Table)
            else lut3d.apply_lut_planes_reference)


def _planar_vs_plain(r, g, b, table, interp="tetrahedral"):
    counter = "coarse2_launches" if isinstance(table, Coarse2Table) \
        else "launches"
    before = getattr(lut3d, counter)
    got = lut3d.apply_lut_planes(r, g, b, table, interp)
    torch.cuda.synchronize()
    assert getattr(lut3d, counter) == before + 1
    want = _plain_lut(table)(r, g, b, table, interp)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=LUT_ATOL)
    return got


@pytest.mark.parametrize("kind", ["A", "C"])
@pytest.mark.parametrize("shape", [(3, 1367), (2, 2049), (3, 1369)])
def test_planar_kernels_pixel_count_not_a_multiple_of_4(cuda_device, kind,
                                                        shape):
    """A last unit that the pixels fill only in part."""
    assert shape[0] * shape[1] % 4
    table = _planar_table(kind, cuda_device)
    rgb = to_torch(*rgb_planes(17, shape), device=cuda_device)
    assert lut3d.vector_io(*rgb)
    _planar_vs_plain(*rgb, table)


@pytest.mark.parametrize("kind", ["A", "C"])
def test_planar_kernels_unaligned_planes(cuda_device, kind):
    table = _planar_table(kind, cuda_device)
    r, g, b = to_torch(*rgb_planes(18, (16, 257)), device=cuda_device)
    views = [t.reshape(-1)[1:] for t in (r, g, b)]
    assert not lut3d.vector_io(*views)
    got = _planar_vs_plain(*views, table)
    # the same pixels on aligned planes give the same bits
    aligned = [v.clone() for v in views]
    assert lut3d.vector_io(*aligned)
    for a, e in zip(lut3d.apply_lut_planes(*aligned, table), got):
        assert torch.equal(a, e)


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("kind", ["A", "C"])
def test_planar_kernels_tie_heavy_planes(cuda_device, kind, interp):
    """Grey pixels (equal deltas) and clipped channels: the RGB that the
    plain layout hands the LUT for harness.tie_frames, full range."""
    cfg = RenderConfig(in_full_range=True, work_full_range=True,
                       out_full_range=True)
    rgb = plain_rgb(tie_frames(23, 2, 16, 192), cfg, cuda_device)
    _planar_vs_plain(*rgb, _planar_table(kind, cuda_device, n=65), interp)


def test_kernel_a_129(cuda_device):
    lut = LutTable.from_lut3d(random_lut(129, seed=13), cuda_device)
    r, g, b = to_torch(*rgb_planes(19, (64, 257)), device=cuda_device)
    _planar_vs_plain(r, g, b, lut)


@pytest.mark.parametrize("kind,stage", [
    ("A", "io"), ("A", "weights"), ("A", "full"), ("C", "io"),
    ("C", "weights"), ("C", "coarse"), ("C", "resid"), ("C", "full")])
def test_planar_probe_stages_launch(cuda_device, kind, stage):
    """The stage probe's builds (from the probes' library; full from the
    render library) run and count no launch; io returns its input, full
    equals the production kernel and coarse + resid equals full, bit for
    bit."""
    from lut_renderer_tpu_torch.probes import kernel_ac

    table = _planar_table(kind, cuda_device)
    rgb = to_torch(*rgb_planes(20, (16, 256)), device=cuda_device)
    before = (lut3d.launches, lut3d.coarse2_launches)
    launch, got = kernel_ac.prepared_launch(*rgb, table, "tetrahedral",
                                            stage)
    launch()
    torch.cuda.synchronize()
    assert (lut3d.launches, lut3d.coarse2_launches) == before
    assert all(bool(torch.isfinite(t).all()) for t in got)
    if stage == "io":
        assert all(torch.equal(a, e) for a, e in zip(got, rgb))
    elif stage == "full":
        want = lut3d.apply_lut_planes(*rgb, table)
        assert all(torch.equal(a, e) for a, e in zip(got, want))
    elif stage == "resid":
        coarse, other = kernel_ac.prepared_launch(*rgb, table,
                                                  "tetrahedral", "coarse")
        coarse()
        want = lut3d.apply_lut_planes(*rgb, table)
        assert all(torch.equal(a + c, e)
                   for a, c, e in zip(got, other, want))


def test_planar_kernels_refuse_2_31_pixels(cuda_device):
    """Kernels A and C index in int32; the wrapper raises before it
    allocates an output."""
    plane = torch.empty(1 << 31, dtype=torch.float32, device=cuda_device)
    for kind in ("A", "C"):
        with pytest.raises(ValueError, match="int32"):
            lut3d.apply_lut_planes(plane, plane, plane,
                                   _planar_table(kind, cuda_device))
    del plane
    torch.cuda.empty_cache()


# ---- the resize path, the resample's precision, the split -----------------

@pytest.mark.parametrize("kw", [dict(), dict(dither="ordered"),
                                dict(lut_precision="coarse2f")],
                         ids=["none", "ordered", "coarse2f"])
@pytest.mark.parametrize("shape,size", [((2, 64, 128), (96, 40)),
                                        ((1, 36, 64), (128, 72))],
                         ids=["down", "up"])
def test_resize_path_matches_plain(cuda_device, kw, shape, size):
    """Kernel A (C at a coarse2 tier) at the input size, then the
    resample: the render function against the plain LUT with the same
    resample, under the integer contract."""
    from lut_renderer_tpu_torch.ops.pixel import render_planes
    from lut_renderer_tpu_torch.ops.resample import resample_plane, weights_on

    n = 65 if kw.get("lut_precision") else 17
    cfg = RenderConfig(resize=size, **kw)
    table = LutTable.from_lut3d(random_lut(n, seed=9, domain=DOMAIN),
                                cuda_device)
    if kw.get("lut_precision"):
        table = Coarse2Table.from_lut_table(table, kw["lut_precision"])
    y, u, v = to_torch(*planes(11, *shape, 8), device=cuda_device)
    counter = "coarse2_launches" if kw.get("lut_precision") else "launches"
    before = getattr(lut3d, counter)
    got = make_render_fn(table, cfg, cuda_device)(y, u, v)
    torch.cuda.synchronize()
    assert getattr(lut3d, counter) == before + 1
    plain = (lut3d.apply_lut_planes_coarse2_reference
             if kw.get("lut_precision") else lut3d.apply_lut_planes_reference)
    wv, wh = weights_on(shape[1:], size, cuda_device)
    want = render_planes(
        y, u, v, cfg, lambda r, g, b: plain(r, g, b, table, cfg.interp),
        lambda r, g, b: tuple(resample_plane(p, wv, wh) for p in (r, g, b)))
    assert got[0].shape == (shape[0], size[1], size[0])
    assert_integer_contract(got, want, f"resize {shape}->{size} {kw}")


def test_resample_is_full_f32_whatever_the_tf32_setting(cuda_device):
    from lut_renderer_tpu_torch.ops.resample import resample_plane, weights_on

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand((2, 540, 960), generator=g, device=cuda_device)
    wv, wh = weights_on((540, 960), (1920, 1080), cuda_device)
    mm = torch.backends.cuda.matmul
    saved = mm.fp32_precision
    try:
        mm.fp32_precision = "ieee"
        got = resample_plane(x, wv, wh)
        mm.allow_tf32 = True
        again = resample_plane(x, wv, wh)
        assert mm.allow_tf32  # the caller's setting is back
    finally:
        mm.fp32_precision = saved
    assert torch.equal(got, again)
    ref = torch.matmul(torch.matmul(wv.double(), x.double()),
                       wh.double().t())
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    assert rel < 1e-5, rel


# (batch, in h, in w), (out h, out w): the two resize shapes of the cells
# and chip_smoke.py, and odd ones (a tiny ratio, degenerate axes, a window
# staged in chunks of rows)
RESAMPLE_KERNEL_CASES = {
    "4k_to_1080p_x2": ((2, 2160, 3840), (1080, 1920)),
    "1080p_to_4k_x8": ((8, 1080, 1920), (2160, 3840)),
    "17x13_to_13x17": ((3, 17, 13), (13, 17)),
    "64x64_to_9x9": ((2, 64, 64), (9, 9)),
    "1x3_to_4x1": ((2, 1, 3), (4, 1)),
    "540x960_to_9x16_chunked": ((2, 540, 960), (9, 16)),
}


@pytest.mark.parametrize("name", sorted(RESAMPLE_KERNEL_CASES))
def test_resample_kernel_matches_plain(cuda_device, name):
    """The banded kernel against its plain version on the same card,
    bit for bit, on aligned planes and on planes one element off (the
    scalar path)."""
    from lut_renderer_tpu_torch.ops import resample

    shape, out_hw = RESAMPLE_KERNEL_CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.rand(shape, generator=g, device=cuda_device)
    bv, bh = resample.bands_on(shape[-2:], out_hw[::-1], cuda_device)
    before = resample.launches
    got = resample.resample_plane(x, bv, bh)
    torch.cuda.synchronize()
    assert resample.launches == before + 1
    want = resample.resample_plane_reference(x, bv, bh)
    assert got.shape == want.shape == shape[:-2] + out_hw
    assert torch.equal(got, want)
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    flat[1:] = x.flatten()
    odd = flat[1:].view(shape)
    assert torch.equal(resample.resample_plane(odd, bv, bh), want)


def test_resized_batch_launches_the_resample_kernel_three_times(cuda_device):
    from lut_renderer_tpu_torch.ops import resample

    fn = make_render_fn(random_lut(17, seed=3), RenderConfig(resize=(96, 40)),
                        cuda_device)
    y, u, v = to_torch(*planes(5, 2, 64, 128, 8), device=cuda_device)
    before = resample.launches
    for n in (1, 2):
        fn(y, u, v)
        assert resample.launches == before + 3 * n
    torch.cuda.synchronize()


def test_resample_kernel_refuses_what_it_cannot_take(cuda_device):
    from lut_renderer_tpu_torch.ops import _build, resample

    bv, bh = resample.bands_on((4, 8), (4, 2), "cpu")
    x = torch.zeros((1, 4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="must lie on"):
        resample.resample_plane(x, bv, bh)
    bv, bh = bv.to(cuda_device), bh.to(cuda_device)
    with pytest.raises(ValueError, match="split the batch"):
        resample.resample_plane(torch.zeros((65536, 4, 8), device=cuda_device),
                                bv, bh)
    wide = resample.Band.from_dense(np.full((1, 6200), 1 / 6200, np.float32),
                                    cuda_device)
    with pytest.raises(ValueError, match="too wide"):
        resample.resample_plane(torch.zeros((1, 4, 6200), device=cuda_device),
                                bv, wide)
    # the entry point's own guard: a launch it cannot take is refused
    p, _out, _keep = resample.launch_args(x, bv, bh)
    p.chunk_h = 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("resample_launch", p, cuda_device)


@pytest.mark.parametrize("resize", [None, (96, 40)], ids=["main", "resize"])
def test_split_over_two_streams_is_bit_equal(cuda_device, resize):
    from lut_renderer_tpu_torch.parallel import make_sharded_render_fn

    lut = random_lut(33, seed=12)
    cfg = RenderConfig(resize=resize)
    whole_fn = make_render_fn(lut, cfg, cuda_device)
    split_fn = make_sharded_render_fn(lut, cfg, ["cuda:0", "cuda:0"])
    for b in (4, 3):
        y, u, v = planes(13 + b, b, 64, 128, 8)
        whole = whole_fn(*to_torch(y, u, v, device=cuda_device))
        for got in (split_fn(*to_torch(y, u, v, device=cuda_device)),
                    split_fn(*to_torch(y, u, v))):  # from the host
            for a, e in zip(got, whole):
                assert a.device == e.device and torch.equal(a, e)


def test_split_spans_over_four_streams_of_the_card(cuda_device):
    """Under a profiler that traces the card, the split over four streams
    of one card records its call, a chunk a stream under it, and no bytes
    between cards (every chunk stays on the first card), and stays
    bit-equal to the unsplit function; no device-side event carries a
    span's name, which would count as device work."""
    from torch.autograd import DeviceType

    from lut_renderer_tpu_torch import spans
    from lut_renderer_tpu_torch.parallel import (SplitStats,
                                                 make_sharded_render_fn)

    lut = random_lut(33, seed=14)
    cfg = RenderConfig(in_depth=10, out_depth=10)
    split_fn = make_sharded_render_fn(lut, cfg, ["cuda:0"] * 4)
    y, u, v = to_torch(*planes(14, 4, 64, 128, 10), device=cuda_device)
    split_fn(y, u, v)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    got = split_fn(y, u, v)
    torch.cuda.synchronize()
    prof.stop()
    whole = make_render_fn(lut, cfg, cuda_device)(y, u, v)
    for a, e in zip(got, whole):
        assert a.device == e.device and torch.equal(a, e)
    recs = spans.records()
    (call,) = [r for r in recs if r.name == "sharding.call"]
    assert call.attrs == {"cards": 4, "frames": 4, "peer_bytes": 0}
    mine = [r for r in recs if r.parent == call.id]
    assert [r.name for r in mine] == (["sharding.put"]
                                      + ["sharding.chunk"] * 4
                                      + ["sharding.gather"])
    assert [(r.attrs["card"], r.attrs["frames"]) for r in mine[1:5]] == [
        (i, 1) for i in range(4)]
    assert split_fn.stats == SplitStats(calls=2, frames=[2] * 4,
                                        peer_bytes=0)
    on_card = {ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA}
    assert any("fused420_kernel" in n for n in on_card)
    assert not [n for n in on_card if n.startswith("sharding.")]


# ---- BASELINE configurations at their published sizes ---------------------

def _baseline(prefix):
    from lut_renderer_tpu_torch.probes.baseline import baseline_stages

    (st,) = [s for s in baseline_stages() if s.name.startswith(prefix)]
    return st


def test_kernel_b_4k_422p10_master(cuda_device):
    """Pro stage 1 at its size: 3840x2160 422p10 -> 422p10 (the policy's
    RenderConfig) on kernel B, against its plain twin."""
    from lut_renderer_tpu_torch.probes.harness import yuv_frames

    st = _baseline("3 pro stage 1")
    assert (st.cfg.in_subsampling, st.cfg.out_subsampling,
            st.cfg.in_depth, st.cfg.out_depth) == ("422", "422", 10, 10)
    y, u, v = to_torch(*yuv_frames(21, 1, 2160, 3840, 10, "422"),
                       device=cuda_device)
    lut = LutTable.from_lut3d(random_lut(33, seed=21), cuda_device)
    before = fused420.launches
    got = fused420.render_fused420(y, u, v, lut, st.cfg)
    torch.cuda.synchronize()
    assert fused420.launches == before + 1
    assert got[0].dtype == torch.uint16
    assert [tuple(p.shape) for p in got] == [(1, 2160, 3840),
                                             (1, 2160, 1920),
                                             (1, 2160, 1920)]
    want = fused420.render_fused420_reference(y, u, v, lut, st.cfg)
    assert_integer_contract(got, want, "4K 422p10 master")


def test_8k_420p10_one_frame_batch_through_render_batches(cuda_device):
    """Config 5: the executor's batch at 8K is one frame; the device loop
    (pinned uint16 staging both ways) renders it on kernel B, against the
    plain twin on the same planes."""
    from lut_renderer_tpu_torch.engine.executor import _pick_batch_size
    from lut_renderer_tpu_torch.probes.harness import yuv_frames

    st = _baseline("5 8K")
    assert _pick_batch_size(7680, 4320) == 1
    assert (st.cfg.in_depth, st.cfg.out_depth) == (10, 10)
    frames = yuv_frames(22, 1, 4320, 7680, 10)
    lut = random_lut(33, seed=22)
    before = fused420.launches
    (out,) = list(render_batches(iter([(*frames, 1)]),
                                 make_render_fn(lut, st.cfg, cuda_device),
                                 cuda_device))
    assert fused420.launches == before + 1
    assert out[3] == 1 and out[0].dtype == np.uint16
    want = fused420.render_fused420_reference(
        *to_torch(*frames, device=cuda_device),
        LutTable.from_lut3d(lut, cuda_device), st.cfg)
    assert_integer_contract(out[:3], want, "8K 420p10 batch of 1")


def test_plain_layout_rounds_ties_as_the_cpu(cuda_device):
    """Pro stage 2's function (422p10 -> 420p8, no LUT, no dither): a
    quarter of the luma codes land on an exact rounding tie, and the
    card's plain layout rounds them as the CPU does (ops.pixel.fdiv)."""
    from lut_renderer_tpu_torch.probes.harness import yuv_frames

    st = _baseline("3 pro stage 2")
    frames = yuv_frames(23, 2, 216, 384, 10, "422")
    got = make_render_fn(None, st.cfg, cuda_device)(
        *to_torch(*frames, device=cuda_device))
    want = make_render_fn(None, st.cfg, "cpu")(*to_torch(*frames))
    for a, e in zip(got, want):
        assert torch.equal(a.cpu(), e)


def test_render_batches_spans_on_card(cuda_device):
    """Under a profiler that traces the card, the device loop records each
    step of each batch under its call, and the anchor of its spans stays
    on the host: no device-side event carries a span's or the anchor's
    name, which would count as device work."""
    import torch.autograd.profiler as autograd_profiler
    from torch.autograd import DeviceType

    from lut_renderer_tpu_torch import spans

    fn = make_render_fn(random_lut(17, seed=5), RenderConfig(), cuda_device)
    batches = [(*planes(s, 2, 32, 96, 8), 2) for s in range(3)]
    warm = list(render_batches(iter(batches), fn, cuda_device))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    assert autograd_profiler._is_profiler_enabled is True
    got = list(render_batches(iter(batches), fn, cuda_device))
    torch.cuda.synchronize()
    prof.stop()
    for g, w in zip(got, warm):
        assert all(np.array_equal(a, b) for a, b in zip(g[:3], w[:3]))
    recs = spans.records()
    (run,) = [r for r in recs if r.name == "executor.run"]
    # the take and the stage step also find the end: a fourth span
    for step, n in (("take", 4), ("pin", 3), ("stage", 4), ("render", 3),
                    ("out", 3), ("wait", 3)):
        mine = [r for r in recs if r.name == f"executor.{step}"]
        assert [r.attrs["batch"] for r in mine] == list(range(n)), step
        assert all(r.parent == r.call == run.id for r in mine)
        # the staging thread takes and pins; the loop's thread the rest
        on_loop = {r.thread == run.thread for r in mine}
        assert on_loop == {step not in ("take", "pin")}, step
    stages = [r for r in recs if r.name == "executor.stage"]
    assert all(isinstance(r.attrs["ready"], bool) for r in stages[:3])
    assert "ready" not in stages[3].attrs
    events = prof.profiler.kineto_results.events()
    on_card = {ev.name() for ev in events
               if ev.device_type() == DeviceType.CUDA}
    assert any("fused420_kernel" in n for n in on_card)
    assert not [n for n in on_card
                if n == spans.ANCHOR or n.startswith(("executor.", "runner."))]
    ranges = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in events if ev.name() == spans.ANCHOR)
    offset, half = spans.clock_offset_ns(ranges)
    assert half < 50_000
