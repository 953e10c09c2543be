"""The big-cube LUT class through the coarse + residual decomposition: the
port's Coarse2Table, its plain version (kernel C's and kernel B's coarse2
instantiation's on the CPU), the tier choice and the render path, against
the JAX package's prepare_lut, its _run_coarse2_fused (interpret mode) and
its fused whole-frame kernel (interpret mode).

Tolerances: the tables are bit-equal; LUT output within 1e-5 absolute;
rendered planes under the integer contract (max |d| <= 1 code value on
fewer than 1e-3 of pixels). The interp x tier matrix against JAX is in
test_torch_coarse2_interp.py."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lut_renderer_tpu.ops.fused420 import render_fused420 as jax_fused
from lut_renderer_tpu.ops.lut3d import apply_lut_planes as jax_apply
from lut_renderer_tpu.ops.prepare import _upsample2_linear, prepare_lut
from lut_renderer_tpu.ops.render import RenderConfig as JaxConfig
from lut_renderer_tpu_torch.colorcore import Lut3D, write_cube_file
from lut_renderer_tpu_torch.engine import executor, run_stage
from lut_renderer_tpu_torch.hostio import probe_video
from lut_renderer_tpu_torch.models import ProcessingParams
from lut_renderer_tpu_torch.ops import fused420, lut3d
from lut_renderer_tpu_torch.ops import render as trender
from lut_renderer_tpu_torch.ops.prepare import (
    COARSE2_TIERS,
    Coarse2Table,
    LutTable,
    upsample2_linear,
)
from lut_renderer_tpu_torch.plan import build_render_spec
from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

from torch_parity import (
    DOMAIN,
    LUT_ATOL,
    assert_integer_contract,
    planes,
    random_lut,
    rgb_planes,
    to_torch,
)


@pytest.fixture(scope="module")
def lut65():
    return random_lut(65, seed=21, domain=DOMAIN)


@pytest.fixture(scope="module")
def prep65(lut65):
    return prepare_lut(lut65)


def _rgb(seed, shape=(8, 64)):
    """rgb_planes with a row at exactly 1.0 and one at the domain max:
    the top edge of the grid, where the coarse line p // 2 + 1 is M."""
    rgb = rgb_planes(seed, shape)
    rgb[:, 2, :] = np.float32(1.0)
    rgb[0, 3, :] = np.float32(DOMAIN[1][0])
    return rgb


def _close(got, want, atol=LUT_ATOL):
    for a, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("tier", COARSE2_TIERS)
def test_tables_equal_the_jax_carry_across(lut65, prep65, tier):
    own = Coarse2Table.from_lut_table(LutTable.from_lut3d(lut65, "cpu"), tier)
    carried = Coarse2Table.from_prepared(prep65, tier, "cpu")
    for name in ("coarse", "resid", "resid_scale"):
        a, b = getattr(own, name), getattr(carried, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert own.coarse.shape == (33, 33, 33, 4)
    assert own.resid.shape == (65, 65, 65, 4)
    assert own.resid_scale.shape == (65, 4)
    assert own.static_key == carried.static_key
    assert own.static_key[-1] == tier


def test_upsample_is_the_jax_upsample(lut65):
    c = np.ascontiguousarray(lut65.table[::2, ::2, ::2])
    got = upsample2_linear(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, _upsample2_linear(c))


def test_residual_scale_is_per_r_index_and_channel(lut65):
    t = Coarse2Table.from_lut_table(LutTable.from_lut3d(lut65, "cpu"),
                                    "coarse2f")
    s = t.resid_scale[:, :3]
    assert len(torch.unique(s)) > 3 * 10  # not one scale per channel
    # each row dequantises to within half a step of its own scale
    table = torch.from_numpy(lut65.table)
    resid = table - upsample2_linear(table[::2, ::2, ::2].contiguous())
    err = (t.resid_table()[..., :3] - resid).abs().amax(dim=(1, 2))
    assert bool((err <= 0.5 * s * (1 + 1e-6)).all())


def test_identity_through_coarse2x_tri_is_exact():
    """Identity 65^3: the residual is zero and the bf16 pair holds the
    detrended (zero) coarse table exactly."""
    ident = Lut3D.identity(65)
    table = LutTable.from_lut3d(ident, "cpu")
    t = Coarse2Table.from_lut_table(table, "coarse2x_tri")
    assert int(t.resid.abs().max()) == 0
    rgb = _rgb(4, (4, 128))
    r, g, b = to_torch(*rgb)
    got = lut3d.apply_lut_planes(r, g, b, t, "tetrahedral")
    _close(got, lut3d.apply_lut_planes(r, g, b, table, "tetrahedral"))
    want = jax_apply(*rgb, prepare_lut(ident), "tetrahedral",
                     precision="coarse2x_tri", interpret=True)
    _close(got, want)


def test_129_cube_matches_jax():
    lut = random_lut(129, seed=29)
    prep = prepare_lut(lut)
    t = Coarse2Table.from_lut_table(LutTable.from_lut3d(lut, "cpu"),
                                    "coarse2f")
    assert t.coarse_size == 65
    rgb = _rgb(6, (4, 96))
    got = lut3d.apply_lut_planes(*to_torch(*rgb), t, "tetrahedral")
    want = jax_apply(*rgb, prep, "tetrahedral", precision="coarse2f",
                     interpret=True)
    _close(got, want)


def test_render_coarse2f_matches_jax_fused_kernel(lut65, prep65):
    cfg = trender.RenderConfig(lut_precision="coarse2f")
    y, u, v = planes(8, 1, 16, 128, 8)
    fn = trender.make_render_fn(lut65, cfg, "cpu")
    got = fn(*to_torch(y, u, v))
    want = jax_fused(y, u, v, prep65, JaxConfig(lut_precision="coarse2f"),
                     interpret=True)
    assert_integer_contract(got, want, "coarse2f vs JAX fused")


@pytest.mark.parametrize("precision,n,tier", [
    ("coarse2f", 65, "coarse2f"), ("coarse2x_tri", 97, "coarse2x_tri"),
    ("coarse2", 129, "coarse2"), ("coarse2f", 33, "exact"),
    ("coarse2f", 64, "exact"), ("auto", 65, "exact"), ("exact", 65, "exact"),
    ("int8_lite", 129, "exact"), ("coarse3", 65, "exact"),
])
def test_lut_tier(precision, n, tier):
    assert trender.lut_tier(precision, n) == tier


def test_coarse2_on_a_33_cube_is_the_exact_path(monkeypatch):
    lut = random_lut(33, seed=23)
    cfg = trender.RenderConfig(lut_precision="coarse2f")
    assert isinstance(trender.lut_operands_for(lut, cfg, "cpu"), LutTable)
    calls = []
    real = lut3d.apply_lut_planes_coarse2_reference
    monkeypatch.setattr(lut3d, "apply_lut_planes_coarse2_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    y, u, v = to_torch(*planes(9, 2, 16, 64, 8))
    for layout in ("fused", "plain"):
        got = trender.render_yuv_frame(
            y, u, v, trender.lut_operands_for(lut, cfg, "cpu"),
            dataclasses.replace(cfg, phase_layout=layout))
        want = trender.render_yuv_frame(
            y, u, v, LutTable.from_lut3d(lut, "cpu"),
            trender.RenderConfig(phase_layout=layout))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not calls


def test_make_render_fn_keys_and_builds_by_tier(lut65):
    keys = []
    for tier in ("coarse2f", "coarse2"):
        cfg = trender.RenderConfig(lut_precision=tier, dither="ordered")
        trender.make_render_fn(lut65, cfg, "cpu")
        table = trender.lut_operands_for(lut65, cfg, "cpu")
        assert isinstance(table, Coarse2Table) and table.tier == tier
        key = (cfg, table.static_key, torch.device("cpu"))
        assert key in trender._RENDER_FN_CACHE
        keys.append(table.static_key)
    assert keys[0] != keys[1]
    # a prepared table renders its own tier only
    table = trender.lut_operands_for(
        lut65, trender.RenderConfig(lut_precision="coarse2f"), "cpu")
    assert trender.lut_operands_for(
        table, trender.RenderConfig(lut_precision="coarse2f"), "cpu") \
        .tier == "coarse2f"
    with pytest.raises(ValueError, match="cannot render"):
        trender.lut_operands_for(
            table, trender.RenderConfig(lut_precision="coarse2x"), "cpu")


@pytest.mark.parametrize("layout,plain", [
    ("fused", "render_fused420_reference"),
    ("plain", "apply_lut_planes_coarse2_reference")])
def test_cpu_wrappers_run_the_coarse2_plain_version(monkeypatch, lut65,
                                                    layout, plain):
    module = fused420 if layout == "fused" else lut3d
    calls = []
    real = getattr(module, plain)
    monkeypatch.setattr(module, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = trender.RenderConfig(lut_precision="coarse2f", phase_layout=layout)
    before = (fused420.coarse2_launches, lut3d.coarse2_launches)
    trender.make_render_fn(lut65, cfg, "cpu")(
        *to_torch(*planes(3, 1, 16, 64, 8)))
    assert calls == [1]
    assert (fused420.coarse2_launches, lut3d.coarse2_launches) == before


def test_executor_logs_the_tier_that_runs(monkeypatch, tmp_path, lut65):
    clip = make_gradient_clip(tmp_path / "c.mp4", 64, 48, fps=25.0,
                              frames=3)
    cube = write_cube_file(tmp_path / "big.cube", lut65)
    info = probe_video(clip)
    derive = executor.derive_render_config
    for tier, shown in (("coarse2f", "coarse2f"), ("auto", "exact")):
        monkeypatch.setattr(
            executor, "derive_render_config",
            lambda spec, inf, t=tier: dataclasses.replace(
                derive(spec, inf), lut_precision=t))
        spec = build_render_spec(Path(clip), tmp_path / f"{tier}.mkv",
                                 ProcessingParams(video_codec="ffv1"),
                                 Path(cube), info)
        logs = []
        res = run_stage(spec, info, lut65, device="cpu", log_cb=logs.append)
        assert res.ok, res.error
        assert f"engine: LUT kernel precision={shown}" in logs
