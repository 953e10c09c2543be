"""The port's render dispatch (lut_renderer_tpu_torch.ops.render) against
the JAX package's ops/render.py: the RenderConfig fields and defaults, the
layout choice, the LUT upload, and whole frames on both layouts under the
integer contract (max |d| <= 1 code value on fewer than 1e-3 of pixels)."""

import dataclasses
from dataclasses import replace

import pytest
import torch

from lut_renderer_tpu.ops import render as jrender
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.ops import fused420, lut3d
from lut_renderer_tpu_torch.ops import render as trender
from lut_renderer_tpu_torch.ops.prepare import LutTable

from torch_parity import (
    DOMAIN,
    assert_integer_contract,
    planes,
    random_lut,
    to_torch,
)


def test_render_config_matches_jax_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jrender.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(trender.RenderConfig)]
    assert tf == jf
    assert trender.RenderConfig.__dataclass_params__.frozen
    hash(trender.RenderConfig())


@pytest.fixture(scope="module")
def lut():
    return random_lut(17, seed=12, domain=DOMAIN)


def _spy(monkeypatch):
    """Count which path each render takes on the CPU."""
    calls = {"fused": 0, "lut": 0}
    real_fused, real_lut = (fused420.render_fused420_reference,
                            lut3d.apply_lut_planes_reference)

    def fused(*a, **k):
        calls["fused"] += 1
        return real_fused(*a, **k)

    def lut_ref(*a, **k):
        calls["lut"] += 1
        return real_lut(*a, **k)

    monkeypatch.setattr(fused420, "render_fused420_reference", fused)
    monkeypatch.setattr(lut3d, "apply_lut_planes_reference", lut_ref)
    return calls


@pytest.mark.parametrize("layout,path", [("auto", "fused"), ("fused", "fused"),
                                         ("plain", "lut"), ("rowphase", "lut")])
def test_layout_dispatch(monkeypatch, lut, layout, path):
    calls = _spy(monkeypatch)
    y, u, v = to_torch(*planes(1, 2, 16, 64, 8))
    table = LutTable.from_lut3d(lut, "cpu")
    trender.render_yuv_frame(y, u, v, table,
                             trender.RenderConfig(phase_layout=layout))
    assert calls[path] == 1 and sum(calls.values()) == 1


def test_forced_fused_raises_and_bad_layout_raises(lut):
    y, u, v = to_torch(*planes(1, 2, 16, 64, 8))
    table = LutTable.from_lut3d(lut, "cpu")
    bad = trender.RenderConfig(phase_layout="fused",
                               dither="error_diffusion_host")
    with pytest.raises(ValueError, match="forced"):
        trender.render_yuv_frame(y, u, v, table, bad)
    with pytest.raises(ValueError, match="unknown phase_layout"):
        trender.render_yuv_frame(y, u, v, table,
                                 trender.RenderConfig(phase_layout="bogus"))
    # auto falls back to the plain layout where fused cannot apply
    out = trender.render_yuv_frame(
        y, u, v, table, replace(bad, phase_layout="auto"))
    assert out[0].dtype == torch.float32  # host error diffusion finishes


def test_resize_raises_until_ported(lut):
    """The resize is ported (ops.resample): it renders at the new size on
    the plain layout, where it raised before; tests/test_torch_resample.py
    holds it to the JAX package."""
    y, u, v = to_torch(*planes(1, 1, 16, 64, 8))
    cfg = trender.RenderConfig(resize=(32, 8))
    out = trender.render_yuv_frame(y, u, v, LutTable.from_lut3d(lut, "cpu"),
                                   cfg)
    assert [tuple(p.shape) for p in out] == [(1, 8, 32), (1, 4, 16),
                                             (1, 4, 16)]


def test_lut_table_from_prepared_equals_from_lut3d(lut):
    a = LutTable.from_prepared(prepare_lut(lut), "cpu")
    b = LutTable.from_lut3d(lut, "cpu")
    assert torch.equal(a.table, b.table)
    assert (a.domain_min, a.domain_max) == (b.domain_min, b.domain_max)
    assert a.static_key == b.static_key
    cfg = trender.RenderConfig()
    assert trender.lut_operands_for(None, cfg, "cpu") is None
    assert trender.lut_operands_for(lut, replace(cfg, apply_lut=False),
                                    "cpu") is None
    for src in (lut, prepare_lut(lut), b):
        assert torch.equal(trender.lut_operands_for(src, cfg, "cpu").table,
                           b.table)


@pytest.mark.parametrize("layout", ["fused", "plain"])
@pytest.mark.parametrize("kw", [dict(), dict(dither="ordered", in_depth=10,
                                             out_depth=10),
                                dict(chroma_up="bilinear", dither="random"),
                                dict(interp="trilinear", apply_lut=False)],
                         ids=["main", "10bit_ordered", "bilinear_random",
                              "no_lut"])
def test_render_yuv_frame_matches_jax(lut, layout, kw):
    if layout == "fused" and (kw.get("chroma_up") == "bilinear"
                              or kw.get("apply_lut") is False):
        layout = "auto"  # fused does not apply; auto takes plain
    cfg = trender.RenderConfig(phase_layout=layout, **kw)
    y, u, v = planes(4, 2, 16, 128, cfg.in_depth)
    got = trender.render_yuv_frame(*to_torch(y, u, v),
                                   LutTable.from_lut3d(lut, "cpu"), cfg)
    jcfg = jrender.RenderConfig(phase_layout="plain", lut_strategy="gather",
                                **kw)
    want = jrender.render_yuv_frame(y, u, v, prepare_lut(lut), jcfg)
    assert_integer_contract(got, want, f"{layout} {kw}")


def test_make_render_fn_caches_and_needs_a_device(lut):
    cfg = trender.RenderConfig(dither="ordered")
    f1 = trender.make_render_fn(lut, cfg, "cpu")
    f2 = trender.make_render_fn(random_lut(17, seed=99, domain=DOMAIN), cfg,
                                "cpu")
    key = (cfg, LutTable.from_lut3d(lut, "cpu").static_key,
           torch.device("cpu"))
    assert key in trender._RENDER_FN_CACHE
    y, u, v = to_torch(*planes(2, 1, 16, 64, 8))
    a, b = f1(y, u, v), f2(y, u, v)
    assert not all(torch.equal(p, q) for p, q in zip(a, b))  # own tables
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.make_render_fn(lut, cfg, "cuda")
    with pytest.raises(ValueError):
        trender.make_render_fn(lut, cfg, "meta")

