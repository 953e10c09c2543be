"""The port's whole-frame render (lut_renderer_tpu_torch.ops.fused420)
against the JAX package's plain layout on the gather path (its fused
kernel in interpret mode: test_torch_fused420_interpret.py).

Contract: the repo's integer parity bound, max |d| <= 1 code value on
fewer than 1e-3 of pixels. The matrix is tests/test_render_fused420.py's:
dithers, interpolations, 10-bit, full range with requantise, 422/444 in
and out, and an odd-width 4:4:4 frame (torch_parity.CASES). Kernel B
itself runs only on the card: tests/test_torch_cuda.py."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.ops.render import RenderConfig as JaxConfig
from lut_renderer_tpu.ops.render import render_yuv_frame as jax_render
from lut_renderer_tpu_torch.ops import fused420
from lut_renderer_tpu_torch.ops.prepare import LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig

from torch_parity import (
    CASES,
    assert_integer_contract,
    case_inputs,
    planes,
    random_lut,
    to_torch,
)


@pytest.fixture(scope="module")
def lut():
    return random_lut(17, seed=3)


def port_render(lut, name):
    """(the port's plain render of case `name`, its inputs)."""
    cfg, yuv = case_inputs(name)
    table = LutTable.from_lut3d(lut, "cpu")
    assert fused420.fused420_applicable(torch.from_numpy(yuv[0]),
                                        torch.from_numpy(yuv[1]), cfg, table)
    return fused420.render_fused420(*to_torch(*yuv), table, cfg), yuv


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_plain_layout(lut, name):
    got, yuv = port_render(lut, name)
    jcfg = JaxConfig(**CASES[name], phase_layout="plain",
                     lut_strategy="gather")
    want = jax_render(*yuv, prepare_lut(lut), jcfg)
    assert_integer_contract(got, want, f"{name} vs JAX plain")


def test_unbatched_and_batched_agree(lut):
    cfg = RenderConfig(dither="random")
    y, u, v = planes(11, 2, 16, 128, 8)
    table = LutTable.from_lut3d(lut, "cpu")
    batched = fused420.render_fused420(*to_torch(y, u, v), table, cfg)
    single = fused420.render_fused420(*to_torch(y[1], u[1], v[1]), table, cfg)
    for a, e in zip(batched, single):
        np.testing.assert_array_equal(a[1].numpy(), e.numpy())


def test_applicability(lut):
    table = LutTable.from_lut3d(lut, "cpu")
    y = torch.zeros((2, 32, 128), dtype=torch.uint8)
    u = torch.zeros((2, 16, 64), dtype=torch.uint8)
    ok = fused420.fused420_applicable
    cfg = RenderConfig()
    assert ok(y, u, cfg, table)
    # both LUT strategies and every precision name run the same kernel
    assert ok(y, u, replace(cfg, lut_strategy="gather"), table)
    assert ok(y, u, replace(cfg, lut_precision="int8_lite"), table)
    # the JAX package's N > 97 Mosaic gate is gone
    big = LutTable.from_lut3d(random_lut(129, seed=1, amp=0.0), "cpu")
    assert ok(y, u, cfg, big)
    assert not ok(y, u, replace(cfg, dither="error_diffusion_host"), table)
    assert not ok(y, u, cfg, None)
    assert not ok(y, u, replace(cfg, apply_lut=False), table)
    assert not ok(y, u, replace(cfg, resize=(64, 16)), table)
    assert not ok(y, u, replace(cfg, chroma_up="bilinear"), table)
    assert not ok(y[:, :31], u, cfg, table)                   # odd height
    assert not ok(y[..., :127], u, cfg, table)                # odd width
    assert not ok(y, u[..., :32], cfg, table)                 # wrong chroma
    y444 = torch.zeros((1, 16, 127), dtype=torch.uint8)
    cfg444 = replace(cfg, in_subsampling="444", out_subsampling="444")
    assert ok(y444, y444, cfg444, table)


def test_kernel_constants_follow_colorcore():
    from lut_renderer_tpu.colorcore import matrices as cm

    cfg = RenderConfig(in_depth=10, out_depth=8, in_full_range=True,
                       matrix_in="bt601", matrix_out="bt2020nc")
    k = fused420.kernel_constants(cfg)
    kr, kg, kb, crv, cbu = cm.yuv_rgb_coeffs("bt601")
    assert k["in_gv"] == kr * crv / kg and k["in_gu"] == kb * cbu / kg
    assert (k["norm_ysub"], k["norm_yadd"]) == (0.0, 64.0)
    assert k["norm_ymul"] == 219.0 / 255.0 and k["normalize"] == 1
    assert k["out_yscale"] == 219.0 and k["maxv_in"] == 1023.0
    assert (k["in_sx"], k["in_sy"], k["out_sx"], k["out_sy"]) == (1, 1, 1, 1)
