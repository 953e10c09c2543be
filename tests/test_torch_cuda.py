"""Kernels A, B and C and the device loop on the card, against their plain
PyTorch versions on the same inputs. Every test here needs a CUDA device
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
