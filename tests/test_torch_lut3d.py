"""The port's LUT step (lut_renderer_tpu_torch.ops.lut3d) against
colorcore.interp (NumPy) and the JAX package's apply_lut_planes.

Tolerances: 1e-5 absolute against colorcore.interp and the JAX gather
path, which compute the same f32 function; 1e-4 against the JAX MXU
"exact" tier, whose bf16 hi/lo table pair carries about 2^-17 relative
table error. Kernel A itself runs only on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from lut_renderer_tpu.colorcore import interp as cinterp
from lut_renderer_tpu.ops.lut3d import apply_lut_planes as jax_apply
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.ops import lut3d
from lut_renderer_tpu_torch.ops.prepare import LutTable

from torch_parity import (
    DOMAIN,
    INTERPS,
    LUT_ATOL,
    random_lut,
    rgb_planes,
    to_numpy,
)


def _port(rgb, lut, interp):
    r, g, b = (torch.from_numpy(c) for c in rgb)
    out = lut3d.apply_lut_planes(r, g, b, LutTable.from_lut3d(lut, "cpu"),
                                 interp)
    return np.stack([to_numpy(c) for c in out])


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("n", [2, 17, 33])
def test_plain_matches_colorcore_and_jax_gather(interp, n):
    domain = DOMAIN if n == 17 else None
    lut = random_lut(n, seed=n, domain=domain)
    rgb = rgb_planes(n)
    got = _port(rgb, lut, interp)
    want = cinterp.apply_lut(np.moveaxis(rgb, 0, -1), lut, interp)
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0), rtol=0,
                               atol=LUT_ATOL)
    prep = prepare_lut(lut)
    jout = jax_apply(*rgb, prep, interp, strategy="gather")
    np.testing.assert_allclose(got, np.stack([np.asarray(c) for c in jout]),
                               rtol=0, atol=LUT_ATOL)


@pytest.mark.parametrize("interp", INTERPS)
def test_plain_matches_jax_mxu_exact_tier(interp):
    lut = random_lut(9, seed=21)
    rgb = rgb_planes(5, (8, 128))
    got = _port(rgb, lut, interp)
    jout = jax_apply(*rgb, prepare_lut(lut), interp, strategy="mxu",
                     precision="exact", interpret=True)
    np.testing.assert_allclose(got, np.stack([np.asarray(c) for c in jout]),
                               rtol=0, atol=1e-4)


def test_unknown_interp_is_tetrahedral():
    lut = random_lut(5, seed=2)
    rgb = rgb_planes(3, (4, 16))
    np.testing.assert_array_equal(_port(rgb, lut, "cubic"),
                                  _port(rgb, lut, "tetrahedral"))


def test_lut_table_layout():
    lut = random_lut(5, seed=4, domain=DOMAIN)
    t = LutTable.from_lut3d(lut, "cpu")
    assert t.table.shape == (5, 5, 5, 4) and t.table.dtype == torch.float32
    np.testing.assert_array_equal(t.table[..., :3].numpy(), lut.table)
    assert not t.table[..., 3].any()
    assert t.domain_min == tuple(float(x) for x in np.float32(DOMAIN[0]))
    assert not t.has_unit_domain
    with pytest.raises(ValueError):
        LutTable.from_arrays(np.zeros((2, 2, 3, 3)), (0,) * 3, (1,) * 3, "cpu")
