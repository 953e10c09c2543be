"""The plain coarse2 LUT (the port's ops.lut3d with a Coarse2Table) against
the JAX package's _run_coarse2_fused in interpret mode at 65^3: every
interpolation under every coarse tier, plus the trilinear-residual
``coarse2f_tri``, on a non-unit domain with inputs at exactly 1.0 and at
the domain max. Within 1e-5 absolute. A file of its own because interpret
mode traces the Pallas kernel anew for every case."""

import numpy as np
import pytest

from lut_renderer_tpu.ops.lut3d import apply_lut_planes as jax_apply
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.ops import lut3d
from lut_renderer_tpu_torch.ops.prepare import Coarse2Table

from torch_parity import DOMAIN, INTERPS, LUT_ATOL, random_lut, rgb_planes, \
    to_torch


@pytest.fixture(scope="module")
def prep65():
    return prepare_lut(random_lut(65, seed=22, domain=DOMAIN))


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("tier", ["coarse2f", "coarse2", "coarse2x"])
def test_plain_coarse2_matches_jax(prep65, tier, interp):
    _check(prep65, tier, interp)


@pytest.mark.parametrize("interp", ["tetrahedral", "prism"])
def test_plain_coarse2_tri_matches_jax(prep65, interp):
    _check(prep65, "coarse2f_tri", interp)


def _check(prep, tier, interp):
    rgb = rgb_planes(13, (6, 64))
    rgb[:, 2, :] = np.float32(1.0)
    rgb[0, 3, :] = np.float32(DOMAIN[1][0])
    table = Coarse2Table.from_prepared(prep, tier, "cpu")
    got = lut3d.apply_lut_planes(*to_torch(*rgb), table, interp)
    want = jax_apply(*rgb, prep, interp, precision=tier, interpret=True)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=LUT_ATOL)
