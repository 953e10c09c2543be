"""The port's whole-frame render against the JAX package's fused kernel
(ops/fused420.render_fused420) in interpret mode at the "exact" tier, over
the case matrix of test_torch_fused420.py, under the integer contract
(max |d| <= 1 code value on fewer than 1e-3 of pixels). A file of its own
because interpret mode traces the Pallas kernel anew for every case."""

import pytest

from lut_renderer_tpu.ops.fused420 import render_fused420 as jax_fused
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu.ops.render import RenderConfig as JaxConfig

from test_torch_fused420 import CASES, lut, port_render  # noqa: F401
from torch_parity import assert_integer_contract


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_fused_kernel(lut, name):  # noqa: F811
    got, yuv = port_render(lut, name)
    jcfg = JaxConfig(**CASES[name], lut_precision="exact")
    want = jax_fused(*yuv, prepare_lut(lut), jcfg, interpret=True)
    assert_integer_contract(got, want, f"{name} vs JAX fused")
