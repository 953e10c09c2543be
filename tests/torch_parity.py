"""Helpers shared by the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py). Not collected itself.

Inputs come from numpy seeds and go through both packages as numpy
arrays. The tolerances are the repo's parity contracts (ROADMAP.md):
integer planes within 1 code value on fewer than 1e-3 of pixels, float
LUT output within 1e-5 of colorcore.interp and the JAX gather path.
"""

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch.colorcore import Lut3D
from lut_renderer_tpu_torch.ops.render import RenderConfig

# the suite runs under several xdist workers, each with its own threads
torch.set_num_threads(1)

LUT_ATOL = 1e-5
MAX_CODE_DIFF = 1
MAX_DIFF_RATE = 1e-3

INTERPS = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")
# a non-unit .cube domain (DOMAIN_MIN / DOMAIN_MAX)
DOMAIN = ((-0.1, 0.05, 0.0), (1.2, 0.9, 1.0))

# RenderConfig overrides of the whole-frame case matrix
# (tests/test_render_fused420.py's geometries, depths, ranges, dithers and
# interpolations)
CASES = {
    "main_420p8": dict(),
    "ordered": dict(dither="ordered"),
    "random": dict(dither="random"),
    "nearest": dict(interp="nearest"),
    "trilinear": dict(interp="trilinear"),
    "pyramid": dict(interp="pyramid"),
    "prism": dict(interp="prism"),
    "10bit_full_range": dict(in_depth=10, out_depth=10, in_full_range=True,
                             dither="ordered"),
    "10to8_random": dict(in_depth=10, out_depth=8, dither="random"),
    "422p10_master": dict(in_depth=10, out_depth=10, in_subsampling="422",
                          out_subsampling="422"),
    "422p10_to_420p8": dict(in_depth=10, out_depth=8, in_subsampling="422",
                            dither="ordered"),
    "420_to_422p10": dict(out_depth=10, out_subsampling="422",
                          dither="random"),
    "444_roundtrip": dict(in_subsampling="444", out_subsampling="444",
                          dither="ordered"),
    "420_to_444": dict(out_subsampling="444"),
    "444_to_420": dict(in_subsampling="444"),
}
# (batch, height, width) where a case differs from (1, 16, 256)
CASE_SHAPES = {"444_roundtrip": (1, 16, 255)}  # odd width, 4:4:4 in and out


def random_lut(n: int, seed: int, amp: float = 0.05, domain=None) -> Lut3D:
    """Identity plus a bounded seeded perturbation, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    lut = Lut3D.identity(n)
    table = np.clip(lut.table + rng.uniform(-amp, amp, lut.table.shape)
                    .astype(np.float32), 0, 1).astype(np.float32)
    if domain is None:
        return Lut3D(table=table, title=f"random{n}")
    dmin, dmax = (np.asarray(d, np.float32) for d in domain)
    return Lut3D(table=table, title=f"random{n}", domain_min=dmin,
                 domain_max=dmax)


def planes(seed: int, b: int, h: int, w: int, depth: int, in_sub: str = "420"):
    """Random integer (y, u, v) planes; b=0 gives unbatched (H, W) planes."""
    rng = np.random.default_rng(seed)
    hi = (1 << depth) - 1
    dt = np.uint16 if depth > 8 else np.uint8
    hc = h // 2 if in_sub == "420" else h
    wc = w // 2 if in_sub in ("420", "422") else w
    lead = (b,) if b else ()
    return tuple(rng.integers(0, hi + 1, lead + shape).astype(dt)
                 for shape in ((h, w), (hc, wc), (hc, wc)))


def case_inputs(name: str):
    """(the port's RenderConfig, seeded (y, u, v) numpy planes) of case
    `name` of CASES."""
    cfg = RenderConfig(**CASES[name])
    b, h, w = CASE_SHAPES.get(name, (1, 16, 256))
    return cfg, planes(7, b, h, w, cfg.in_depth, cfg.in_subsampling)


def rgb_planes(seed: int, shape=(16, 64)) -> np.ndarray:
    """(3, *shape) float32 RGB with a margin outside [0, 1] (the clip),
    exact grid points and ties between the deltas (the strict comparisons)."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.05, 1.05, (3,) + shape).astype(np.float32)
    rgb[:, 0, :8] = np.float32(0.5)
    rgb[:, 1, :8] = np.linspace(0, 1, 8, dtype=np.float32)
    return rgb


def to_torch(*arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def to_numpy(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_integer_contract(got, want, what=""):
    """max |d| <= 1 code value, on fewer than 1e-3 of the pixels; shapes
    and dtypes equal."""
    for name, a, e in zip("yuv", got, want):
        a, e = to_numpy(a), to_numpy(e)
        assert a.shape == e.shape, (what, name, a.shape, e.shape)
        assert a.dtype == e.dtype, (what, name, a.dtype, e.dtype)
        d = np.abs(a.astype(np.int64) - e.astype(np.int64))
        assert d.max() <= MAX_CODE_DIFF, f"{what} plane {name} max|d|={d.max()}"
        rate = float(np.mean(d > 0))
        assert rate < MAX_DIFF_RATE, f"{what} plane {name} rate {rate}"


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)
