"""The port's pixel ops (lut_renderer_tpu_torch.ops.pixel) against the JAX
package's ops/pixel.py on the same seeded inputs. These are the same
scalar operations in the same order on the same float32 values, so float
outputs are held to equality and integer planes to bit equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lut_renderer_tpu.colorcore.dither import hash_noise_offsets
from lut_renderer_tpu.ops import pixel as jpx
from lut_renderer_tpu_torch.ops import pixel as tpx

from torch_parity import to_numpy


def _codes(seed, shape, depth):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, shape).astype(np.float32)


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("in_full,out_full", [(True, False), (False, True),
                                              (False, False)])
def test_range_normalize(depth, in_full, out_full):
    y, u, v = (_codes(s, (16, 256), depth) for s in (1, 2, 3))
    got = tpx.range_normalize(*(torch.from_numpy(a) for a in (y, u, v)),
                              depth, in_full, out_full)
    want = jpx.range_normalize(*(jnp.asarray(a) for a in (y, u, v)),
                               depth, in_full, out_full)
    for a, e in zip(got, want):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(e))


@pytest.mark.parametrize("matrix", ["bt709", "bt601", "bt2020nc"])
@pytest.mark.parametrize("depth,full", [(8, False), (10, False), (8, True)])
def test_yuv_rgb_roundtrip_planes(matrix, depth, full):
    y, u, v = (_codes(s, (16, 256), depth) for s in (4, 5, 6))
    got = tpx.yuv_planes_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)),
                                matrix, depth, full)
    want = jpx.yuv_planes_to_rgb(*(jnp.asarray(a) for a in (y, u, v)),
                                 matrix, depth, full)
    for a, e in zip(got, want):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(e))
    back = tpx.rgb_to_yuv_planes(*got, matrix, depth, full)
    jback = jpx.rgb_to_yuv_planes_tpu(*want, matrix, depth, full)
    for a, e in zip(back, jback):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(e))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_chroma_upsample_420(mode):
    c = _codes(7, (2, 8, 128), 8)
    got = tpx.chroma_upsample_420(torch.from_numpy(c), mode)
    want = jpx.chroma_upsample_420(jnp.asarray(c), mode)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_chroma_resamplers():
    c = _codes(8, (2, 16, 256), 10) + np.float32(0.25)
    t, j = torch.from_numpy(c), jnp.asarray(c)
    for tf, jf in ((tpx.chroma_downsample_420, jpx.chroma_downsample_420),
                   (tpx.chroma_downsample_422, jpx.chroma_downsample_422),
                   (tpx.chroma_resample_422_to_444,
                    jpx.chroma_resample_422_to_444)):
        np.testing.assert_array_equal(to_numpy(tf(t)), np.asarray(jf(j)))
    with pytest.raises(ValueError):
        tpx.chroma_upsample_420(t, "cubic")


@pytest.mark.parametrize("stride,offset", [(1, 0), (2, 0), (2, 1), (4, 3)])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_hash_noise_offsets_bit_equal(stride, offset, seed):
    got = to_numpy(tpx.hash_noise_offsets(24, 300, seed, stride, offset))
    want = np.asarray(jpx.hash_noise_offsets_jnp(24, 300, seed, stride,
                                                 offset))
    np.testing.assert_array_equal(got, want)
    if (stride, offset) == (1, 0):
        np.testing.assert_array_equal(got, hash_noise_offsets(24, 300, seed))


@pytest.mark.parametrize("dither", ["none", "ordered", "random"])
@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("stride,offset", [(1, 0), (2, 1)])
def test_quantize_plane_bit_equal(dither, depth, stride, offset):
    rng = np.random.default_rng(9)
    hi = float((1 << depth) - 1)
    # values around half-codes and outside the range exercise the rounding
    # and the clip
    x = (rng.integers(-4, int(hi) + 4, (2, 20, 140)).astype(np.float32)
         + rng.choice(np.float32([0.0, 0.49, 0.5, 0.51]), (2, 20, 140)))
    got = tpx.quantize_plane(torch.from_numpy(x), depth, dither,
                             plane_seed=2, row_stride=stride,
                             row_offset=offset)
    want = jpx.quantize_plane(jnp.asarray(x), depth, dither, plane_seed=2,
                              row_stride=stride, row_offset=offset)
    assert got.dtype == (torch.uint8 if depth == 8 else torch.uint16)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_ordered_offsets_reject_bad_stride():
    with pytest.raises(ValueError):
        tpx.ordered_offsets(4, 4, row_stride=3)
