"""The roofline counts, from shapes."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark_torch import roofline
from benchmark_torch.reference import bicubic_weights

PIPE_8 = {"in_depth": 8, "out_depth": 8, "in_subsampling": "420",
          "out_subsampling": "420"}


def test_kernel_b_4k_pair_33_is_bound_by_operations():
    ms, by = roofline.kernel_b_bound(2, 2160, 3840, PIPE_8, 33)
    assert by == "operations"
    assert ms == pytest.approx(103 * 2 * 2160 * 3840 / 67e12 * 1e3)
    assert round(ms, 4) == 0.0255


def test_kernel_b_bytes_count_each_plane_once():
    pipe = dict(PIPE_8, in_depth=10, out_depth=10)
    assert roofline.yuv_bytes(1, 4320, 7680, 10, "420") == \
        2 * 4320 * 7680 * 3 // 2
    ms, by = roofline.kernel_b_bound(1, 4320, 7680, pipe, 33)
    nbytes = 2 * 2 * 4320 * 7680 * 3 // 2 + 33 ** 3 * 12
    assert ms == pytest.approx(max(nbytes / 3.35e12,
                                   103 * 4320 * 7680 / 67e12) * 1e3)


def test_kernel_a_4k_pair_is_bound_by_bytes():
    ms, by = roofline.kernel_a_bound(2, 2160, 3840, 33)
    assert by == "bytes"
    assert ms == pytest.approx((24 * 2 * 2160 * 3840 + 33 ** 3 * 12)
                               / 3.35e12 * 1e3)
    assert round(ms, 3) == 0.119


def test_resample_counts_the_banded_taps():
    wv, wh = bicubic_weights(2160, 1080), bicubic_weights(3840, 1920)
    # a 2:1 downscale widens the bicubic's 4 taps to a window of 9, whose
    # end taps weigh nothing; the border rows fold taps onto the edge
    nz_v = (wv != 0).sum(axis=1)
    assert nz_v[4:-4].min() >= 7 and nz_v.max() <= 9
    flops = roofline.resample_banded_flops(wv, wh, 2)
    manual = 0
    for _ in range(3 * 2):
        for row in wv:   # vertical pass: each tap over the W columns
            manual += 2 * int(np.count_nonzero(row)) * 3840
        for row in wh:   # horizontal pass: each tap over the out_h rows
            manual += 2 * int(np.count_nonzero(row)) * 1080
    assert flops == manual
    dense = 3 * 2 * 2 * (1080 * 2160 * 3840 + 1080 * 3840 * 1920)
    assert flops < dense / 100
    ms, by = roofline.resample_bound(wv, wh, 2)
    assert by == "bytes"
    assert ms == pytest.approx(3 * 2 * 4 * (2160 * 3840 + 1080 * 1920)
                               / 3.35e12 * 1e3)
