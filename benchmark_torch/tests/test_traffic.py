"""The traffic and its inputs are the same for a seed and differ across
seeds; a .cube the benchmark writes reads back bit for bit."""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

from benchmark_torch import frames, traffic

from .conftest import HERE

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
SEED = 2 ** 31 + 12345


def mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def plan(name: str, seed: int, n: int = 64):
    return list(itertools.islice(traffic.jobs(mix(name), seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_plan_repeats_for_a_seed(name):
    assert plan(name, SEED) == plan(name, SEED)


@pytest.mark.parametrize("name", [m for m in MIXES
                                  if mix(m)["kind"] == "queue"])
def test_plan_differs_across_seeds_with_the_same_mix(name):
    a, b = plan(name, SEED), plan(name, SEED + 1)
    assert [j.frames for j in a] != [j.frames for j in b]
    assert [j.pool_start for j in a] != [j.pool_start for j in b]
    # every block of clip lengths holds the same lengths, in another order
    k = mix(name)["clip_block"]
    for i in range(0, 64 - k + 1, k):
        assert sorted(j.frames for j in a[i:i + k]) == \
            sorted(j.frames for j in b[i:i + k])
    lo, hi = mix(name)["clip_frames"]
    assert min(j.frames for j in a) == lo and max(j.frames for j in a) == hi
    # which look a job takes is the mix's, for every seed
    assert [j.look for j in a] == [j.look for j in b]


def test_zipf_looks_follow_their_weights():
    m = mix("queue_1080p_24_480_zipf8")
    counts = traffic.look_counts(m)
    assert counts == [24, 12, 8, 6, 5, 4, 3, 3]
    looks = [j.look for j in plan("queue_1080p_24_480_zipf8", SEED,
                                  sum(counts))]
    assert [looks.count(i) for i in range(8)] == counts


def test_looks_are_seeded_tables():
    m = mix("queue_4k_24_240_looks4")
    a = traffic.look_table(m, 17, 1)
    assert a.shape == (17, 17, 17, 3) and a.dtype == np.float32
    assert np.array_equal(a, traffic.look_table(m, 17, 1))
    assert not np.array_equal(a, traffic.look_table(m, 17, 2))
    assert a.min() >= 0 and a.max() <= 1


def test_cube_reads_back_exactly_through_the_program(tmp_path):
    from lut_renderer_tpu_torch.colorcore import parse_cube_file

    m = mix("queue_1080p_24_480_zipf8")
    path = traffic.look_path(tmp_path, m, 17, 3)
    assert path.exists() and traffic.look_path(tmp_path, m, 17, 3) == path
    parsed = parse_cube_file(path)
    assert np.array_equal(parsed.table, traffic.look_table(m, 17, 3))
    assert parsed.has_unit_domain


@pytest.mark.parametrize("depth,sub", [(8, "420"), (10, "420"), (10, "422")])
def test_frames_repeat_for_a_seed_and_differ_across_seeds(depth, sub):
    dev = torch.device("cpu")
    a = frames.device_frames(SEED, 3, 16, 32, depth, sub, dev)
    b = frames.device_frames(SEED, 3, 16, 32, depth, sub, dev)
    c = frames.device_frames(SEED + 1, 3, 16, 32, depth, sub, dev)
    hc, wc = frames.chroma_shape(16, 32, sub)
    assert [p.shape for p in a] == [(3, 16, 32), (3, hc, wc), (3, hc, wc)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert int(a[0].max()) < (1 << depth)
    # the frames of a pool are distinct
    assert not np.array_equal(a[0][0], a[0][1])
    y = frames.yuv_frames(SEED, 2, 16, 32, depth, sub)
    assert all(np.array_equal(p, q)
               for p, q in zip(y, frames.yuv_frames(SEED, 2, 16, 32, depth,
                                                    sub)))
