"""The split's spans and counters (``parallel.sharding``) on the CPU: the
bytes it copies between cards, counted from shapes (no card needed to
name one); the ``sharding.*`` spans under a CPU profile, with a card per
chunk, and ``SplitStats`` over the calls; the split over four CPU devices
on the ``uhd8k_420p10_cube33`` pipeline at a small size, against the
benchmark's plain reference (``benchmark_torch/reference.py``, plain
torch, no JAX) within the integer contract and bit-equal to the unsplit
render function; and the counters in the stage's stats line."""

import dataclasses
from pathlib import Path

import pytest
import torch

from benchmark_torch import harness, reference, spec, traffic
from benchmark_torch.frames import yuv_frames
from lut_renderer_tpu_torch import spans
from lut_renderer_tpu_torch.engine.executor import StageStats
from lut_renderer_tpu_torch.ops.prepare import LutTable
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.parallel import (SplitStats,
                                             make_sharded_render_fn,
                                             peer_bytes)
from lut_renderer_tpu_torch.parallel.sharding import chunk_frames

from torch_parity import assert_integer_contract, planes, random_lut, to_torch

REPO = Path(__file__).resolve().parent.parent
CARDS = [torch.device("cuda", i) for i in range(4)]
# one 8K 10-bit 4:2:0 batch of 4: luma and two quarter-size chroma planes
SHAPES_8K = [(4, 4320, 7680), (4, 2160, 3840), (4, 2160, 3840)]
FRAME_8K = (4320 * 7680 + 2 * 2160 * 3840) * 2   # 99,532,800 bytes


def _moved(shapes, source, devices, dtype=torch.uint16):
    """A call's count: its inputs from `source` out to the devices, and
    outputs of the same shapes back to the first device."""
    return (peer_bytes(shapes, dtype, source, devices)
            + peer_bytes(shapes, dtype, devices[0], devices))


@pytest.mark.parametrize("devices,batch,want", [
    # three of the four chunks go out to their cards and come back
    (CARDS, 4, 6 * FRAME_8K),
    # chunks of 2, 2, 1 and 1: the three on other cards hold 4 frames
    (CARDS, 6, 8 * FRAME_8K),
    # every chunk on the source's own card
    ([CARDS[0]] * 4, 4, 0),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], 4, 4 * FRAME_8K),
])
def test_bytes_between_cards_from_shapes(devices, batch, want):
    shapes = [(batch, *s[1:]) for s in SHAPES_8K]
    assert _moved(shapes, devices[0], devices) == want


def test_the_8k_batch_of_4_over_four_cards_moves_597_mb():
    assert _moved(SHAPES_8K, CARDS[0], CARDS) == 597_196_800
    # from the host the chunks go in by the host's copies; only the
    # gather home crosses between cards
    assert peer_bytes(SHAPES_8K, torch.uint16, "cpu", CARDS) == 0
    assert _moved(SHAPES_8K, "cpu", CARDS) == 3 * FRAME_8K
    # 8-bit planes are half the bytes
    assert _moved(SHAPES_8K, CARDS[0], CARDS, torch.uint8) == 298_598_400
    # a chunk on a card the batch does not come from counts both ways
    assert peer_bytes(SHAPES_8K, torch.uint16, CARDS[1], CARDS) == \
        3 * FRAME_8K


@pytest.mark.parametrize("batch,parts", [(4, 4), (6, 4), (3, 4), (5, 2),
                                         (11, 3), (0, 2)])
def test_chunk_frames_are_tensor_splits(batch, parts):
    want = [len(c) for c in torch.tensor_split(torch.arange(batch), parts)]
    assert chunk_frames(batch, parts) == want


def _profiled(fn):
    """fn() under a CPU profile, after a span that finds none, so the
    profile's first span begins a new recording."""
    with spans.span("between"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


def test_spans_of_each_call_and_the_split_stats():
    fn = make_sharded_render_fn(random_lut(9, seed=3), RenderConfig(),
                                ["cpu"] * 4)
    six = to_torch(*planes(31, 6, 16, 32, 8))
    three = to_torch(*planes(32, 3, 16, 32, 8))
    _profiled(lambda: (fn(*six), fn(*three)))
    recs = spans.records()
    calls = [r for r in recs if r.name == "sharding.call"]
    assert [(r.attrs["cards"], r.attrs["frames"], r.attrs["peer_bytes"])
            for r in calls] == [(4, 6, 0), (4, 3, 0)]
    for call, chunks in zip(calls, ([2, 2, 1, 1], [1, 1, 1])):
        mine = [r for r in recs if r.parent == call.id]
        assert all(r.call == call.id and r.start_ns >= call.start_ns
                   and r.end_ns <= call.end_ns for r in mine)
        assert [r.name for r in mine] == (
            ["sharding.put"] + ["sharding.chunk"] * len(chunks)
            + ["sharding.gather"])
        got = [(r.attrs["card"], r.attrs["frames"]) for r in mine
               if r.name == "sharding.chunk"]
        assert got == list(enumerate(chunks))
        assert call.parent is None and call.call == call.id
    assert fn.stats == SplitStats(calls=2, frames=[3, 3, 2, 1],
                                  peer_bytes=0)


def test_the_split_stats_count_without_a_profiler():
    fn = make_sharded_render_fn(None, RenderConfig(apply_lut=False),
                                ["cpu"] * 2)
    for seed in range(3):
        fn(*to_torch(*planes(seed, 5, 8, 16, 8)))
    assert fn.stats == SplitStats(calls=3, frames=[9, 6], peer_bytes=0)


def test_the_stage_stats_line_shows_the_split():
    stats = StageStats(frames_out=8, wall_s=1.0, batches=2)
    assert "split over" not in stats.summary()
    stats.split = SplitStats(calls=2, frames=[2, 2, 2, 2],
                             peer_bytes=1_194_393_600)
    line = stats.summary()
    assert line.endswith("; split over 4 devices: 2 calls, frames 2/2/2/2, "
                         "1194.4 MB between cards")


def _small_8k_cell(w=96, h=48):
    cell = spec.load_cell("uhd8k10_c33.split4", REPO)
    return dataclasses.replace(cell, config=dict(
        cell.config, probe=dict(cell.config["probe"], width=w, height=h)))


def test_split_over_four_devices_on_the_8k_pipeline_matches_the_reference():
    cell = _small_8k_cell()
    cfg = harness.derive_config(cell)
    pipe, n = cell.config["pipeline"], cell.config["lut_size"]
    assert (n, cfg.in_depth, cfg.out_depth, cfg.dither) == (33, 10, 10,
                                                            "none")
    table = traffic.look_table(cell.traffic, n, 0)
    lut = LutTable.from_arrays(table, (0, 0, 0), (1, 1, 1), "cpu")
    y, u, v = yuv_frames(2 ** 31 + 13, 6, 48, 96, pipe["in_depth"],
                         pipe["in_subsampling"])
    split = make_sharded_render_fn(lut, cfg, ["cpu"] * 4)
    got = split(*to_torch(y, u, v))
    assert [tuple(p.shape) for p in got] == [(6, 48, 96), (6, 24, 48),
                                             (6, 24, 48)]
    assert got[0].dtype == torch.uint16
    whole = make_render_fn(lut, cfg, "cpu")(*to_torch(y, u, v))
    for a, e in zip(got, whole):
        assert torch.equal(a, e)
    want = reference.render(*to_torch(y, u, v), torch.from_numpy(table),
                            pipe, None)
    assert_integer_contract([p.to(torch.int32).numpy() for p in got],
                            [p.to(torch.int32).numpy() for p in want],
                            "split4 pipeline")
    assert split.stats.frames == [2, 2, 1, 1]

