"""The frame batch split across devices (lut_renderer_tpu_torch.parallel)
on a device list that repeats the CPU: bit-equal to the unsharded render
function for odd and padded batches, on the main and the resize paths,
against the JAX package's unsharded
render within the integer contract (max |d| <= 1 code value on fewer than
1e-3 of pixels), and the executor's split end to end (mirrors
tests/test_parallel.py and tests/test_engine_mesh.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from lut_renderer_tpu.ops import render as jrender
from lut_renderer_tpu.ops.prepare import prepare_lut
from lut_renderer_tpu_torch.colorcore import write_cube_file
from lut_renderer_tpu_torch.engine import executor, run_stage
from lut_renderer_tpu_torch.hostio import VideoDecoder, probe_video
from lut_renderer_tpu_torch.models import ProcessingParams
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn
from lut_renderer_tpu_torch.parallel import (
    default_mesh,
    make_sharded_render_fn,
    shard_batch_size,
)
from lut_renderer_tpu_torch.parallel.sharding import put_sharded
from lut_renderer_tpu_torch.plan import build_render_spec
from lut_renderer_tpu_torch.tasks import load_lut_table
from lut_renderer_tpu_torch.utils.fixtures import make_gradient_clip

from torch_parity import assert_integer_contract, planes, random_lut, to_torch

CPUS = ["cpu", "cpu"]
CONFIGS = {
    "main": dict(),
    "resize": dict(resize=(48, 24)),
    "ordered_10bit": dict(in_depth=10, out_depth=10, dither="ordered"),
    "error_diffusion": dict(dither="error_diffusion_host", resize=(32, 16)),
}


@pytest.fixture(scope="module")
def lut():
    return random_lut(17, seed=41)


def _equal(got, want):
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == e.dtype
        assert torch.equal(a, e)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_split_is_bit_equal_to_unsharded_for_odd_and_padded_batches(
        lut, name):
    cfg = RenderConfig(**CONFIGS[name])
    y, u, v = planes(5, 3, 32, 64, cfg.in_depth)
    whole = make_render_fn(lut, cfg, "cpu")(*to_torch(y, u, v))
    fn = make_sharded_render_fn(lut, cfg, CPUS)
    _equal(fn(*to_torch(y, u, v)), whole)  # chunks of 2 and 1
    # the executor's padding: the last frame repeated up to a multiple
    padded = [np.concatenate([p, p[-1:]]) for p in (y, u, v)]
    got = fn(*to_torch(*padded))
    _equal([g[:3] for g in got], whole)
    _equal([g[3:] for g in got], [w[2:] for w in whole])
    # numpy inputs split the same way
    _equal(fn(y, u, v), whole)


@pytest.mark.parametrize("size,precision,depth", [
    (33, "auto", 8), (33, "int8_fast", 10), (65, "coarse2f", 8)])
def test_split_matches_the_jax_unsharded_render(size, precision, depth):
    lut = random_lut(size, seed=size)
    kw = dict(interp="tetrahedral", lut_precision=precision,
              in_depth=depth, out_depth=depth)
    y, u, v = planes(7, shard_batch_size(CPUS, per_device_frames=2), 32,
                     128, depth)
    got = make_sharded_render_fn(lut, RenderConfig(**kw), CPUS)(
        *to_torch(y, u, v))
    jkw = dict(kw, lut_strategy="mxu" if precision == "coarse2f"
               else "gather")
    want = jrender.render_yuv_frame(y, u, v, prepare_lut(lut),
                                    jrender.RenderConfig(**jkw),
                                    interpret=True)
    assert_integer_contract(got, want, f"split {size} {precision} {depth}")
    _equal(got, make_render_fn(lut, RenderConfig(**kw), "cpu")(
        *to_torch(y, u, v)))


def test_more_devices_than_frames_leaves_devices_idle(lut):
    cfg = RenderConfig()
    y, u, v = to_torch(*planes(9, 3, 16, 32, 8))
    whole = make_render_fn(lut, cfg, "cpu")(y, u, v)
    _equal(make_sharded_render_fn(lut, cfg, ["cpu"] * 5)(y, u, v), whole)
    with pytest.raises(ValueError, match="no devices"):
        make_sharded_render_fn(lut, cfg, [])


def test_put_sharded_and_shard_batch_size():
    y = np.arange(5 * 2 * 3, dtype=np.uint8).reshape(5, 2, 3)
    (chunks,) = put_sharded(["cpu", "cpu"], y)
    assert [c.shape[0] for c in chunks] == [3, 2]
    assert np.array_equal(torch.cat(chunks).numpy(), y)
    assert shard_batch_size(["cpu"] * 3) == 3
    assert shard_batch_size(["cpu"] * 3, per_device_frames=4) == 12


def test_default_mesh_and_the_stage_devices(monkeypatch):
    assert default_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert executor.stage_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_mesh()
    # a machine with two cards: plain "cuda" splits, "cuda:N" pins one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert default_mesh() == cards
    assert executor.stage_devices("cuda") == cards
    assert executor.stage_devices("cuda", use_mesh=False) == [cards[0]]
    assert executor.stage_devices("cuda:1") == [cards[1]]
    assert executor.stage_devices("cuda:1", use_mesh=True) == cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert executor.stage_devices("cuda") == [cards[0]]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_split")
    clip = make_gradient_clip(d / "c.mp4", 64, 64, fps=25.0, frames=11)
    cube = write_cube_file(d / "l.cube", random_lut(9, seed=42))
    return clip, cube


@pytest.mark.parametrize("resolution", [None, "32x48"])
def test_stage_split_vs_single_device(clip, tmp_path, monkeypatch,
                                      resolution):
    """run_stage with the batch split over two CPU "devices" writes the
    same frames as the unsplit stage (ffv1 is lossless), the batch rounded
    up to a multiple of the device count."""
    clip, cube = clip
    monkeypatch.setattr(executor, "default_mesh", lambda: default_mesh(CPUS))
    info = probe_video(clip)
    outs = {}
    for name, use_mesh in (("split", True), ("single", False)):
        spec = build_render_spec(
            Path(clip), tmp_path / f"{name}.mkv",
            ProcessingParams(video_codec="ffv1", resolution=resolution or ""),
            Path(cube), info)
        logs = []
        res = run_stage(spec, info, load_lut_table(cube, "cpu"),
                        log_cb=logs.append, device="cpu", batch_size=3,
                        use_mesh=use_mesh)
        assert res.ok, res.error
        split_logs = [m for m in logs if "split over 2 devices" in m]
        assert bool(split_logs) == use_mesh
        if use_mesh:
            assert "batch=4" in split_logs[0]
            assert res.stats.batches == 3  # 11 frames in batches of 4
            # the split's counters: a padded batch renders whole
            assert res.stats.split.calls == 3
            assert res.stats.split.frames == [6, 6]
            assert "split over 2 devices: 3 calls" in res.stats.summary()
        else:
            assert res.stats.split is None
        with VideoDecoder(spec.output) as dec:
            outs[name] = [(f.y.copy(), f.u.copy(), f.v.copy()) for f in dec]
    assert len(outs["split"]) == len(outs["single"]) == 11
    for a, b in zip(outs["split"], outs["single"]):
        for p, q in zip(a, b):
            assert np.array_equal(p, q)
