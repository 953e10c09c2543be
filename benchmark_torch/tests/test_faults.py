"""A run whose timed path is broken underneath comes out not correct. The
run skips the harness's look for a card and drives everything else of a
run on the CPU, at tiny sizes; each fault is one the cells can have."""

from __future__ import annotations

import pytest
import torch

from .conftest import run_tiny


def _fault(change):
    def hook(bench):
        make = bench.render_fn_factory

        def factory(lut):
            fn = make(lut)
            return lambda y, u, v: change(fn(y, u, v), (y, u, v))
        bench.render_fn_factory = factory
    return hook


def unchanged(out, inp):
    """The render hands its input back: a step that did nothing."""
    return tuple(p.clone() for p in inp)


def half_batch(out, inp):
    """The second half of the batch is left out: its frames repeat the
    first half's."""
    b = out[0].shape[0] // 2
    return tuple(torch.cat([p[:b], p[:b], p[2 * b:]]) for p in out)


def no_exchange(out, inp):
    """The chunks of every card but the first never come back."""
    b = out[0].shape[0] // 2
    res = tuple(p.clone() for p in out)
    for p in res:
        p[b:] = 0
    return res


def altered(out, inp):
    """An answer altered where it is produced: one luma row off by 3."""
    y = out[0].clone()
    y[:, 0] = (y[:, 0].to(torch.int32) + 3).clamp(0, 255).to(y.dtype)
    return (y,) + tuple(out[1:])


@pytest.mark.parametrize("name", ["t.native", "t.resize", "t.dither",
                                  "t.split"])
def test_sound_run_is_correct(tiny, name):
    out = run_tiny(tiny, name)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    starts = set() if name == "t.split" else {"job_start_p90_ms"}
    assert set(out["metrics"]) == {"fps", "setup_s"} | starts


@pytest.mark.parametrize("name,fault", [
    ("t.native", unchanged), ("t.native", half_batch),
    ("t.native", altered), ("t.dither", half_batch),
    ("t.resize", altered), ("t.split", no_exchange),
    ("t.split", half_batch)])
def test_broken_path_is_not_correct(tiny, name, fault):
    out = run_tiny(tiny, name, hook=_fault(fault))
    assert not out["correct"], out["compared"]


def test_a_path_that_raises_in_the_window_is_not_correct(tiny):
    calls = [0]

    def boom(out, inp):
        calls[0] += 1
        if calls[0] > 60:  # past the warm-up jobs' 42 batches
            raise RuntimeError("kernel launch failed")
        return out
    out = run_tiny(tiny, "t.native", hook=_fault(boom))
    assert not out["correct"] and out["failed"] > 0
