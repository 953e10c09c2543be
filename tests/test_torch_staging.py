"""The device loop's staging thread (``engine.executor.stage_ahead``) on the
CPU, with plain staging functions: order and counts, how far it runs
ahead, errors raised on the caller's thread after the items before them,
closing while the source blocks, its spans and counters. Then
``render_batches`` on the CPU, which runs the card's loop through it:
batches staged ahead on the thread, every held output that of its own
batch, one batch in flight, and a source's error after its batches."""

import threading
import time

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch import spans
from lut_renderer_tpu_torch.engine.executor import (StageStats,
                                                    render_batches,
                                                    stage_ahead)
from lut_renderer_tpu_torch.ops.render import RenderConfig, make_render_fn

from torch_parity import planes, random_lut

torch.set_num_threads(1)
CPU = torch.device("cpu")

JOIN_S = 10.0


def _items(n):
    """Host-batch-like items: (index, count), the last batch short."""
    return [(i, 2 if i < n - 1 else 1) for i in range(n)]


def _stage(item):
    i, count = item
    return ("staged", i), count


def _new_threads(before):
    return [t for t in threading.enumerate()
            if t not in before and t.name == "executor.stage_ahead"]


def _joined(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    return not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_order_and_counts_are_kept(n):
    before = set(threading.enumerate())
    stats = StageStats()
    got = [staged for staged, _ in stage_ahead(iter(_items(n)), _stage,
                                               stats=stats)]
    assert got == [(("staged", i), c) for i, c in _items(n)]
    assert _joined(_new_threads(before))
    assert stats.take_s > 0 and (stats.stage_s > 0) == (n > 0)


def _until(cond):
    deadline = time.perf_counter() + JOIN_S
    while not cond():
        assert time.perf_counter() < deadline
        time.sleep(0.001)


def test_runs_at_most_one_item_ahead():
    n = 7
    taken, asked, ahead = [0], [], []

    def source():
        for item in _items(n):
            asked.append(item[0])
            yield item
        asked.append(n)   # the end

    def stage(item):
        # items the caller has not taken yet, besides this one
        ahead.append(item[0] - taken[0])
        return _stage(item)

    before = set(threading.enumerate())
    readies = []
    for (staged, _), ready in stage_ahead(source(), stage):
        i = staged[1]
        taken[0] += 1
        readies.append(ready)
        # a slow loop: the thread has handed item i + 1 over once it asks
        # the source for the one after, and then waits on the hand-off
        _until(lambda: len(asked) >= min(i + 3, n + 1))
    assert _joined(_new_threads(before))
    assert max(ahead) == 1 and min(ahead) >= 0
    assert readies[1:] == [True] * (n - 1)


def test_a_slow_stage_is_not_ready():
    n = 4
    asking = [threading.Event() for _ in range(n)]

    def stage(item):
        # staged only after the loop has asked for it
        assert asking[item[0]].wait(JOIN_S)
        time.sleep(0.1)
        return _stage(item)

    gen = stage_ahead(iter(_items(n)), stage)
    readies = []
    for i in range(n):
        asking[i].set()
        readies.append(next(gen)[1])
    assert next(gen, None) is None
    assert readies == [False] * n


@pytest.mark.parametrize("where", ["source", "stage"])
def test_an_error_is_raised_after_the_items_before_it(where):
    k = 3

    class Broken(Exception):
        pass

    def source():
        for item in _items(7):
            if where == "source" and item[0] == k:
                raise Broken(item[0])
            yield item

    def stage(item):
        if where == "stage" and item[0] == k:
            raise Broken(item[0])
        return _stage(item)

    before = set(threading.enumerate())
    got = []
    with pytest.raises(Broken) as info:
        for staged, _ in stage_ahead(source(), stage):
            got.append(staged[0][1])
    assert got == list(range(k))
    assert info.value.args == (k,)
    assert _joined(_new_threads(before))


def test_close_does_not_wait_on_a_blocked_source():
    release = threading.Event()
    returned = threading.Event()

    def source():
        yield (0, 2)
        release.wait()   # blocks until the test lets it go
        returned.set()
        yield (1, 2)

    before = set(threading.enumerate())
    gen = stage_ahead(source(), _stage)
    assert next(gen)[0] == (("staged", 0), 2)
    (thread,) = _new_threads(before)
    t0 = time.perf_counter()
    gen.close()
    assert time.perf_counter() - t0 < 1.0
    assert thread.is_alive()   # still inside the source
    release.set()
    thread.join(timeout=JOIN_S)
    assert returned.is_set() and not thread.is_alive()


def test_close_stops_a_thread_waiting_on_the_hand_off():
    staged = []

    def stage(item):
        staged.append(item[0])
        return _stage(item)

    before = set(threading.enumerate())
    gen = stage_ahead(iter(_items(50)), stage)
    next(gen)
    (thread,) = _new_threads(before)
    gen.close()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive()
    # the taken item, one waiting and one being staged at most
    assert len(staged) <= 3


def _profiled(fn):
    with spans.span("between"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


def test_spans_run_on_the_staging_thread_under_the_call():
    stats = StageStats()

    def run_ahead():
        with spans.span("executor.run") as run:
            out = list(stage_ahead(iter(_items(3)), _stage, run, stats))
        return out

    _profiled(run_ahead)
    recs = spans.records()
    (run,) = [r for r in recs if r.name == "executor.run"]
    takes = [r for r in recs if r.name == "executor.take"]
    pins = [r for r in recs if r.name == "executor.pin"]
    assert [r.attrs["batch"] for r in takes] == [0, 1, 2, 3]  # 4th: the end
    assert [r.attrs["batch"] for r in pins] == [0, 1, 2]
    for r in takes + pins:
        assert r.parent == r.call == run.id
        assert r.thread != run.thread == threading.get_native_id()
    assert stats.take_s == pytest.approx(
        sum(r.end_ns - r.start_ns for r in takes) * 1e-9)
    assert stats.stage_s == pytest.approx(
        sum(r.end_ns - r.start_ns for r in pins) * 1e-9)


def _host_batches(n):
    """n host batches of 2 frames whose planes differ, the last one short."""
    return [(*planes(40 + s, 2, 16, 32, 8), 2 if s < n - 1 else 1)
            for s in range(n)]


def test_render_batches_on_the_cpu_stages_on_its_own_thread():
    """The staging thread takes and pins every batch, and a batch it
    staged while the loop rendered the one before counts as ready."""
    n = 5
    asked = []

    def source():
        for i, batch in enumerate(_host_batches(n)):
            asked.append(i)
            yield batch
        asked.append(n)   # the end

    fn = make_render_fn(None, RenderConfig(apply_lut=False), "cpu")
    rendered = [0]

    def render(*planes):
        i = rendered[0]
        rendered[0] += 1
        # the thread has handed batch i + 1 over once it asks the source
        # for the one after
        _until(lambda: len(asked) >= min(i + 3, n + 1))
        return fn(*planes)

    stats = StageStats()
    outs = _profiled(lambda: list(render_batches(source(), render, CPU,
                                                 stats)))
    assert [o[3] for o in outs] == [b[3] for b in _host_batches(n)]
    assert stats.batches == n and stats.staged_ready >= n - 1
    recs = spans.records()
    (run,) = [r for r in recs if r.name == "executor.run"]
    pins = [r for r in recs if r.name == "executor.pin"]
    assert [r.attrs["batch"] for r in pins] == list(range(n))
    assert all(r.thread != run.thread for r in pins)
    assert run.thread == threading.get_native_id()


def test_render_batches_on_the_cpu_keeps_every_output():
    """A consumer that holds every output of batches with different planes
    gets, for each batch, what the render function gives on that batch
    alone; batch N comes out once batch N + 1 is rendered."""
    batches = _host_batches(9)
    fn = make_render_fn(random_lut(17, seed=6),
                        RenderConfig(dither="ordered"), "cpu")
    rendered = [0]

    def render(*planes):
        rendered[0] += 1
        return fn(*planes)

    got, renders_before = [], []
    for out in render_batches(iter(batches), render, CPU):
        got.append(out)
        renders_before.append(rendered[0])
    assert renders_before == [2, 3, 4, 5, 6, 7, 8, 9, 9]
    assert [g[3] for g in got] == [b[3] for b in batches]
    for g, b in zip(got, batches):
        alone = fn(*(torch.from_numpy(a) for a in b[:3]))
        for a, e in zip(g[:3], alone):
            assert isinstance(a, np.ndarray)
            assert np.array_equal(a, e.numpy())


@pytest.mark.parametrize("k", [0, 3])
def test_render_batches_on_the_cpu_raises_a_source_error_after_its_batches(k):
    class Broken(Exception):
        pass

    takers = set()

    def source():
        for i, batch in enumerate(_host_batches(7)):
            takers.add(threading.current_thread())
            if i == k:
                raise Broken(i)
            yield batch

    fn = make_render_fn(None, RenderConfig(apply_lut=False), "cpu")
    got = []
    with pytest.raises(Broken) as info:
        for out in render_batches(source(), fn, CPU):
            got.append(out[3])
    assert got == [2] * k
    assert info.value.args == (k,)
    # the source ran on the staging thread, which has retired
    (taker,) = takers
    assert taker.name == "executor.stage_ahead"
    assert _joined([taker])
