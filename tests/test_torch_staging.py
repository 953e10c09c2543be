"""The device loop's staging thread (``engine.executor.stage_ahead``) on the
CPU, with plain staging functions: order and counts, how far it runs
ahead, errors raised on the caller's thread after the items before them,
closing while the source blocks, its spans and counters."""

import threading
import time

import pytest
import torch

from lut_renderer_tpu_torch import spans
from lut_renderer_tpu_torch.engine.executor import StageStats, stage_ahead

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


def test_spans_run_on_the_staging_thread_under_the_call():
    stats = StageStats()

    def run_ahead():
        with spans.span("executor.run") as run:
            out = list(stage_ahead(iter(_items(3)), _stage, run, stats))
        return out

    with spans.span("between"):
        pass
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        run_ahead()
    finally:
        prof.stop()
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
