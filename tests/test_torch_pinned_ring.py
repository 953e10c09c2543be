"""The copy in's pinned ring (``engine.executor.PinnedRing``) on the CPU,
with unpinned blocks and fake events in place of the card's: slots taken in
turn, a slot whose copy in still runs waited for and counted, the device's
ring kept between stages and replaced for another key, the staged bytes
equal to the source, and the counters in ``StageStats.summary()``. The
ring's pinned blocks take the render library's streaming copy
(``csrc/hostcopy.cu``), which builds only where nvcc is: here its ctypes
mirror and its place in the library; on the card, its bytes and the ring
through ``render_batches``: ``tests/test_torch_cuda.py``.
"""

import ctypes
import re
import sys
import threading

import numpy as np
import pytest
import torch

from lut_renderer_tpu_torch.engine import executor
from lut_renderer_tpu_torch.ops import _build
from lut_renderer_tpu_torch.engine.executor import (RING_ALIGN, RING_DEPTH,
                                                    PinnedRing, StageStats,
                                                    lease_ring, return_ring,
                                                    ring_key)

DEVICE = torch.device("cpu")


class FakeEvent:
    """A copy's event: done from the start, or once synchronised."""

    def __init__(self, done: bool = False):
        self.is_done = done
        self.waits = 0

    def query(self) -> bool:
        return self.is_done

    def synchronize(self) -> None:
        self.waits += 1
        self.is_done = True


def _planes(dtype=np.uint8, h=6, w=10, b=2, seed=0):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    return tuple(rng.integers(0, hi, (b,) + shape, endpoint=True,
                              dtype=dtype)
                 for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


def _ring(planes=None):
    return PinnedRing(ring_key(planes or _planes()), pin=False)


@pytest.fixture
def rings(monkeypatch):
    """A process with no ring kept."""
    monkeypatch.setattr(executor, "_RINGS", {})
    return executor._RINGS


@pytest.mark.parametrize("turns", [1, RING_DEPTH, 3 * RING_DEPTH + 1])
def test_slots_are_taken_in_turn(turns):
    ring = _ring()
    assert len(ring.blocks) == RING_DEPTH
    got = []
    for _ in range(turns):
        slot, waited = ring.take()
        ring.done(slot, FakeEvent(done=True))
        got.append((slot, waited))
    assert got == [(i % RING_DEPTH, False) for i in range(turns)]
    assert len({b.data_ptr() for b in ring.blocks}) == RING_DEPTH


@pytest.mark.parametrize("running", [0, 1, RING_DEPTH])
def test_a_slot_whose_copy_in_runs_is_waited_for(running):
    """The first `running` slots' copies are still running when their slots
    come round again: each is waited for once, and only those."""
    ring = _ring()
    events = []
    for i in range(RING_DEPTH):
        slot, waited = ring.take()
        assert (slot, waited) == (i, False)
        events.append(FakeEvent(done=i >= running))
        ring.done(slot, events[-1])
    again = [ring.take() for _ in range(RING_DEPTH)]
    assert again == [(i, i < running) for i in range(RING_DEPTH)]
    assert [e.waits for e in events] == [int(i < running)
                                         for i in range(RING_DEPTH)]
    assert all(e.is_done for e in events)


def test_a_slot_never_marked_done_is_not_waited_for():
    ring = _ring()
    assert [ring.take() for _ in range(2 * RING_DEPTH)] == [
        (i % RING_DEPTH, False) for i in range(2 * RING_DEPTH)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("h,w,b", [(6, 10, 2), (2, 2, 1), (34, 258, 3),
                                   (1080, 1922, 1)])
def test_staged_bytes_equal_the_source(dtype, h, w, b):
    """Odd sizes too: each plane starts on a multiple of RING_ALIGN, and
    its views, of the slot and of a copy of the slot (the device buffer's
    stand-in), hold the source's bytes."""
    src = _planes(dtype, h, w, b, seed=h + w)
    ring = _ring(src)
    assert [off % RING_ALIGN for off, *_ in ring.layout] == [0, 0, 0]
    assert ring.nbytes % RING_ALIGN == 0
    assert ring.nbytes >= sum(a.nbytes for a in src)
    for turn in range(RING_DEPTH + 1):
        fresh = _planes(dtype, h, w, b, seed=turn)
        slot, _ = ring.take()
        block = ring.fill(slot, fresh)
        assert block is ring.blocks[slot]
        for view_of in (block, block.clone()):
            for got, want in zip(ring.views(view_of), fresh):
                assert got.is_contiguous()
                assert tuple(got.shape) == want.shape
                assert np.array_equal(got.numpy(), want)


def test_a_strided_source_is_staged_whole():
    big = _planes(np.uint16, 12, 20, 2, seed=3)
    src = tuple(a[:, ::2] for a in big)
    assert not src[0].flags.c_contiguous
    ring = _ring(src)
    slot, _ = ring.take()
    for got, want in zip(ring.views(ring.fill(slot, src)), src):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("other", [
    _planes(np.uint8, 6, 12), _planes(np.uint16, 6, 10),
    _planes(np.uint8, 6, 10, b=3)], ids=["shape", "dtype", "batch"])
def test_a_new_key_replaces_the_ring(rings, other):
    first, stats = _planes(), StageStats()
    a = lease_ring(DEVICE, ring_key(first), stats, pin=False)
    assert stats.ring_allocs == RING_DEPTH
    return_ring(DEVICE, a)
    again = lease_ring(DEVICE, ring_key(first), stats, pin=False)
    assert again is a and stats.ring_allocs == RING_DEPTH
    return_ring(DEVICE, again)
    b = lease_ring(DEVICE, ring_key(other), stats, pin=False)
    assert b is not a and b.key == ring_key(other)
    assert stats.ring_allocs == 2 * RING_DEPTH
    assert rings == {}  # the old ring is not kept beside the new
    return_ring(DEVICE, b)
    assert lease_ring(DEVICE, ring_key(first), stats, pin=False) is not a
    assert stats.ring_allocs == 3 * RING_DEPTH


def test_a_second_stage_gets_a_ring_of_its_own(rings):
    key, stats = ring_key(_planes()), StageStats()
    a = lease_ring(DEVICE, key, stats, pin=False)
    b = lease_ring(DEVICE, key, stats, pin=False)
    assert a is not b and stats.ring_allocs == 2 * RING_DEPTH
    return_ring(DEVICE, a)
    return_ring(DEVICE, b)
    assert rings == {DEVICE: b}


def test_rings_are_kept_per_device(rings):
    key = ring_key(_planes())
    other = torch.device("cuda", 1)  # a key only: nothing runs there
    a = lease_ring(DEVICE, key, pin=False)
    b = lease_ring(other, key, pin=False)
    return_ring(DEVICE, a)
    return_ring(other, b)
    assert lease_ring(DEVICE, key, pin=False) is a
    assert lease_ring(other, key, pin=False) is b


def test_leases_from_many_threads_keep_one_ring(rings):
    """Stages that take and give back the device's ring from several
    threads at once: each holds a ring no other holds, and one is kept."""
    key = ring_key(_planes())
    held, errors = set(), []
    lock = threading.Lock()

    def stage():
        try:
            for _ in range(50):
                ring = lease_ring(DEVICE, key, pin=False)
                with lock:
                    assert id(ring) not in held
                    held.add(id(ring))
                with lock:
                    held.discard(id(ring))
                return_ring(DEVICE, ring)
        except AssertionError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=stage) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and list(rings) == [DEVICE]


@pytest.mark.parametrize("staged,allocs,waits,shown", [
    (0, 0, 0, None),
    (5, RING_DEPTH, 1, f"pinned ring: 5 staged, {RING_DEPTH} slots "
                       "allocated, 1 waits"),
    (4, 0, 0, "pinned ring: 4 staged, 0 slots allocated, 0 waits")])
def test_ring_counters_in_the_summary(staged, allocs, waits, shown):
    stats = StageStats(frames_in=8, frames_out=8, wall_s=1.0, batches=4,
                       ring_staged=staged, ring_allocs=allocs,
                       ring_waits=waits)
    line = stats.summary()
    if shown is None:
        assert "pinned ring" not in line
    else:
        assert line.endswith("; " + shown)


@pytest.mark.parametrize("planes", [_planes()[:2], _planes(np.uint16),
                                    _planes()[:1] * 3])
def test_a_fill_of_other_planes_is_refused(planes):
    ring = _ring()
    slot, _ = ring.take()
    with pytest.raises(ValueError):
        ring.fill(slot, planes)


_CTYPES = {"const char*": ctypes.c_void_p, "char*": ctypes.c_void_p,
           "int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32}


def test_host_copy_mirror_matches_the_c_struct():
    src = (_build.CSRC / "hostcopy.cu").read_text()
    (cap,) = re.findall(r"#define HOST_COPY_MAX_PLANES (\d+)", src)
    assert int(cap) == executor._HOST_COPY_MAX_PLANES
    body = re.search(r"struct HostCopyParams \{(.*?)\n\};", src,
                     re.S).group(1)
    want = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            m = re.fullmatch(r"(.+?)\s*(\w+)(\[HOST_COPY_MAX_PLANES\])?;",
                             line)
            kind = _CTYPES[m.group(1).replace(" *", "*")]
            want.append((m.group(2), kind * int(cap) if m.group(3)
                         else kind))
    assert executor._HostCopyParams._fields_ == want


def test_host_copy_is_in_the_render_library():
    assert "hostcopy.cu" in _build.SOURCES
    assert "host_copy" in _build.ENTRY_POINTS
