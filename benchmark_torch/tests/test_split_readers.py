"""The readers of the split cell (``uhd8k10_c33.split4``) on synthetic runs:
``peer_mb`` and ``split_call_ms`` from the program's ``sharding.call``
spans, ``card_busy_spread_pct`` and ``peer_copy_ms`` from the device
trace, and ``pin_ms.split4`` and ``kernel_b_roofline_pct.split4`` as the
readers they reuse; None where the run holds nothing to read: a parent
without the spans, one card, no trace."""

from __future__ import annotations

import pytest

from benchmark_torch import harness, roofline, spec

from .test_span_readers import RECORDS, U, fake_run, rec

CELL = "uhd8k10_c33.split4"
PEER = 597_196_800
P2P = "Memcpy PtoP (Device -> Device)"
KERNEL_B = "void (anonymous namespace)::fused420_kernel<1, 1, lutk::LutArgs>"


def read(name, run):
    return spec.metric_reader(name)(run)


def split_run(monkeypatch, records=RECORDS, device=()):
    """A traced run of the split cell: four cards, batch 4, 8K frames, and
    the window's device events `device` as (card, start s, end s, name)."""
    run = fake_run(monkeypatch, records, cell=CELL)
    run.cards, run.batch, run.shape, run.lut_size = [0, 1, 2, 3], 4, \
        (4320, 7680), 33
    run.batches = [harness.BatchRec(None, 4, [0, 1, 2, 3], 100.0 + i / 10)
                   for i in range(5)]
    run.trace.device = [(c, U(s), U(e), n) for c, s, e, n in device]
    return run


def test_the_split_cell_reports_its_six_metrics():
    cell = spec.load_cell(CELL, spec.HERE.parent)
    assert cell.chips == 4 and cell.config_name == "uhd8k_420p10_cube33"
    assert {m.name for m in cell.end_to_end} == {"fps", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        "peer_copy_ms", "card_busy_spread_pct", "peer_mb", "split_call_ms",
        "pin_ms.split4", "kernel_b_roofline_pct.split4"}


def test_peer_mb_and_split_call_ms_from_the_window_calls(monkeypatch):
    records = [
        rec("executor.run", 99.9, 101.2, 1),
        # started before the window: not the window's
        rec("sharding.call", 99.95, 100.05, 2, cards=4, frames=4,
            peer_bytes=1),
        rec("sharding.call", 100.1, 100.102, 3, cards=4, frames=4,
            peer_bytes=PEER),
        rec("sharding.put", 100.1, 100.101, 4, 3),
        rec("sharding.call", 100.3, 100.304, 5, cards=4, frames=4,
            peer_bytes=PEER),
        # started after the close: not the window's
        rec("sharding.call", 101.05, 101.1, 6, cards=4, frames=4,
            peer_bytes=1),
    ]
    run = split_run(monkeypatch, records)
    assert read("peer_mb", run) == pytest.approx(597.1968)
    assert read("split_call_ms", run) == pytest.approx(3.0)


def test_the_busiest_card_less_the_least_busy(monkeypatch):
    device = [(0, 100.0, 100.5, P2P), (0, 100.4, 100.6, KERNEL_B),
              (1, 100.1, 100.2, KERNEL_B), (2, 100.1, 100.3, KERNEL_B),
              (3, 100.5, 100.6, KERNEL_B)]
    run = split_run(monkeypatch, device=device)
    w = run.trace.window_s
    assert read("card_busy_spread_pct", run) == pytest.approx(
        100 * (0.6 - 0.1) / w)
    # the copies between cards, a batch of the window's five
    assert read("peer_copy_ms", run) == pytest.approx(500 / 5)


def test_the_reused_readers_read_as_their_originals(monkeypatch):
    records = [rec("executor.run", 99.9, 101.2, 1),
               rec("executor.pin", 100.1, 100.175, 2, 1, thread=8, batch=0)]
    device = [(c, 100.1 + c / 10, 100.1003 + c / 10, KERNEL_B)
              for c in range(4)]
    run = split_run(monkeypatch, records, device)
    assert read("pin_ms.split4", run) == read("pin_ms", run) == \
        pytest.approx(75.0)
    # each launch covers one 8K 10-bit frame, a card's chunk
    bound, kind = roofline.kernel_b_bound(
        1, 4320, 7680, run.cell.config["pipeline"], 33)
    assert kind == "bytes"
    assert read("kernel_b_roofline_pct.split4", run) == \
        read("kernel_b_roofline_pct", run) == pytest.approx(100 * bound / 0.3)


def test_none_where_there_is_nothing_to_read(monkeypatch):
    names = ("peer_copy_ms", "card_busy_spread_pct", "peer_mb",
             "split_call_ms", "pin_ms.split4", "kernel_b_roofline_pct.split4")
    # a parent without the sharding spans, with no copy between cards:
    # the spans' and the copies' readers find nothing; the busy spread
    # reads a number, 0 where no card is busy
    run = split_run(monkeypatch)
    got = {n: read(n, run) for n in names}
    assert got == {"peer_copy_ms": None, "card_busy_spread_pct": 0.0,
                   "peer_mb": None, "split_call_ms": None,
                   "pin_ms.split4": None,
                   "kernel_b_roofline_pct.split4": None}
    # one card: nothing to spread, no peer
    one = split_run(monkeypatch, device=[(0, 100.0, 100.5, P2P)])
    one.cards = [0]
    assert read("card_busy_spread_pct", one) is None
    assert read("peer_copy_ms", one) is None
    # no trace
    run.trace = None
    for n in ("peer_copy_ms", "card_busy_spread_pct",
              "kernel_b_roofline_pct.split4"):
        assert read(n, run) is None
