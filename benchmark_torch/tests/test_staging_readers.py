"""The readers of the staging thread's spans on synthetic span records:
``stage_ready_pct``, the share of the window's staged batches that were
ready, with a span the window clips and the end of a call's batches (no
``ready``); ``pin_ms``, the mean ``executor.pin`` span of the window on
any thread; and None for each where there is nothing to read."""

from __future__ import annotations

import pytest

from benchmark_torch import spec

from .test_span_readers import fake_run, rec


def read(run, name="stage_ready_pct"):
    return spec.metric_reader(name)(run)


def test_the_share_of_batches_found_staged(monkeypatch):
    records = [
        rec("executor.run", 99.9, 101.2, 1),
        # started before the window: not the window's
        rec("executor.stage", 99.95, 100.01, 2, 1, batch=0, ready=False),
        rec("executor.stage", 100.1, 100.2, 3, 1, batch=1, ready=True),
        rec("executor.stage", 100.3, 100.4, 4, 1, batch=2, ready=True),
        rec("executor.stage", 100.5, 100.6, 5, 1, batch=3, ready=False),
        rec("executor.stage", 100.7, 100.8, 6, 1, batch=4, ready=True),
        # the call's end: no batch, no ready
        rec("executor.stage", 100.85, 100.9, 7, 1, batch=5),
        # started after the close: not the window's
        rec("executor.stage", 101.05, 101.1, 8, 1, batch=6, ready=False),
    ]
    run = fake_run(monkeypatch, records)
    assert read(run) == pytest.approx(75.0)


def test_none_without_a_staged_batch(monkeypatch):
    # no spans at all, and a loop that stages no batch ahead (as before
    # the staging thread: stage spans without ready)
    assert read(fake_run(monkeypatch, [])) is None
    serial = [rec("executor.run", 100.1, 100.9, 1),
              rec("executor.stage", 100.2, 100.3, 2, 1, batch=0)]
    assert read(fake_run(monkeypatch, serial)) is None
    # RECORDS: the harness's synthetic loop, before the staging thread
    assert read(fake_run(monkeypatch)) is None


def test_pin_ms_is_the_mean_copy_of_the_window_on_the_staging_thread(
        monkeypatch):
    records = [
        rec("executor.run", 99.9, 101.2, 1),
        # started before the window: not the window's
        rec("executor.pin", 99.95, 100.05, 2, 1, thread=8, batch=0),
        rec("executor.pin", 100.1, 100.104, 3, 1, thread=8, batch=1),
        rec("executor.stage", 100.104, 100.105, 4, 1, batch=1, ready=True),
        rec("executor.pin", 100.2, 100.206, 5, 1, thread=8, batch=2),
        # started after the close: not the window's
        rec("executor.pin", 101.05, 101.1, 6, 1, thread=8, batch=3),
    ]
    assert read(fake_run(monkeypatch, records), "pin_ms") == \
        pytest.approx(5.0)


def test_pin_ms_none_where_the_loop_stages_itself(monkeypatch):
    # no spans, and the loop before the staging thread (no executor.pin)
    assert read(fake_run(monkeypatch, []), "pin_ms") is None
    assert read(fake_run(monkeypatch), "pin_ms") is None
