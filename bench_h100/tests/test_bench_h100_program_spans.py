"""The readers of the port's spans and timers, on a hand-made record: each
gives its number where the traced slice saw device time, and None without
it or without the program's record."""
from __future__ import annotations

from pathlib import Path

import pytest

from bench_h100 import harness
from bench_h100.trace import TraceSummary
from spmv_torch import _build
from spmv_torch.parallel import dist_matrix
from spmv_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
SPAN_READERS = ("cg_host_syncs", "cg_sync_wait_us", "cg_host_us", "apply_host_us")
TIMER_READERS = ("partition_s", "pack_s", "upload_s", "library_load_s")

CG, IT, SYNC, APPLY = ("spmv_torch.cg", "spmv_torch.cg.iteration",
                       "spmv_torch.cg.sync", "spmv_torch.apply")
US = 1000  # ns


def _solve(request: int, t0: int, iterations: int) -> list:
    """One solve's spans as the program records them: an apply (10 µs) and
    a sync (5 µs) to start; iterations of 100 µs, each an apply of 10 µs
    and (all but the last) a sync of 20 µs; the final read (5 µs)."""
    out = [(APPLY, t0, t0 + 10 * US, CG, request),
           (SYNC, t0 + 10 * US, t0 + 15 * US, CG, request)]
    t = t0 + 20 * US
    for k in range(iterations):
        out.append((APPLY, t, t + 10 * US, IT, request))
        if k < iterations - 1:
            out.append((SYNC, t + 70 * US, t + 90 * US, IT, request))
        out.append((IT, t, t + 100 * US, CG, request))
        t += 100 * US
    out.append((SYNC, t, t + 5 * US, CG, request))
    out.append((CG, t0, t + 10 * US, None, request))
    return out


def _record() -> list:
    # a solve cut at the slice's start: its cg span is missing and its
    # iterations start requests of their own; two whole solves of 4
    # iterations; a solve cut at the end (no cg span, its request's own)
    cut_start = [(APPLY, 0, 50 * US, IT, 1), (IT, 0, 300 * US, None, 1)]
    cut_end = [s for s in _solve(9, 10_000 * US, 3) if s[0] != CG]
    return cut_start + _solve(2, 1000 * US, 4) + _solve(3, 2000 * US, 4) + cut_end


def _run(busy_s: float) -> harness.Run:
    trace = TraceSummary(window_s=1e-3, busy_s=busy_s, spans={}, starts={},
                         device_s={}, unlinked=0, device_ops=[], idle_gaps=[])
    return harness.Run(counters={}, host={}, trace=trace, roofline_s=1e-4)


def _read(name: str, run):
    return harness.load_module(ROOT, "metrics", name).read(run)


@pytest.fixture
def record(monkeypatch):
    rec = _record()
    monkeypatch.setattr(profiling, "record", rec)
    return rec


def test_cg_readers_count_whole_solves_only(record):
    run = _run(5e-4)
    # whole solves: 8 iterations, 2 x (2 + 3) = 10 syncs
    assert _read("cg_host_syncs", run) == pytest.approx(10 / 8)
    # syncs: 2 x (5 + 3 x 20 + 5) µs over 8 iterations
    assert _read("cg_sync_wait_us", run) == pytest.approx(140 / 8)
    # iterations: 800 µs, less 8 applies of 10 and 6 syncs of 20
    assert _read("cg_host_us", run) == pytest.approx((800 - 80 - 120) / 8)


def test_apply_reader_takes_every_apply(record):
    applies = [s for s in record if s[0] == APPLY]
    assert len(applies) == 1 + 2 * 5 + 4
    assert _read("apply_host_us", _run(5e-4)) == pytest.approx(
        (50 + 14 * 10) / 15)


def test_timer_readers_read_the_program_tables(monkeypatch):
    monkeypatch.setattr(dist_matrix, "build_seconds",
                        {"partition": 1.5, "pack": 6.25, "upload": 0.5})
    monkeypatch.setattr(_build, "library", {"load_s": 2.75})
    run = _run(5e-4)
    got = {name: _read(name, run) for name in TIMER_READERS}
    assert got == {"partition_s": 1.5, "pack_s": 6.25, "upload_s": 0.5,
                   "library_load_s": 2.75}


@pytest.mark.parametrize("name", SPAN_READERS + TIMER_READERS)
def test_readers_give_none_without_device_time(record, name):
    assert _read(name, _run(0.0)) is None
    run = _run(5e-4)
    run.trace = None
    assert _read(name, run) is None


@pytest.mark.parametrize("name", SPAN_READERS + TIMER_READERS)
def test_readers_give_none_where_the_program_keeps_nothing(monkeypatch, name):
    # a program version before the record and the timers
    monkeypatch.delattr(profiling, "record")
    monkeypatch.delattr(dist_matrix, "build_seconds")
    monkeypatch.delattr(_build, "library")
    assert _read(name, _run(5e-4)) is None


def test_span_readers_give_none_on_an_empty_record(monkeypatch):
    monkeypatch.setattr(profiling, "record", [])
    for name in SPAN_READERS:
        assert _read(name, _run(5e-4)) is None
