"""The reader of ``cg_fused_share``: the program's count of iterations by
CG loop, as a share, and None without the count or without device time."""
from __future__ import annotations

from pathlib import Path

import pytest

from bench_h100 import harness
from bench_h100.trace import TraceSummary
from spmv_torch.solvers import cg

ROOT = Path(__file__).resolve().parents[2]


def _run(busy_s: float) -> harness.Run:
    trace = TraceSummary(window_s=1e-3, busy_s=busy_s, spans={}, starts={},
                         device_s={}, unlinked=0, device_ops=[], idle_gaps=[])
    return harness.Run(counters={}, host={}, trace=trace, roofline_s=1e-4)


def _read(run):
    return harness.load_module(ROOT, "metrics", "cg_fused_share").read(run)


@pytest.mark.parametrize("fused,plain,share", [(300, 0, 100.0), (300, 100, 75.0),
                                               (0, 40, 0.0)])
def test_share_of_fused_iterations(monkeypatch, fused, plain, share):
    monkeypatch.setattr(cg, "iterations", {"fused": fused, "plain": plain})
    assert _read(_run(5e-4)) == pytest.approx(share)


def test_none_without_the_counter(monkeypatch):
    # the program before the fused loop keeps no count
    monkeypatch.delattr(cg, "iterations")
    assert _read(_run(5e-4)) is None


@pytest.mark.parametrize("busy_s", [None, 0.0])
def test_none_without_device_time_or_iterations(monkeypatch, busy_s):
    monkeypatch.setattr(cg, "iterations", {"fused": 0, "plain": 12})
    run = _run(5e-4) if busy_s is None else _run(busy_s)
    if busy_s is None:
        run.trace = None
    assert _read(run) is None
    monkeypatch.setattr(cg, "iterations", {"fused": 0, "plain": 0})
    assert _read(_run(5e-4)) is None
