"""spmv_torch's timing and profiling utilities (mirrors of
``tests/test_utils.py`` where the reference has them): the phase timer's
report equals the reference's; the port's spans are one shared no-op
without a profiler, and under one sit on the profiler's timeline and in
the in-memory record, nested, on the trace's clock; ``cg`` and
``DistMatrix.matvec`` record theirs without changing a bit of the solve;
the assembly and library-load timers fill; ``profile_to`` writes a Chrome
trace holding the spans.
"""
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from spmv_tpu.utils.timing import PhaseTimer as RefPhaseTimer

from spmv_torch import _build
from spmv_torch.gen import create_laplace_2d
from spmv_torch.parallel import dist_matrix
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg
from spmv_torch.utils import profiling
from spmv_torch.utils.profiling import profile_region, profile_to
from spmv_torch.utils.timing import PhaseTimer, device_sync

CPU = [torch.profiler.ProfilerActivity.CPU]
CG, ITERATION, SYNC, APPLY = ("spmv_torch.cg", "spmv_torch.cg.iteration",
                              "spmv_torch.cg.sync", "spmv_torch.apply")


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.record.clear()
    yield
    profiling.record.clear()


def _laplacian_system(n=64):
    A = build_dist_matrix(create_laplace_2d(n, n), local_format="dia",
                          device="cpu")
    b = A.to_dist(np.random.default_rng(3).uniform(-1, 1, n * n))
    return A, b


def _names(spans):
    return [s.name for s in spans]


def test_phase_timer_report_equals_reference():
    t, r = PhaseTimer(), RefPhaseTimer()
    for timer in (t, r):
        timer.add("0.MatCreate", 0.25)
        timer.add("1.VecCreate", 0.5)
        timer.add("0.MatCreate", 0.25)
    assert t.report() == r.report() and "Total" in t.report()
    assert abs(t.acc["0.MatCreate"] - 0.5) < 1e-12


def test_device_sync_on_cpu_returns():
    assert device_sync(torch.arange(16.0)) is None


def test_profile_region_is_a_shared_no_op_without_a_profiler():
    off = profile_region("spmv_torch.a")
    assert off is profile_region("spmv_torch.b")
    with off as got:
        y = torch.ones(8, 8).sum()
    assert got is None and float(y) == 64.0
    A, b = _laplacian_system(32)
    cg(A.matvec, b, kmax=5, rtol=0.0)
    assert profiling.record == []


def test_regions_show_on_the_profiler_timeline():
    with torch.profiler.profile(activities=CPU) as prof:
        with profile_region("outer_region"):
            with profile_region("matmul_region"):
                torch.ones(16, 16) @ torch.ones(16, 16)
    names = {e.key for e in prof.key_averages()}
    assert {"outer_region", "matmul_region"} <= names
    inner, outer = profiling.record
    assert (inner.name, inner.parent) == ("matmul_region", "outer_region")
    assert (outer.name, outer.parent) == ("outer_region", None)
    assert inner.request == outer.request
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _profiled_cg(kmax=20):
    A, b = _laplacian_system()
    with torch.profiler.profile(activities=CPU) as prof:
        res = cg(A.matvec, b, kmax=kmax, rtol=0.0)
    return res, prof


def test_cg_records_one_span_a_solve_iteration_sync_and_apply():
    res, _ = _profiled_cg()
    assert res.iterations == 20
    names = _names(profiling.record)
    # 20 loop checks read before the kmax stop, one read of `converged`;
    # one apply to start and one an iteration
    assert {n: names.count(n) for n in set(names)} == {
        CG: 1, ITERATION: 20, SYNC: 21, APPLY: 21}


def test_cg_spans_nest_under_one_request():
    _profiled_cg()
    spans = profiling.record
    assert len({s.request for s in spans}) == 1
    solve = next(s for s in spans if s.name == CG)
    assert solve.parent is None
    iterations = [s for s in spans if s.name == ITERATION]
    assert all(s.parent == CG for s in iterations)
    # the first check and apply precede the loop, the last read ends it
    for name in (SYNC, APPLY):
        parents = [s.parent for s in spans if s.name == name]
        assert parents.count(CG) == 1 + (name == SYNC)
        assert parents.count(ITERATION) == 21 - 1 - (name == SYNC)
    for it in iterations:
        inside = [s for s in spans if it.start_ns <= s.start_ns
                  and s.end_ns <= it.end_ns and s is not it]
        assert all(s.parent == ITERATION for s in inside)
        assert sorted(_names(inside)) in ([APPLY, SYNC], [APPLY])
    for s in spans:
        assert solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns


def test_cg_gives_the_same_bits_under_the_profiler():
    A, b = _laplacian_system()
    plain = cg(A.matvec, b, kmax=30, rtol=1e-6)
    with torch.profiler.profile(activities=CPU):
        traced = cg(A.matvec, b, kmax=30, rtol=1e-6)
    assert traced.iterations == plain.iterations
    assert traced.converged == plain.converged
    assert torch.equal(traced.x, plain.x) and torch.equal(traced.r, plain.r)
    assert _names(profiling.record).count(ITERATION) == plain.iterations


def test_spans_lie_on_the_trace_clock(tmp_path):
    _, prof = _profiled_cg(kmax=5)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    events = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                     and e.get("name", "").startswith("spmv_torch.")),
                    key=lambda e: (e["name"], e["ts"]))
    spans = sorted(profiling.record, key=lambda s: (s.name, s.start_ns))
    assert [e["name"] for e in events] == _names(spans)
    slack = 50_000  # ns
    for e, s in zip(events, spans):
        start = base + round(float(e["ts"]) * 1e3)
        end = start + round(float(e["dur"]) * 1e3)
        assert s.start_ns - slack <= start <= end <= s.end_ns + slack, s.name


def test_spans_cut_by_the_profiler_edges_keep_their_nesting():
    prof = torch.profiler.profile(activities=CPU)
    with profile_region("spmv_torch.begun_before"):  # no profiler: no span
        prof.start()
        with profile_region("spmv_torch.inside"):
            pass
        with profile_region("spmv_torch.ended_after"):
            prof.stop()
    inside, = profiling.record
    # the no-op span is nobody's parent: the inner one starts a request
    assert inside.name == "spmv_torch.inside" and inside.parent is None
    with profile_region("spmv_torch.after"):
        pass
    assert profiling.record == [inside]


def test_standalone_applies_are_requests_of_their_own():
    A, b = _laplacian_system(32)
    with torch.profiler.profile(activities=CPU):
        y0 = A.matvec(b)
        y1 = A.matvec(b)
    first, second = profiling.record
    assert first.name == second.name == APPLY
    assert first.parent is None and second.parent is None
    assert first.request != second.request
    assert first.end_ns <= second.start_ns
    assert torch.equal(y0, y1) and torch.equal(y0, A.matvec(b))


def test_spans_of_each_thread_nest_apart():
    barrier = threading.Barrier(2)

    def work(tag):
        with profile_region(f"spmv_torch.{tag}"):
            barrier.wait(timeout=30)
            with profile_region(f"spmv_torch.{tag}.inner"):
                barrier.wait(timeout=30)

    with torch.profiler.profile(activities=CPU):
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in profiling.record}
    assert len(by_name) == 4
    for tag in "ab":
        outer, inner = by_name[f"spmv_torch.{tag}"], by_name[f"spmv_torch.{tag}.inner"]
        assert outer.parent is None and inner.parent == outer.name
        assert inner.request == outer.request
    assert by_name["spmv_torch.a"].request != by_name["spmv_torch.b"].request


def test_build_seconds_fill_by_phase():
    before = dict(dist_matrix.build_seconds)
    build_dist_matrix(create_laplace_2d(48, 48), symmetric=True,
                      local_format="dia", device="cpu")
    after = dist_matrix.build_seconds
    assert set(after) == {"partition", "pack", "upload"}
    assert all(after[k] > before[k] for k in after)


def test_library_load_is_timed_once(monkeypatch):
    class FakeLibrary:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def slow_build():
        time.sleep(0.02)
        return "libfake.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLibrary)
    monkeypatch.setitem(_build.library, "load_s", 0.0)
    lib = _build.load_library()
    first = _build.library["load_s"]
    assert lib.path == "libfake.so" and 0.02 <= first < 5
    assert _build.load_library() is lib and _build.library["load_s"] == first


def test_profile_to_writes_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profile_to(logdir) as d:
        assert d == logdir
        with profile_region("inside"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "inside" for e in events)
