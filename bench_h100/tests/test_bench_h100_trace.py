"""The reduction of a traced slice, on a hand-made Chrome trace."""
from __future__ import annotations

import pytest

from bench_h100.trace import SLICE, outside_us_per_iteration, summarize


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_slice_reduction():
    ev = [
        _x("user_annotation", SLICE, 0, 100),
        _x("user_annotation", "solve", 5, 90),
        _x("user_annotation", "matvec", 8, 1),
        _x("user_annotation", "matvec", 10, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        _x("user_annotation", "precond", 30, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 2, corr=2),
        _x("cpu_op", "aten::add", 40, 6),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 2, corr=3),
        _x("cpu_op", "aten::item", 60, 30),
        _x("kernel", "spmv", 15, 20, corr=1, tid=7),
        _x("kernel", "div", 35, 5, corr=2, tid=7),
        _x("kernel", "add", 45, 10, corr=3, tid=7),
        _x("kernel", "lost", 56, 2, corr=99, tid=7),
        _x("kernel", "outside", 150, 10, corr=1, tid=7),
    ]
    s = summarize(ev)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [15, 40] + [45, 55] + [56, 58]
    assert s.busy_s == pytest.approx(37e-6)
    assert s.spans == {"matvec": 2, "precond": 1} and s.starts == {"solve": 1}
    assert s.device_s == pytest.approx({"matvec": 20e-6, "precond": 5e-6,
                                        "other": 10e-6})
    assert s.unlinked == 1
    assert outside_us_per_iteration(s) is None  # an unlinked operation
    assert s.device_ops[0] == ["spmv", pytest.approx(20e-6)]
    gaps = dict(s.idle_gaps)
    # gaps by the host op at their middle: [0, 15] and [55, 56] in no op
    # but the solve's span (Python between ops), [40, 45] in aten::add's
    # launch, [58, 100] in aten::item
    assert gaps["solve"] == pytest.approx(16e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(5e-6)
    assert gaps["aten::item"] == pytest.approx(42e-6)


def test_a_trace_without_its_slice_is_refused():
    with pytest.raises(ValueError):
        summarize([_x("kernel", "k", 0, 1)])


def test_solver_time_is_per_iteration():
    # one solve begun in the slice: its first apply starts it, the other
    # two are iterations, and 6 us ran outside the spans
    ev = [
        _x("user_annotation", SLICE, 0, 100),
        _x("user_annotation", "solve", 5, 90),
        _x("user_annotation", "matvec", 10, 5),
        _x("user_annotation", "matvec", 30, 5),
        _x("user_annotation", "matvec", 50, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=1),
        _x("kernel", "axpy", 62, 6, corr=1, tid=7),
    ]
    assert outside_us_per_iteration(summarize(ev)) == pytest.approx(3.0)
