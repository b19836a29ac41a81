"""The traced slice of a ``--trace 1`` run and its reduction.

``Tracer`` wraps the calls into the program in named spans
(``torch.profiler.record_function``) and profiles a bounded steady slice of
the window: from the ``skip``-th counted call to the ``skip + count``-th,
between two synchronizes, inside a ``bench.slice`` span. ``summarize``
reduces the profiler's Chrome trace: every device operation is tied to the
host launch that issued it (by its correlation id) and so to the span the
launch ran in; the device's busy time is the union of the device
operations' intervals over the slice.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float            # wall time of the slice
    busy_s: float              # union of device operations over the slice
    spans: dict                # span name -> count started in the slice
    starts: dict               # counted-only span name -> count started
    device_s: dict             # span a launch ran in (or "other") -> device s
    unlinked: int              # device operations with no launch found
    device_ops: list           # [[name, s]], the most device time first
    idle_gaps: list            # [[host op active in the gap, s]], longest first


def summarize(events: list[dict], span_names=("matvec", "precond"),
              counted=("solve",)) -> TraceSummary:
    """Reduce Chrome-trace events (``traceEvents``) of one traced slice.
    Device time is split by the ``span_names`` its launch ran in; spans
    named in ``counted`` are only counted."""
    sl = [e for e in events
          if e.get("cat") == "user_annotation" and e.get("name") == SLICE]
    if len(sl) != 1:
        raise ValueError(f"expected one {SLICE} span, found {len(sl)}")
    s0 = float(sl[0]["ts"])
    s1 = s0 + float(sl[0]["dur"])
    tid = sl[0].get("tid")

    spans = {name: [] for name in span_names}
    begun = dict.fromkeys(counted, 0)
    launch_ts = {}
    host = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in HOST_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = ts
        if cat == "user_annotation" and s0 <= ts <= s1:
            if e.get("name") in spans:
                spans[e["name"]].append((ts, ts + dur))
            elif e.get("name") in begun:
                begun[e["name"]] += 1
        if e.get("tid") == tid and s0 <= ts <= s1:
            host.append((ts, ts + dur, e.get("name", "?")))
    for v in spans.values():
        v.sort()

    device_s = defaultdict(float)
    by_name = defaultdict(float)
    intervals = []
    unlinked = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < s0 or ts > s1:
            continue
        intervals.append((max(ts, s0), min(ts + dur, s1)))
        by_name[e.get("name", "?")] += dur * 1e-6
        lt = launch_ts.get(e.get("args", {}).get("correlation"))
        if lt is None:
            unlinked += 1
            continue
        device_s[_span_of(lt, spans)] += dur * 1e-6

    busy = _union(intervals)
    gaps = _gaps(busy, s0, s1)
    gap_s = defaultdict(float)
    segs = _innermost(host)
    starts = [s[0] for s in segs]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = segs[i][2] if i >= 0 and segs[i][1] > mid else "(no host op)"
        gap_s["(python between ops)" if name == SLICE else name] += (g1 - g0) * 1e-6
    return TraceSummary(
        window_s=(s1 - s0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        spans={k: len(v) for k, v in spans.items()},
        starts=begun,
        device_s=dict(device_s),
        unlinked=unlinked,
        device_ops=_top(by_name),
        idle_gaps=_top(gap_s),
    )


def idle_percent(t: TraceSummary | None) -> float | None:
    """1 - busy / wall over the slice, in percent."""
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def outside_us_per_iteration(t: TraceSummary | None) -> float | None:
    """Device us an iteration of the operations launched outside the
    ``matvec`` and ``precond`` spans. A solve makes one apply an iteration
    and one to start, so the slice's iterations are its ``matvec`` spans
    less the ``solve`` spans begun in it."""
    if t is None or t.busy_s <= 0 or t.unlinked or not t.starts.get("solve"):
        return None
    iterations = t.spans.get("matvec", 0) - t.starts["solve"]
    if iterations <= 0:
        return None
    return 1e6 * t.device_s.get("other", 0.0) / iterations


def _span_of(t: float, spans: dict) -> str:
    for name, iv in spans.items():
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        if i >= 0 and iv[i][0] <= t <= iv[i][1]:
            return name
    return "other"


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _gaps(busy: list, s0: float, s1: float) -> list:
    out, cursor = [], s0
    for a, b in busy:
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if s1 > cursor:
        out.append((cursor, s1))
    return out


def _innermost(events: list) -> list:
    """Nested host events -> disjoint (start, end, innermost name)."""
    segs, stack, cursor = [], [], None

    def emit(until):
        nonlocal cursor
        if stack and cursor is not None and until > cursor:
            segs.append((cursor, until, stack[-1][2]))
        if cursor is None or until > cursor:
            cursor = until

    for s, e, name in sorted(events, key=lambda ev: (ev[0], -ev[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((s, e, name))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return segs


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


class Tracer:
    """Span wrappers for the calls into the program, and the profiler over
    the slice of counted calls [skip, skip + count)."""

    def __init__(self, skip: int, count: int, device):
        self.skip, self.count, self.device = int(skip), int(count), device
        self.calls = 0
        self._prof = self._span = None

    def wrap(self, name: str, fn, counted: bool = False):
        import torch

        def wrapped(v):
            if counted:
                self._tick()
            with torch.profiler.record_function(name):
                return fn(v)

        return wrapped

    def _tick(self) -> None:
        if self.calls == self.skip and self._prof is None:
            self._start()
        elif self.calls == self.skip + self.count:
            self.close()
        self.calls += 1

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()

    def close(self) -> None:
        """End the slice if it is open (the window closed inside it)."""
        if self._span is None:
            return
        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self._span = None

    def summarize(self) -> TraceSummary | None:
        """The slice's summary, or None where no slice was traced."""
        if self._prof is None:
            return None
        self.close()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        return summarize(events)
