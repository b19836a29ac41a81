"""The port's spans, and a Chrome-trace exporter.

Counterpart of ``spmv_tpu.utils.profiling``. LIBSPMV brackets its solver
region with MPI_Pcontrol so that external profilers capture only the
solve; the reference wraps ``jax.profiler``. Here ``profile_region(name)``
marks one layer's part of a request (a CG solve, one of its iterations, a
blocking host read, an operator apply). While no torch profiler records,
it returns one shared no-op context and costs a flag read. While one
records, the span is a profiler RecordFunction (torch's
``_RecordFunctionFast``, the C++ form of ``torch.profiler.record_function``
at a fraction of its cost, with the request id among its keyword
values, which a profiler with ``record_shapes`` writes to the trace), so
it sits in the profiler's trace beside the device operations its launches
issued, on the profiler's clock; and a span that ends with the profiler still
recording is appended to ``record`` as a ``Span``, stamped with
``time.time_ns()`` (the clock of the trace's ``ts`` plus its
``baseTimeNanoseconds``). The record stays in memory: whoever reads it
clears it. ``profile_to`` captures a region and writes it as a Chrome
trace (open it in chrome://tracing or Perfetto).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: str | None  # the enclosing span's name
    request: int        # the outermost enclosing span's id, shared by its spans


record: list[Span] = []
_requests = itertools.count()
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _Region:
    __slots__ = ("name", "parent", "request", "start_ns", "_fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1].name, stack[-1].request
        else:
            self.parent, self.request = None, next(_requests)
        self.start_ns = time.time_ns()
        self._fn = _RecordFunctionFast(self.name, (), {"request": self.request})
        self._fn.__enter__()
        stack.append(self)

    def __exit__(self, *exc):
        self._fn.__exit__(*exc)
        end_ns = time.time_ns()
        _stack().pop()
        if _autograd_profiler._is_profiler_enabled:
            record.append(Span(self.name, self.start_ns, end_ns, self.parent,
                               self.request))


def profile_region(name: str):
    """The span ``name`` around the enclosed region: a shared no-op unless
    a torch profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Region(name)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture the enclosed region (CPU activity, and the card's where CUDA
    is available) and write it to ``logdir/trace.json`` as a Chrome trace
    when the region ends. Yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
