"""Profiler integration.

Counterpart of ``spmv_tpu.utils.profiling``. LIBSPMV brackets its solver
region with MPI_Pcontrol so that external profilers capture only the
solve; the reference wraps ``jax.profiler``. Here a named region is a
``torch.profiler.record_function`` (it shows on torch.profiler's timeline)
and, where CUDA is available, an NVTX range as well (it shows in Nsight
Systems); a capture is a ``torch.profiler.profile`` of the enclosed region
written as a Chrome trace (open it in chrome://tracing or Perfetto).
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_region(name: str):
    """Label the enclosed region ``name`` on the profiler's timeline and,
    where CUDA is available, as an NVTX range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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


def annotate(fn, name: str | None = None):
    """Wrap a function so that each call runs inside ``profile_region``
    (labelled ``name``, default the function's name)."""
    label = name or getattr(fn, "__name__", "region")

    def wrapped(*args, **kwargs):
        with profile_region(label):
            return fn(*args, **kwargs)

    return wrapped
