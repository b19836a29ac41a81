"""spmv_torch's timing and profiling utilities vs the spmv_tpu reference
(mirrors of ``tests/test_utils.py``): the phase timer's report equals the
reference's, ``spmv_traffic_bytes`` gives the reference's count, named
regions show on torch.profiler's timeline (and nest), ``annotate`` keeps
the function's result, and ``profile_to`` writes a Chrome trace holding
the regions.
"""
import json
import os

import numpy as np
import pytest
import torch

from spmv_tpu.utils.timing import PhaseTimer as RefPhaseTimer
from spmv_tpu.utils.timing import spmv_traffic_bytes as ref_spmv_traffic_bytes

from spmv_torch.gen import create_laplace_2d
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.utils.profiling import annotate, profile_region, profile_to
from spmv_torch.utils.timing import PhaseTimer, device_sync, spmv_traffic_bytes


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


@pytest.mark.parametrize("fmt_bytes,n_in,n_out,itemsize", [
    (0, 0, 0, 4), (1 << 20, 1000, 1000, 4), (123456789, 10_240_000, 10_240_000, 8),
    (77, 5, 3, 2)])
def test_spmv_traffic_bytes_equals_reference(fmt_bytes, n_in, n_out, itemsize):
    assert (spmv_traffic_bytes(fmt_bytes, n_in, n_out, itemsize)
            == ref_spmv_traffic_bytes(fmt_bytes, n_in, n_out, itemsize))


def test_spmv_traffic_bytes_of_an_operator():
    """On an assembled operator: its device bytes plus x read and y
    written once."""
    a = create_laplace_2d(64, 64)
    A = build_dist_matrix(a, local_format="dia", device="cpu")
    got = spmv_traffic_bytes(A.format_size_bytes(), A.col_pad, A.row_pad, 8)
    assert got == A.format_size_bytes() + 2 * A.row_pad * 8


def test_profile_region_and_annotate():
    with profile_region("solve"):
        y = torch.ones(8, 8).sum()
    assert float(y) == 64.0
    f = annotate(lambda v: v * 2, "double")
    np.testing.assert_allclose(f(torch.ones(4)).numpy(), 2.0)
    assert annotate(np.sqrt)(4.0) == 2.0


def test_regions_show_on_the_profiler_timeline():
    f = annotate(lambda v: v @ v, "matmul_region")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile_region("outer_region"):
            f(torch.ones(16, 16))
    names = {e.key for e in prof.key_averages()}
    assert {"outer_region", "matmul_region"} <= names


def test_profile_to_writes_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profile_to(logdir) as d:
        assert d == logdir
        with profile_region("inside"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "inside" for e in events)
