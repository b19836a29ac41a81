"""The HPCG cell's own files: the frozen generator, the V-cycle's byte
count, the readers of its per-layer metrics, and the loop's judge, run on
the CPU through the kernels' plain versions at 8³ (4 levels, down to 1³)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import harness, roofline, roofline_mg
from bench_h100.matrices import hpcg27
from bench_h100.reference import hpcg_mg
from bench_h100.trace import TraceSummary
from spmv_torch.gen import hpcg_27pt

ROOT = Path(__file__).resolve().parents[2]
CELL = "hpcg_256.mgpcg"
CPU = torch.device("cpu")


@pytest.fixture
def hpcg_root(tiny_root) -> Path:
    """The benchmark's copy with the HPCG grid cut to 8³."""
    path = tiny_root / "bench_h100" / "configs" / "hpcg_256_sym_f64.json"
    cfg = json.loads(path.read_text())
    cfg["matrix"].update(nx=8, ny=8, nz=8)
    path.write_text(json.dumps(cfg))
    return tiny_root


def _levels(grid, count=4):
    out = [grid]
    for _ in range(count - 1):
        out.append(tuple(v // 2 for v in out[-1]))
    return [(g, hpcg27.generate(dict(zip(("nx", "ny", "nz"), g)))) for g in out]


@pytest.mark.parametrize("grid", [(16, 16, 16), (5, 4, 3)])
def test_frozen_generator_is_the_programs(grid):
    a, b = hpcg27.generate(dict(zip(("nx", "ny", "nz"), grid))), hpcg_27pt(*grid)
    assert np.array_equal(a.rowptr, b.rowptr) and a.rowptr.dtype == np.int64
    assert np.array_equal(a.colind, b.colind) and a.colind.dtype == np.int32
    assert np.array_equal(a.values, b.values)


def test_cycle_bytes_by_hand():
    levels = _levels((16, 16, 16))
    sweeps = transfers = 0
    for k, (grid, _) in enumerate(levels):
        n = grid[0] * grid[1] * grid[2]
        # nonzeros of the 27-point operator: (3 m - 2) neighbours along each axis
        nnz = int(np.prod([3 * m - 2 for m in grid]))
        lower = (nnz + n) // 2
        last = k + 1 == len(levels)
        sweeps += 2 * lower + 5 * n if last else 4 * lower + 11 * n
        if not last:
            # a coarse point (even coordinates) has 2 neighbours along an
            # axis at 0 and 3 elsewhere
            row_nnz = int(np.prod([2 + 3 * (m // 2 - 1) for m in grid]))
            transfers += row_nnz + n + 3 * (n // 8)
    got = roofline_mg.cycle_bytes(levels, "float64")
    assert got == {"mg_sweep_bytes": 8 * sweeps,
                   "mg_cycle_bytes": 8 * (sweeps + transfers)}
    assert roofline_mg.cycle_bytes(levels, "float32")["mg_sweep_bytes"] == 4 * sweeps


def _run(trace, counters=None):
    return harness.Run(counters or {"mg_cycle_bytes": 3.35e9, "mg_sweep_bytes": 1.675e9},
                       {}, trace, 0.0)


def _summary(busy=0.0, precond_s=0.0, cycles=0, ops=()):
    return TraceSummary(window_s=1.0, busy_s=busy, spans={"matvec": 0, "precond": cycles},
                        starts={"solve": 0}, device_s={"precond": precond_s},
                        unlinked=0, device_ops=[list(o) for o in ops], idle_gaps=[])


READERS = ["mg_us_per_cycle", "mg_roofline", "symgs_roofline", "mg_host_us"]


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_device_time(name):
    reader = harness.load_module(ROOT, "metrics", name)
    assert reader.read(_run(None)) is None
    assert reader.read(_run(_summary())) is None  # a CPU run's slice
    # a slice on the card holding no whole cycle
    assert reader.read(_run(_summary(busy=0.5))) is None


def test_readers_arithmetic():
    root = ROOT
    t = _summary(busy=0.9, precond_s=0.004, cycles=2,
                 ops=[("void (anonymous namespace)::symgs_dia_lines<double, true, false>", 0.002),
                      ("void (anonymous namespace)::symgs_dia_lines<double, false, true>", 0.001),
                      ("mg_restrict", 0.0005)])
    read = {n: harness.load_module(root, "metrics", n).read(_run(t)) for n in READERS[:3]}
    assert read["mg_us_per_cycle"] == pytest.approx(2000.0)
    # 3.35e9 bytes a cycle is 1 ms at the peak; a cycle takes 2 ms
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert read["mg_roofline"] == pytest.approx(50.0)
    assert read["symgs_roofline"] == pytest.approx(100.0 * 0.5 / 1.5)
    assert harness.load_module(root, "metrics", "symgs_roofline").read(
        _run(_summary(busy=0.9, precond_s=0.004, cycles=2))) is None


def test_reference_colour_blocks_cover_the_operator():
    (grid, a), = _levels((6, 5, 4), 1)
    blocks = hpcg_mg.colour_blocks(a, grid)
    assert sorted(np.concatenate([r for r, _, _ in blocks]).tolist()) == list(range(a.nrows))
    for c, (rows, block, diag) in enumerate(blocks):
        assert np.all(hpcg_mg.colours(grid)[rows] == c) and np.all(diag == 26.0)
        for k, row in enumerate(rows):
            lo, hi = a.rowptr[row], a.rowptr[row + 1]
            assert np.array_equal(block.colind[block.rowptr[k]:block.rowptr[k + 1]],
                                  a.colind[lo:hi])
            assert np.array_equal(block.values[block.rowptr[k]:block.rowptr[k + 1]],
                                  a.values[lo:hi])


def test_sound_run_is_correct_and_judged_by_the_reference(hpcg_root, monkeypatch):
    calls = []
    orig = hpcg_mg.solution_errors

    def spy(*args, **kw):
        calls.append(len(args[3]))
        return orig(*args, **kw)

    monkeypatch.setattr(hpcg_mg, "solution_errors", spy)
    out = harness.run_cell(hpcg_root, CELL, 2**31 + 21, 0.2, False, CPU, 0.0)
    assert out["correct"] and out["failed"] == 0 and calls == [out["attempted"]]
    assert set(out["metrics"]) == {"setup_s", "solve_s"}
    assert out["counters"]["cg_iterations"] == 50.0
    assert out["counters"]["mg_residual_reduction"] < 1e-12
    out = harness.run_cell(hpcg_root, CELL, 5, 0.2, True, CPU, 0.0)
    # nothing ran on a device: every reader finds nothing to read
    assert out["correct"] and out["metrics"] == {}


def test_altered_answer_is_caught(hpcg_root, monkeypatch):
    from spmv_torch.solvers import cg as cg_module

    orig = cg_module.cg

    def cg(*a, **kw):
        res = orig(*a, **kw)
        res.x.view(-1)[0] += 1e-6 * res.x.abs().max()
        return res

    monkeypatch.setattr(cg_module, "cg", cg)
    assert not harness.run_cell(hpcg_root, CELL, 3, 0.2, False, CPU, 0.0)["correct"]


def test_parent_without_the_multigrid_fails_as_the_method_loads(hpcg_root, monkeypatch):
    import sys

    import spmv_torch.solvers

    # the parent's program: no such module
    monkeypatch.delattr(spmv_torch.solvers, "gmg", raising=False)
    monkeypatch.setitem(sys.modules, "spmv_torch.solvers.gmg", None)
    with pytest.raises(ImportError):
        harness.run_cell(hpcg_root, CELL, 3, 0.2, False, CPU, 0.0)
