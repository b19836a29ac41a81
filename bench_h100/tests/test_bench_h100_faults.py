"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; the control (the program's own
float32 path) fails the committed limits; a sound run passes them. The
harness's look for a card is skipped: these drive the rest of a run on
the CPU through the kernels' plain versions, at a size the CPU holds."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_h100 import calibrate, harness
from spmv_torch.parallel.dist_matrix import DistMatrix
from spmv_torch.solvers import cg as cg_module

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SOLVE_CELLS = ("lap2d_3200.cg",)


def _run(root, cell, seed=2**31 + 5):
    return harness.run_cell(root, cell, seed, 0.2, False, CPU, 0.0)


def _unchanged(orig):  # the solve returns its starting state
    def cg(matvec, b, x0=None, **kw):
        z = torch.zeros_like(b)
        return cg_module.CGResult(x=z, iterations=0, rnorm=z.sum(),
                                  rnorm0=z.sum(), converged=True)
    return cg


def _altered(orig):  # one entry of the answer altered where it is made
    def cg(*a, **kw):
        res = orig(*a, **kw)
        res.x.view(-1)[0] += 1e-2 * res.x.abs().max()
        return res
    return cg


def _short(orig):  # the solve stops one iteration before kmax
    def cg(*a, kmax, **kw):
        return orig(*a, kmax=kmax - 1, **kw)
    return cg


def _half_rows(orig):  # the apply leaves out every second row
    def matvec(self, x):
        y = orig(self, x).clone()
        y.view(-1)[1::2] = 0
        return y
    return matvec


@pytest.mark.parametrize("cell", SOLVE_CELLS + ("lap2d_3200.matvec",))
def test_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered, _short])
def test_solver_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    monkeypatch.setattr(cg_module, "cg", fault(cg_module.cg))
    out = _run(tiny_root, cell)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", SOLVE_CELLS + ("lap2d_3200.matvec",))
def test_apply_leaving_out_half_is_caught(tiny_root, monkeypatch, cell):
    monkeypatch.setattr(DistMatrix, "matvec", _half_rows(DistMatrix.matvec))
    assert not _run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_apply_fault_is_caught(tiny_root, monkeypatch, fault):
    orig = DistMatrix.matvec

    def matvec(self, x):
        if fault == "unchanged":
            return x.clone()
        y = orig(self, x).clone()
        y.view(-1)[0] += 1.0
        return y

    monkeypatch.setattr(DistMatrix, "matvec", matvec)
    assert not _run(tiny_root, "lap2d_3200.matvec")["correct"]


@pytest.mark.parametrize("cell", SOLVE_CELLS + ("lap2d_3200.matvec",))
def test_control_fails_the_limits_and_sound_runs_pass(tiny_root, cell):
    limits = json.loads((ROOT / "bench_h100" / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    for control in (False, True):
        for _, numbers, attempted in calibrate.readings(
                tiny_root, cell, [11, 2**31 + 3, 2**40], 0.1, CPU, control):
            assert attempted > 0
            over = any(max(v) > limits[k] for k, v in numbers.items())
            assert over == control, (control, numbers)


def test_run_without_a_card_prints_no_result(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench_h100" / "run.py"), "--workload",
         "lap2d_3200.cg", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
