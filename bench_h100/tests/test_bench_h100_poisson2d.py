"""The cell poisson2d_4480.matvec: its generator against the benchmark's
copy of the plain reference (``reference/poisson2d.py``), and the cell run
whole on the CPU at a mesh the CPU holds, traced and untraced."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_h100 import harness
from bench_h100.matrices import poisson2d_p1
from bench_h100.reference import poisson2d

CELL = "poisson2d_4480.matvec"
CONFIG = "poisson2d_p1_4480x2240_sym_f64.json"


@pytest.mark.parametrize("cx,cy", [(8, 4), (16, 8)])
def test_generator_equals_the_reference_copy(cx, cy):
    a = poisson2d_p1.generate({"cx": cx, "cy": cy})
    for got, want in zip((a.rowptr, a.colind, a.values), poisson2d.assemble(cx, cy)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def small_root(tiny_root):
    path = tiny_root / "bench_h100" / "configs" / CONFIG
    cfg = json.loads(path.read_text())
    cfg["matrix"].update(cx=96, cy=48)
    path.write_text(json.dumps(cfg))
    return tiny_root


def test_the_cell_runs_whole_on_the_cpu(small_root):
    cpu = torch.device("cpu")
    out = harness.run_cell(small_root, CELL, 2**33 + 3, 0.3, False, cpu, 0.0)
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "matvec_ms"}
    out = harness.run_cell(small_root, CELL, 2**33 + 4, 0.3, True, cpu, 0.0)
    # no device time on the CPU: the byte record and the host clock alone
    assert out["correct"]
    assert set(out["metrics"]) == {"assemble_s.poisson2d", "layout_share"}
    assert 0 < out["metrics"]["layout_share"]["value"] <= 100
