"""Every committed cell, at the CPU copy's size, through the harness on the
card: a traced and an untraced run, with the CUDA kernels. Skips without a
card; on the card run ``python -m pytest bench_h100/tests -m cuda``."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the card run "
                    "`python -m pytest bench_h100/tests -m cuda`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(tiny_root, card, cell):
    spec = harness.read_spec(tiny_root, cell)
    out = harness.run_cell(tiny_root, cell, 2**31 + 1, 0.5, False, card, 0.0)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    out = harness.run_cell(tiny_root, cell, 2**31 + 2, 0.5, True, card, 0.0)
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in spec.per_layer}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
