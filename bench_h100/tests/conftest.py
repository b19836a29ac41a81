"""Fixtures of the harness's tests: a copy of the benchmark at a size the
CPU holds (the configurations' scale cut; widths, limits and traffic as
committed), run through the kernels' plain versions."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"nx": 64, "ny": 64}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of BENCHMARK.json and bench_h100/ with each configuration's
    scale cut to ``TINY``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp_path / "bench_h100" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        for key in TINY.keys() & cfg["matrix"].keys():
            cfg["matrix"][key] = TINY[key]
        path.write_text(json.dumps(cfg))
    return tmp_path
