"""What the harness loads is neither JAX nor the JAX package, and the
yardstick (the reference, the generators, the roofline, the trace
reduction) imports nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "spmv_tpu"}
YARDSTICK = ["matrices/lap2d.py", "roofline.py", "trace.py", "inputs.py"]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_harness_imports_jax():
    for path in (ROOT / "bench_h100").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK + [str(p.relative_to(ROOT / "bench_h100"))
                            for p in (ROOT / "bench_h100" / "reference").glob("*.py")]:
        tops = _imports(ROOT / "bench_h100" / rel)
        assert "spmv_torch" not in tops and not tops & FORBIDDEN, rel


def test_a_run_loads_no_forbidden_module(tiny_root):
    # a whole run in a fresh process, then its sys.modules by top-level name
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from bench_h100 import harness, run\n"
        f"out = harness.run_cell({str(tiny_root)!r}, 'lap2d_3200.cg', 5, 0.2, True,"
        " torch.device('cpu'), 0.0)\n"
        "print(json.dumps([out['correct'], run.forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules})]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, found, tops = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and found == [] and not set(tops) & FORBIDDEN
    assert "spmv_torch" in tops


def test_the_reference_alone_loads_no_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import bench_h100.reference.checks, bench_h100.roofline, "
            "bench_h100.trace, bench_h100.matrices.lap2d\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    tops = set(json.loads(res.stdout.strip().replace("'", '"')))
    assert "spmv_torch" not in tops and not tops & FORBIDDEN
