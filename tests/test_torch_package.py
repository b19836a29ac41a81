"""spmv_torch package boundary, kernel wrappers and build.

Tests that need a CUDA card carry the ``cuda`` marker; whether there is a
card is decided inside the tests (the ``cuda`` fixture), never at import or
collection time, and they skip with a reason where there is none.
Everything else runs on the CPU: the wrapper's plain path and its input
checks, the build's failure modes, and the package's promise to import
neither jax nor spmv_tpu. On a machine without jax, run this file with
``--noconftest`` (``tests/conftest.py`` imports jax).
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_torch import _build
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.gen import create_laplace_2d
from spmv_torch.ops import spmv_dia_cuda
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "spmv_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_package.py -m cuda "
                    "--noconftest)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counters():
    spmv_dia_cuda.reset_launches()
    yield
    spmv_dia_cuda.reset_launches()


def _env_with_repo():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "spmv_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'spmv_tpu')))\n"
        "assert not bad, bad\n"
    )
    assert "spmv_torch.parallel.dist_matrix" in modules
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=_env_with_repo(),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_never_import_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "spmv_tpu"), (path, name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetric", [False, True])
def test_wrapper_takes_plain_path_on_cpu(symmetric, dtype):
    a = create_laplace_2d(70, 16)
    d = csr_to_dia(a, dtype=dtype, symmetric=symmetric, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        d.nrows_pad).astype(dtype))
    y = spmv_dia_cuda.spmv_dia(d, x)
    want = spmv_dia_stacked_plain(d.data.unsqueeze(0), x.view(-1, 128),
                                  d.offsets, symmetric).view(-1)
    assert torch.equal(y, want)
    y2 = spmv_dia_cuda.spmv_dia_2d(d, x.view(-1, 128))
    assert torch.equal(y2.view(-1), want)
    assert spmv_dia_cuda.launches == {"dia": 0, "dia_sym": 0}


def _inputs(dtype=torch.float32, k=3, nd=2, nr=4):
    data = torch.zeros((nd, nr, k * 128), dtype=dtype)
    x2 = torch.zeros((nd * nr, 128), dtype=dtype)
    return data, x2, tuple(range(-k + 1, 1))


@pytest.mark.parametrize("case,exc", [
    ("bf16", TypeError),
    ("int", TypeError),
    ("mixed", TypeError),
    ("no_diags", ValueError),
    ("too_many_diags", ValueError),
    ("positive_sym", ValueError),
    ("data_shape", ValueError),
    ("x_shape", ValueError),
    ("noncontiguous", ValueError),
])
def test_wrapper_rejects_bad_input(case, exc):
    data, x2, offs = _inputs()
    sym = True
    if case == "bf16":
        data, x2 = data.bfloat16(), x2.bfloat16()
    elif case == "int":
        data, x2 = data.int(), x2.int()
    elif case == "mixed":
        x2 = x2.double()
    elif case == "no_diags":
        offs = ()
    elif case == "too_many_diags":
        data, x2, offs = _inputs(k=65)
    elif case == "positive_sym":
        offs = (-1, 0, 1)
    elif case == "data_shape":
        data = data[:, :, :256]
    elif case == "x_shape":
        x2 = x2[:-1]
    elif case == "noncontiguous":
        x2 = torch.zeros((128, 8), dtype=data.dtype).t()
    with pytest.raises(exc):
        spmv_dia_cuda.spmv_dia_stacked(data, x2, offs, sym)
    assert spmv_dia_cuda.launches == {"dia": 0, "dia_sym": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="sm_90a refused"):
        _build.build()
    assert not (tmp_path / "lib.so").exists()
    assert list(tmp_path.glob("*.so")) == []


def test_library_path_tracks_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("lib")
    assert p == _build.library_path()
    assert (_build.CSRC / "spmv_dia.cu").exists()


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = _env_with_repo()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the package, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_demo_refuses_missing_cuda_and_unported_flags():
    from spmv_torch.demos import demo_cg

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            demo_cg.main(["--lap2d", "8"])
    for flag in (["--amg"], ["--format", "well"], ["--solver", "gmres"],
                 ["--cpu"], ["--sstep", "4"]):
        with pytest.raises(SystemExit):
            demo_cg.main(["--lap2d", "8", "--device", "cpu", *flag])


def test_profile_cg_refuses_missing_cuda():
    from spmv_torch.demos import profile_cg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        profile_cg.main(["--lap2d", "8"])


@pytest.mark.cuda
def test_profile_cg_reports_device_time(cuda, capsys):
    from spmv_torch.demos import profile_cg

    assert profile_cg.main(["--lap2d", "64", "--iters", "10", "--symmetric"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert any("dia_sym_spmv" in row.get("kernel", "") for row in lines[:-1])
    assert lines[-1]["device_busy_us_per_iter"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_kernels_match_plain_on_cuda(cuda, symmetric, dtype, tol):
    """Stacked shards, odd offsets, random data: kernel vs plain on the card."""
    rng = np.random.default_rng(7)
    offs = (-301, -37, -5, -1, 0) if symmetric else (-301, -37, -1, 0, 1, 37, 301)
    nd, nr = 3, 40
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = torch.as_tensor(rng.standard_normal((nd, nr, len(offs) * 128)).astype(npdt),
                           device=cuda)
    x2 = torch.as_tensor(rng.standard_normal((nd * nr, 128)).astype(npdt), device=cuda)
    y = spmv_dia_cuda.spmv_dia_stacked(data, x2, offs, symmetric)
    torch.cuda.synchronize()
    want = spmv_dia_stacked_plain(data, x2, offs, symmetric)
    err = float(torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want))
    assert err <= tol
    assert spmv_dia_cuda.launches["dia_sym" if symmetric else "dia"] == 1


@pytest.mark.cuda
def test_dist_matrix_runs_through_kernel_on_cuda(cuda):
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(64, 64)
    A = build_dist_matrix(a, n_devices=4, symmetric=True, local_format="dia",
                          device=cuda)
    x = np.random.default_rng(3).standard_normal(a.nrows)
    y = A.from_dist(A.matvec(A.to_dist(x)))
    want = a.matvec(x)
    assert np.linalg.norm(y - want) <= 1e-12 * np.linalg.norm(want)
    assert spmv_dia_cuda.launches == {"dia": 0, "dia_sym": 1}
