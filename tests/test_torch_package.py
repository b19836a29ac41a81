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
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_torch import _build
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.gen import create_laplace_2d
from spmv_torch.ops import (
    spmm_dia_cuda,
    spmm_well_cuda,
    spmv_dia_cuda,
    spmv_dia_ds_cuda,
    spmv_well_cuda,
    spmv_well_ds_cuda,
)
from spmv_torch.ops.spmm_dia import columns, spmm_dia_stacked_plain
from spmv_torch.ops.spmm_well import (
    spmm_well_ds_stacked_plain,
    spmm_well_stacked_plain,
)
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.ops.spmv_dia_ds import (
    spmm_dia_ds_stacked_plain,
    spmv_dia_ds_stacked_plain,
)
from spmv_torch.formats.well import csr_to_well
from spmv_torch.ops.spmv_well import spmv_well_rows_plain
from spmv_torch.ops.spmv_well_ds import (
    csr_to_well_ds,
    spmv_well_ds_rows_plain,
    spmv_well_ds_stacked_plain,
)

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
    _build.launches.clear()
    yield
    _build.launches.clear()


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
    assert _build.launches["dia"] == _build.launches["dia_sym"] == 0


def _inputs(dtype=torch.float32, k=3, nd=2, nr=4):
    data = torch.zeros((nd, nr, k * 128), dtype=dtype)
    x2 = torch.zeros((nd * nr, 128), dtype=dtype)
    return data, x2, tuple(range(-k + 1, 1))


@pytest.mark.parametrize("case,exc", [
    ("f16", TypeError),
    ("int", TypeError),
    ("mixed", TypeError),
    ("no_diags", ValueError),
    ("diags_vs_width", ValueError),
    ("positive_sym", ValueError),
    ("data_shape", ValueError),
    ("x_shape", ValueError),
    ("noncontiguous", ValueError),
])
def test_wrapper_rejects_bad_input(case, exc):
    data, x2, offs = _inputs()
    sym = True
    if case == "f16":
        data, x2 = data.half(), x2.half()
    elif case == "int":
        data, x2 = data.int(), x2.int()
    elif case == "mixed":
        x2 = x2.double()
    elif case == "no_diags":
        offs = ()
    elif case == "diags_vs_width":
        # 65 offsets for data 64 diagonals wide (any K is taken when they agree)
        data, x2, offs = _inputs(k=65)
        data = data[:, :, :64 * 128].contiguous()
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
    assert _build.launches["dia"] == _build.launches["dia_sym"] == 0


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
    for src in ("spmv_dia.cu", "spmv_well.cu", "spmv_dia_ds.cu",
                "spmv_well_ds.cu", "ds.cuh", "spmm_dia.cu", "spmm_dia_ds.cu",
                "spmm_well.cu"):
        assert (_build.CSRC / src).exists()


def test_library_path_tracks_headers(monkeypatch, tmp_path):
    """An edit to a header the kernels include gives a new library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    (csrc / "ds.cuh").write_text((csrc / "ds.cuh").read_text() + "\n")
    assert _build.library_path() != before


class _FakeLibrary:
    """A kernel library whose every entry records its arguments and returns
    ``rc``."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_passes_the_stream_last_and_counts_only_success(monkeypatch, rc):
    """``_build.launch`` calls the entry on the device's current stream,
    passed last; a zero code counts ``count`` under ``key``, any other
    raises with the entry's name and counts nothing."""
    lib, entered = _FakeLibrary(rc), []

    def device(d):
        entered.append(d)
        return contextlib.nullcontext()

    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0xBEEF))
    dev = torch.device("cuda", 1)
    if rc:
        with pytest.raises(RuntimeError,
                           match="^symgs_dia_f64 launch failed: CUDA error 700$"):
            _build.launch("symgs_dia_f64", dev, 11, None, 13, key=("symgs_planes", 4),
                          count=2)
    else:
        _build.launch("symgs_dia_f64", dev, 11, None, 13, key=("symgs_planes", 4), count=2)
    assert lib.calls == [("symgs_dia_f64", (11, None, 13, 0xBEEF))]
    assert entered == [dev]
    assert dict(_build.launches) == ({} if rc else {("symgs_planes", 4): 2})


@pytest.mark.parametrize("pattern", [r"load_library\(", r"\.cuda_stream",
                                     r"def reset_launches", r"^launches(: [\w.]+)? = "])
def test_only_build_meets_the_library(pattern):
    """The boundary to the C library is ``_build.launch``: no other module
    of the port loads the library, reads a stream handle or keeps a launch
    counter of its own."""
    found = [str(p.relative_to(REPO)) for p in sorted((REPO / "spmv_torch").rglob("*.py"))
             if p != REPO / "spmv_torch" / "_build.py"
             and re.search(pattern, p.read_text(), flags=re.M)]
    assert not found


def _code(path: Path) -> str:
    """A CUDA source with its comments removed."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_ds_chain_cannot_be_contracted():
    """nvcc contracts a*b + c into an fma unless told not to, and a
    contracted step breaks the error-free transformations. Every float
    add, subtract and multiply of the DS chain (csrc/ds.cuh) is an
    __fadd_rn / __fsub_rn / __fmul_rn intrinsic, which nvcc never
    contracts: the functions' bodies hold no bare + or * at all, and their
    one minus is the exact negation inside two_prod's fmaf. The kernels
    touch their accumulators only through ds_add and ds_mul_f32, and the
    build never asks for fast math."""
    header = _code(_build.CSRC / "ds.cuh")
    bodies = re.findall(r"__device__ __forceinline__ Ds \w+\([^)]*\) \{(.*?)\n\}",
                        header, flags=re.S)
    assert len(bodies) == 4
    for body in bodies:
        assert "+" not in body and "*" not in body, body
        assert body.replace("fmaf(a.hi, b.hi, -p)", "").count("-") == 0, body
    # the single-RHS DS kernels and the block ones (an accumulator per column)
    allowed = (r"Ds acc = \{0\.0f, 0\.0f\};", r"Ds acc\[NR\];",
               r"for \(int c = 0; c < NR; \+\+c\) acc\[c\] = \{0\.0f, 0\.0f\};",
               r"acc = ds_add\(acc, ds_mul_f32\(.*", r"acc\[c\] = ds_add\(acc\[c\], ds_mul_f32\(.*",
               r"y[hl]\[.*\] = acc(\[c\])?\.(hi|lo);")
    for src, kernel in (("spmv_dia_ds.cu", "dia_ds_spmv_kernel"),
                        ("spmv_well_ds.cu", "well_ds_spmv_kernel"),
                        ("spmm_dia_ds.cu", "dia_ds_spmm_kernel"),
                        ("spmm_well.cu", "well_ds_spmm_kernel")):
        code = _code(_build.CSRC / src)
        assert '#include "ds.cuh"' in code
        body = re.search(rf"__global__ void {kernel}\(.*?\n\}}\n", code, flags=re.S)
        assert body is not None, (src, kernel)
        acc_lines = [ln.strip() for ln in body.group(0).splitlines() if "acc" in ln]
        assert any("ds_add(acc" in ln for ln in acc_lines), (src, acc_lines)
        for ln in acc_lines:
            assert any(re.fullmatch(p, ln) for p in allowed), (src, ln)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags


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
    # the s-step group (--sstep, --mpk, --newton, --deflated) is ported;
    # --cpu, the reference's JAX backend switch, is not
    with pytest.raises(SystemExit):
        demo_cg.main(["--lap2d", "8", "--device", "cpu", "--cpu"])


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
    assert _build.launches["dia_sym" if symmetric else "dia"] == 1


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
    assert (_build.launches["dia"], _build.launches["dia_sym"]) == (0, 1)


def _rows_args(rng, dtype, pos_dtype, device, planes=1, nrhs=1):
    """Random stacked row lists: D=3 shards of 32 groups (128 slices) with
    slice widths 0 to 6 (so the shards' entry counts differ), random window
    starts and positions; x (D*col_pad/128, nrhs*128). Returns (value
    planes, pos, slice_ptr, w0, x planes, tile_groups); DS planes get small
    lo planes."""
    nd, g, tg, col_pad = 3, 32, 8, 64 * 128
    width = rng.integers(0, 7, (nd, g * 4))
    ptr = np.zeros((nd, g * 4 + 1), dtype=np.int64)
    ptr[:, 1:] = np.cumsum(width * 32, axis=1)
    e = int(ptr[:, -1].max())
    values = [torch.as_tensor(rng.standard_normal((nd, e)), dtype=dtype, device=device)
              for _ in range(planes)]
    pos = torch.as_tensor(rng.integers(0, 24 * 128, (nd, e)), dtype=pos_dtype,
                          device=device)
    w0 = torch.as_tensor(rng.integers(0, 5, (nd, g // tg)) * 8, dtype=torch.int32,
                         device=device)
    xs = [torch.as_tensor(rng.standard_normal((nd * col_pad // 128, nrhs * 128)),
                          dtype=dtype, device=device) for _ in range(planes)]
    if planes == 2:
        values[1], xs[1] = values[1] * 1e-8, xs[1] * 1e-8
    return values, pos, torch.as_tensor(ptr, device=device), w0, xs, tg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("pos_dtype", [torch.int16, torch.int32])
def test_well_kernel_matches_plain_on_cuda(cuda, pos_dtype, dtype, tol):
    """Stacked shards of unequal entry counts, empty slices, random window
    starts and positions: the row-list kernel vs its plain version on the
    card."""
    (values,), pos, ptr, w0, (x2,), tg = _rows_args(np.random.default_rng(11), dtype,
                                                    pos_dtype, cuda)
    y = spmv_well_cuda.spmv_well_stacked(values, pos, ptr, w0, x2, tg)
    torch.cuda.synchronize()
    want = spmv_well_rows_plain(values, pos, ptr, w0, x2, tg)
    err = float(torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want))
    assert err <= tol
    assert _build.launches["well"] == 1


@pytest.mark.cuda
def test_dist_matrix_well_runs_through_kernel_on_cuda(cuda):
    from spmv_torch.corpus import fem_p1_2d
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.reorder import rcm_reorder

    a, _ = rcm_reorder(fem_p1_2d(5000, dtype=np.float64), keep_best=True)
    A = build_dist_matrix(a, n_devices=2, symmetric=True, local_format="well",
                          device=cuda)
    x = np.random.default_rng(3).standard_normal(a.nrows)
    y = A.from_dist(A.matvec(A.to_dist(x)))
    want = a.matvec(x)
    assert np.linalg.norm(y - want) <= 1e-12 * np.linalg.norm(want)
    assert _build.launches["well"] == 2  # L and L^T, D=2 in one launch each


def _bits_equal(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.cuda
def test_dia_ds_kernel_matches_plain_on_cuda(cuda):
    """Stacked shards, odd offsets, random hi/lo planes: kernel vs plain
    on the card, both planes bit for bit."""
    rng = np.random.default_rng(21)
    offs = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    nd, nr = 3, 40
    dh = rng.standard_normal((nd, nr, len(offs) * 128))
    xh = rng.standard_normal((nd * nr, 128))
    t = [torch.as_tensor(v, dtype=torch.float32, device=cuda)
         for v in (dh, dh * 1e-8 * rng.standard_normal(dh.shape),
                   xh, xh * 1e-8 * rng.standard_normal(xh.shape))]
    got = spmv_dia_ds_cuda.spmv_dia_ds_stacked(*t, offs)
    torch.cuda.synchronize()
    assert _bits_equal(got, spmv_dia_ds_stacked_plain(*t, offs))
    assert _build.launches["dia_ds"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", [torch.int16, torch.int32])
def test_well_ds_kernel_matches_plain_on_cuda(cuda, pos_dtype):
    """Stacked shards of unequal entry counts, empty slices, random window
    starts and positions: the row-list kernel vs its plain version on the
    card, both planes bit for bit."""
    vs, pos, ptr, w0, xs, tg = _rows_args(np.random.default_rng(22), torch.float32,
                                          pos_dtype, cuda, planes=2)
    args = (*vs, pos, ptr, w0, *xs, tg)
    got = spmv_well_ds_cuda.spmv_well_ds_stacked(*args)
    torch.cuda.synchronize()
    assert _bits_equal(got, spmv_well_ds_rows_plain(*args))
    assert _build.launches["well_ds"] == 1


@pytest.mark.cuda
def test_ds_kernels_padding_adds_exact_zero_on_cuda(cuda):
    """A packing that is mostly padding (rows of 0 to 3 entries, K slots
    for the longest): the padding slots add an exact (0, 0), so the kernel
    equals the plain version bit for bit, empty rows are exactly (0, 0),
    and a DIA diagonal reaching past the shard adds nothing."""
    from spmv_torch.formats.csr import CSRHost
    from spmv_torch.ops.spmv_well_ds import spmv_well_ds_2d

    rng = np.random.default_rng(23)
    n = 3000
    lens = rng.integers(0, 4, n)
    lens[:130] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = np.clip(rows + rng.integers(-200, 200, len(rows)), 0, n - 1)
    a = CSRHost.from_coo(rows, cols, rng.standard_normal(len(rows)), n, n)
    w = csr_to_well_ds(a, tile_groups=16, device=cuda)
    x = np.zeros(w.ncols_pad)
    x[:n] = rng.standard_normal(n)
    xs = [torch.as_tensor(v.reshape(-1, 128), device=cuda)
          for v in (x.astype(np.float32), (x - x.astype(np.float32)).astype(np.float32))]
    got = spmv_well_ds_2d(w, *xs)
    torch.cuda.synchronize()
    want = spmv_well_ds_stacked_plain(
        w.values_hi.unsqueeze(0), w.values_lo.unsqueeze(0), w.pos.unsqueeze(0),
        w.w0.unsqueeze(0), *xs, w.tile_groups)
    assert _bits_equal(got, want)
    empty = torch.as_tensor(np.flatnonzero(lens == 0), device=cuda)
    assert not got[0].view(-1)[empty].any() and not got[1].view(-1)[empty].any()
    # a DIA diagonal entirely outside the shard: zero data, zero result
    t = [torch.zeros((1, 1, 128), device=cuda) for _ in range(2)]
    t += [torch.ones((1, 128), device=cuda) for _ in range(2)]
    yh, yl = spmv_dia_ds_cuda.spmv_dia_ds_stacked(t[0] + 1, t[1] + 1, t[2], t[3], (200,))
    torch.cuda.synchronize()
    assert not yh.any() and not yl.any()


@pytest.mark.cuda
def test_dist_matrix_ds_runs_through_kernels_on_cuda(cuda):
    from spmv_torch.ds import ds_from_f64, ds_to_f64
    from spmv_torch.gen import random_csr
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    rng = np.random.default_rng(24)
    a = create_laplace_2d(64, 64)
    a.values[:] = a.values * (1 + 1e-9 * rng.standard_normal(a.nnz))
    g = random_csr(700, 700, 5, seed=95, symmetric=True, spd_shift=1.0)
    for mat, fmt, sym in ((a, "dia_ds", False), (g, "well_ds", True)):
        A = build_dist_matrix(mat, n_devices=4, symmetric=sym, local_format=fmt,
                              device=cuda)
        x = rng.standard_normal(mat.nrows) * 1e3
        xh, xl = ds_from_f64(x)
        yh, yl = A.matvec_ds(A.to_dist(xh), A.to_dist(xl))
        got = ds_to_f64(A.from_dist(yh), A.from_dist(yl))
        want = mat.matvec(x)
        assert np.linalg.norm(got - want) < 1e-13 * np.linalg.norm(want)
    assert _build.launches["dia_ds"] == 1
    assert _build.launches["well_ds"] == 2  # L and L^T


# ----- the block (SpMM) kernels -----

def _spmm_dia_args(rng, dtype, symmetric, nrhs, device, nd=3, nr=40):
    offs = (-301, -37, -5, -1, 0) if symmetric else (-301, -37, -1, 0, 1, 37, 301)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = torch.as_tensor(rng.standard_normal((nd, nr, len(offs) * 128)).astype(npdt),
                           device=device)
    x2 = torch.as_tensor(rng.standard_normal((nd * nr, nrhs * 128)).astype(npdt),
                         device=device)
    return data, x2, offs


@pytest.mark.parametrize("symmetric", [False, True])
def test_spmm_wrappers_take_plain_path_on_cpu(symmetric):
    """On CPU tensors every block wrapper returns its plain version's
    result, column r equal to the single-RHS plain apply of column r, and
    launches nothing."""
    rng = np.random.default_rng(31)
    data, x2, offs = _spmm_dia_args(rng, torch.float64, symmetric, 3, "cpu", nr=8)
    y = spmm_dia_cuda.spmm_dia_stacked(data, x2, offs, symmetric)
    assert torch.equal(y, spmm_dia_stacked_plain(data, x2, offs, symmetric))
    for c, yc in zip(columns(x2), columns(y)):
        assert torch.equal(yc, spmv_dia_stacked_plain(data, c, offs, symmetric))
    (v,), pos, ptr, w0, (x,), tg = _rows_args(rng, torch.float32, torch.int16, "cpu",
                                              nrhs=3)
    y = spmm_well_cuda.spmm_well_stacked(v, pos, ptr, w0, x, tg)
    assert torch.equal(y, spmm_well_stacked_plain(v, pos, ptr, w0, x, tg))
    for c, yc in zip(columns(x), columns(y)):
        assert torch.equal(yc, spmv_well_rows_plain(v, pos, ptr, w0, c, tg))
    vs, pos, ptr, w0, xs, tg = _rows_args(rng, torch.float32, torch.int32, "cpu", 2, 2)
    got = spmm_well_cuda.spmm_well_ds_stacked(*vs, pos, ptr, w0, *xs, tg)
    assert _bits_equal(got, spmm_well_ds_stacked_plain(*vs, pos, ptr, w0, *xs, tg))
    for r, (h, lo) in enumerate(zip(columns(xs[0]), columns(xs[1]))):
        one = spmv_well_ds_rows_plain(*vs, pos, ptr, w0, h, lo, tg)
        assert _bits_equal([columns(g)[r] for g in got], one)
    dh, xh, offs = _spmm_dia_args(rng, torch.float32, False, 2, "cpu", nr=8)
    planes = (dh, dh * 1e-8, xh, xh * 1e-8)
    got = spmv_dia_ds_cuda.spmm_dia_ds_stacked(*planes, offs)
    assert _bits_equal(got, spmm_dia_ds_stacked_plain(*planes, offs))
    assert _build.launches["dia_spmm"] == _build.launches["dia_sym_spmm"] == 0
    assert _build.launches["well_spmm"] == _build.launches["well_ds_spmm"] == 0
    assert _build.launches["dia_ds"] == _build.launches["dia_ds_spmm"] == 0


@pytest.mark.parametrize("case,exc", [
    ("dia_lanes", ValueError), ("dia_rows", ValueError), ("dia_dtype", TypeError),
    ("dia_positive_sym", ValueError), ("dia_noncontiguous", ValueError),
    ("well_lanes", ValueError), ("well_dtype", TypeError), ("well_pos", TypeError),
    ("well_ds_f64", TypeError), ("well_ds_planes", ValueError),
    ("dia_ds_lanes", ValueError), ("dia_ds_f64", TypeError),
])
def test_spmm_wrappers_reject_bad_input(case, exc):
    rng = np.random.default_rng(32)
    data, x2, offs = _spmm_dia_args(rng, torch.float32, True, 2, "cpu", nr=4)
    (v,), pos, ptr, w0, (x,), tg = _rows_args(rng, torch.float32, torch.int16, "cpu",
                                              nrhs=2)
    vs, _, _, _, xs, _ = _rows_args(rng, torch.float32, torch.int16, "cpu", 2, 2)
    calls = {
        "dia_lanes": lambda: spmm_dia_cuda.spmm_dia_stacked(data, x2[:, :200].contiguous(),
                                                            offs, True),
        "dia_rows": lambda: spmm_dia_cuda.spmm_dia_stacked(data, x2[:-1], offs, True),
        "dia_dtype": lambda: spmm_dia_cuda.spmm_dia_stacked(data, x2.double(), offs, True),
        "dia_positive_sym": lambda: spmm_dia_cuda.spmm_dia_stacked(
            data[:, :, :640].contiguous(), x2, (-1, 0, 1, 2, 3), True),
        "dia_noncontiguous": lambda: spmm_dia_cuda.spmm_dia_stacked(
            data, torch.zeros((256, 120)).t(), offs, True),
        "well_lanes": lambda: spmm_well_cuda.spmm_well_stacked(
            v, pos, ptr, w0, x[:, :100].contiguous(), tg),
        "well_dtype": lambda: spmm_well_cuda.spmm_well_stacked(v, pos, ptr, w0,
                                                               x.double(), tg),
        "well_pos": lambda: spmm_well_cuda.spmm_well_stacked(v, pos.long(), ptr, w0, x, tg),
        "well_ds_f64": lambda: spmm_well_cuda.spmm_well_ds_stacked(
            vs[0].double(), vs[1].double(), pos, ptr, w0, xs[0].double(),
            xs[1].double(), tg),
        "well_ds_planes": lambda: spmm_well_cuda.spmm_well_ds_stacked(
            *vs, pos, ptr, w0, xs[0], xs[1][:, :128].contiguous(), tg),
        "dia_ds_lanes": lambda: spmv_dia_ds_cuda.spmm_dia_ds_stacked(
            data, data, x2[:, :200].contiguous(), x2[:, :200].contiguous(), offs),
        "dia_ds_f64": lambda: spmv_dia_ds_cuda.spmm_dia_ds_stacked(
            data.double(), data.double(), x2.double(), x2.double(), offs),
    }
    with pytest.raises(exc):
        calls[case]()
    assert _build.launches["dia_spmm"] == _build.launches["dia_sym_spmm"] == 0
    assert _build.launches["well_spmm"] == _build.launches["well_ds_spmm"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_dia_spmm_kernels_match_plain_on_cuda(cuda, symmetric, dtype, tol, nrhs):
    """dia_spmm / dia_sym_spmm vs the plain version on stacked shards with
    odd offsets, and column r bit-equal to the single-RHS kernel on column
    r (nrhs 11 runs two chunks of columns)."""
    rng = np.random.default_rng(33)
    data, x2, offs = _spmm_dia_args(rng, dtype, symmetric, nrhs, cuda)
    y = spmm_dia_cuda.spmm_dia_stacked(data, x2, offs, symmetric)
    torch.cuda.synchronize()
    want = spmm_dia_stacked_plain(data, x2, offs, symmetric)
    err = float(torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want))
    assert err <= tol
    assert _build.launches["dia_sym_spmm" if symmetric else "dia_spmm"] == 1
    for c, yc in zip(columns(x2), columns(y)):
        assert torch.equal(yc, spmv_dia_cuda.spmv_dia_stacked(data, c, offs, symmetric))


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("pos_dtype", [torch.int16, torch.int32])
def test_well_spmm_kernel_matches_plain_on_cuda(cuda, pos_dtype, dtype, tol, nrhs):
    """well_spmm on random stacked row lists (unequal shards, empty slices)
    vs its plain version, and column r bit-equal to the single-RHS kernel
    on column r (nrhs 11 runs two chunks of columns)."""
    rng = np.random.default_rng(34)
    (v,), pos, ptr, w0, (x,), tg = _rows_args(rng, dtype, pos_dtype, cuda, nrhs=nrhs)
    y = spmm_well_cuda.spmm_well_stacked(v, pos, ptr, w0, x, tg)
    torch.cuda.synchronize()
    want = spmm_well_stacked_plain(v, pos, ptr, w0, x, tg)
    err = float(torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want))
    assert err <= tol
    assert _build.launches["well_spmm"] == 1
    for c, yc in zip(columns(x), columns(y)):
        assert torch.equal(yc, spmv_well_cuda.spmv_well_stacked(v, pos, ptr, w0, c, tg))


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 3, 8, 11])
def test_ds_spmm_kernels_match_plain_on_cuda(cuda, nrhs):
    """dia_ds_spmm and well_ds_spmm (int16 and int32 pos) vs their plain
    versions, both planes bit for bit, and each column bit-equal to the
    single-RHS DS kernel on that column."""
    rng = np.random.default_rng(35)
    dh, xh, offs = _spmm_dia_args(rng, torch.float32, False, nrhs, cuda)
    planes = (dh, dh * 1e-8, xh, xh * 1e-8)
    got = spmv_dia_ds_cuda.spmm_dia_ds_stacked(*planes, offs)
    torch.cuda.synchronize()
    assert _bits_equal(got, spmm_dia_ds_stacked_plain(*planes, offs))
    for r, (h, lo) in enumerate(zip(columns(planes[2]), columns(planes[3]))):
        one = spmv_dia_ds_cuda.spmv_dia_ds_stacked(dh, planes[1], h, lo, offs)
        assert _bits_equal([columns(g)[r] for g in got], one)
    for pos_dtype in (torch.int16, torch.int32):
        vs, pos, ptr, w0, xs, tg = _rows_args(rng, torch.float32, pos_dtype, cuda,
                                              planes=2, nrhs=nrhs)
        rows = (*vs, pos, ptr, w0)
        got = spmm_well_cuda.spmm_well_ds_stacked(*rows, *xs, tg)
        torch.cuda.synchronize()
        assert _bits_equal(got, spmm_well_ds_stacked_plain(*rows, *xs, tg))
        for r, (h, lo) in enumerate(zip(columns(xs[0]), columns(xs[1]))):
            one = spmv_well_ds_cuda.spmv_well_ds_stacked(*rows, h, lo, tg)
            assert _bits_equal([columns(g)[r] for g in got], one)
    assert _build.launches["dia_ds_spmm"] == 1
    assert _build.launches["well_ds_spmm"] == 2


@pytest.mark.cuda
def test_matmat_runs_through_block_kernels_on_cuda(cuda):
    """DistMatrix.matmat / matmat_ds on D=4 shards launch the block kernels
    once per apply and match the host oracle per column."""
    from spmv_torch.ds import ds_from_f64, ds_to_f64
    from spmv_torch.gen import random_csr
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    rng = np.random.default_rng(36)
    lap = create_laplace_2d(64, 64)
    gen = random_csr(900, 900, 6, seed=63)
    X = {m.nrows: rng.standard_normal((m.nrows, 3)) for m in (lap, gen)}
    for mat, fmt, sym, key in ((lap, "dia", True, "dia_sym_spmm"),
                               (lap, "dia", False, "dia_spmm"),
                               (gen, "well", False, "well_spmm")):
        A = build_dist_matrix(mat, n_devices=4, symmetric=sym, dtype=np.float64,
                              local_format=fmt, device=cuda)
        before = _build.launches[key]
        Y = A.from_dist_block(A.matmat(A.to_dist_block(X[mat.nrows])))
        assert _build.launches[key] - before == 1
        want = np.stack([mat.matvec(c) for c in X[mat.nrows].T], axis=1)
        assert np.linalg.norm(Y - want) <= 1e-12 * np.linalg.norm(want)
    for mat, fmt in ((lap, "dia_ds"), (gen, "well_ds")):
        A = build_dist_matrix(mat, n_devices=4, local_format=fmt, device=cuda)
        xh, xl = ds_from_f64(X[mat.nrows])
        yh, yl = A.matmat_ds(A.to_dist_block(xh), A.to_dist_block(xl))
        got = ds_to_f64(A.from_dist_block(yh), A.from_dist_block(yl))
        want = np.stack([mat.matvec(c) for c in X[mat.nrows].T], axis=1)
        assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)
    assert _build.launches["dia_ds_spmm"] == 1
    assert _build.launches["well_ds_spmm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 8, 11])
def test_well_spmm_kernels_on_packed_stacks_on_cuda(cuda, nrhs):
    """The block kernels on the row lists of a packing whose first row
    group needs K = 140 slots (max_k=256): fp32 within 1e-6 of its plain
    version, DS both planes bit for bit, and every column bit-equal to the
    single-RHS kernel on that column."""
    from spmv_torch.formats.csr import CSRHost
    from spmv_torch.ops.spmm_well import spmm_well_2d, spmm_well_ds_2d
    from spmv_torch.ops.spmv_well import spmv_well_2d
    from spmv_torch.ops.spmv_well_ds import spmv_well_ds_2d

    rng = np.random.default_rng(37)
    n = 140 * 128
    r = np.repeat(np.arange(128), 140)
    rows = np.concatenate([r, np.arange(128, n)])
    cols = np.concatenate([r + 128 * np.tile(np.arange(140), 128), np.arange(128, n)])
    a = CSRHost.from_coo(rows, cols, rng.standard_normal(len(rows)), n, n)
    w = csr_to_well(a, tile_groups=1, max_k=256, dtype=np.float32, device=cuda)
    wds = csr_to_well_ds(a, tile_groups=1, max_k=256, device=cuda)
    assert w.k_slots == wds.k_slots == 140
    x = torch.randn((w.ncols_pad // 128, nrhs * 128), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(37))
    y = spmm_well_2d(w, x)
    ys = spmm_well_ds_2d(wds, x, x * 1e-8)
    torch.cuda.synchronize()
    tg = w.tile_groups
    lists = [t.unsqueeze(0) for t in (w.rows_values, w.rows_pos, w.slice_ptr, w.w0)]
    want = spmm_well_stacked_plain(*lists, x, tg)
    assert float(torch.linalg.vector_norm(y - want)
                 / torch.linalg.vector_norm(want)) <= 1e-6
    ds_lists = [t.unsqueeze(0) for t in (wds.rows_values_hi, wds.rows_values_lo,
                                         wds.rows_pos, wds.slice_ptr, wds.w0)]
    assert _bits_equal(ys, spmm_well_ds_stacked_plain(*ds_lists, x, x * 1e-8, tg))
    for c, xc in enumerate(columns(x)):
        assert torch.equal(columns(y)[c], spmv_well_2d(w, xc))
        one = spmv_well_ds_2d(wds, xc, xc * 1e-8)
        assert _bits_equal([columns(g)[c] for g in ys], one)
    assert (_build.launches["well_spmm"], _build.launches["well_ds_spmm"]) == (1, 1)


@pytest.mark.cuda
def test_dist_matrix_keeps_well_arrays_on_host_on_cuda(cuda):
    """A WELL DistMatrix built for the card keeps the WELL arrays on the
    host and its row lists on the card; matvec and matmat (two launches
    each: L and L^T) agree with the host oracle and give the same bits on
    a second run."""
    from spmv_torch.corpus import fem_p1_2d
    from spmv_torch.parallel.dist_matrix import HOST_FIELDS, build_dist_matrix
    from spmv_torch.reorder import rcm_reorder

    a, _ = rcm_reorder(fem_p1_2d(5000, dtype=np.float64), keep_best=True)
    A = build_dist_matrix(a, n_devices=2, symmetric=True, local_format="well",
                          device=cuda)
    for name in HOST_FIELDS:
        t = getattr(A, name)
        assert t is None or t.device.type == "cpu", name
    assert A.local_rows_values.is_cuda and A.local_rowsT_values.is_cuda
    X = np.random.default_rng(38).standard_normal((a.nrows, 3))
    y = A.matvec(A.to_dist(X[:, 0].copy()))
    Y = A.matmat(A.to_dist_block(X))
    assert torch.equal(A.matvec(A.to_dist(X[:, 0].copy())), y)
    assert torch.equal(A.matmat(A.to_dist_block(X)), Y)
    want = np.stack([a.matvec(c) for c in X.T], axis=1)
    assert np.linalg.norm(A.from_dist(y) - want[:, 0]) <= 1e-12 * np.linalg.norm(want)
    assert np.linalg.norm(A.from_dist_block(Y) - want) <= 1e-12 * np.linalg.norm(want)
    assert _build.launches["well"] == 4
    assert _build.launches["well_spmm"] == 4


def _wide_dia_args(rng, dtype, symmetric, k, nrhs, dev):
    """D=2 stacked shards with k distinct offsets (beyond the 64 of the
    reference's default cap) and random data and x."""
    offs = tuple(range(-k + 1, 1)) if symmetric else tuple(range(-(k // 2), k - k // 2))
    nd, nr = 2, 12
    data = torch.as_tensor(rng.standard_normal((nd, nr, k * 128)), dtype=dtype, device=dev)
    x2 = torch.as_tensor(rng.standard_normal((nd * nr, nrhs * 128)), dtype=dtype,
                         device=dev)
    return data, x2, offs


@pytest.mark.cuda
@pytest.mark.parametrize("k", [65, 297])
@pytest.mark.parametrize("symmetric", [False, True])
def test_dia_kernels_take_many_diagonals_on_cuda(cuda, symmetric, k):
    """K = 65 and 297 (the 1-D interval AMG levels' widths): dia_spmv and
    dia_spmm vs their plain versions, fp32 (relative L2 <= 1e-6)."""
    rng = np.random.default_rng(k)
    data, x2, offs = _wide_dia_args(rng, torch.float32, symmetric, k, 3, cuda)
    y = spmm_dia_cuda.spmm_dia_stacked(data, x2, offs, symmetric)
    c = columns(x2)[1]
    y1 = spmv_dia_cuda.spmv_dia_stacked(data, c, offs, symmetric)
    torch.cuda.synchronize()
    for got, want in ((y, spmm_dia_stacked_plain(data, x2, offs, symmetric)),
                      (y1, spmv_dia_stacked_plain(data, c, offs, symmetric))):
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert err <= 1e-6, err
    assert torch.equal(columns(y)[1], y1)


@pytest.mark.cuda
@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("symmetric", [False, True])
def test_dia_bf16_kernels_match_plain_on_cuda(cuda, symmetric, nrhs):
    """bf16 storage (f32 accumulation, y rounded once to bf16): the kernel
    and the plain version differ by the contraction of the f32 sums, which
    can move a rounding to bf16 by one ulp (2^-8 relative): relative L2
    <= 8e-3."""
    rng = np.random.default_rng(5 + nrhs)
    data, x2, offs = _wide_dia_args(rng, torch.bfloat16, symmetric, 9, nrhs, cuda)
    if nrhs == 1:
        y = spmv_dia_cuda.spmv_dia_stacked(data, x2, offs, symmetric)
        want = spmv_dia_stacked_plain(data, x2, offs, symmetric)
    else:
        y = spmm_dia_cuda.spmm_dia_stacked(data, x2, offs, symmetric)
        want = spmm_dia_stacked_plain(data, x2, offs, symmetric)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    err = float(torch.linalg.vector_norm((y - want).float())
                / torch.linalg.vector_norm(want.float()))
    assert err <= 8e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("case", ["laplace 64^2", "band +-301 D=3", "band K=297",
                                  "spread past shared memory"])
@pytest.mark.parametrize("symmetric,nrhs", [(True, 1), (False, 1), (False, 3),
                                            (False, 8), (False, 11), (True, 3), (True, 8),
                                            (True, 11)])
def test_window_kernels_match_plain_on_cuda(cuda, symmetric, nrhs, case, dtype):
    """The four DIA kernels on their routes (the tile kernels dia_sym_spmv
    and dia_spmm of csrc/dia_window.cuh; dia_spmv and dia_sym_spmm as
    ``spmv_dia_cuda.route`` picks) vs their plain versions, one launch
    each, the same bits on a second apply; every column of dia_spmm equals
    dia_spmv on it and every column of dia_sym_spmm equals dia_sym_spmv,
    bit for bit. The spread case reads some x from global memory and, at 8
    fp64 columns, holds more than 48 KB of shared memory. Tolerances:
    TOL_KERNEL's (relative L2 1e-6 fp32, 1e-13 fp64) and bf16's one ulp of
    contraction (8e-3)."""
    rng = np.random.default_rng(41)
    offs, nd, nr = {
        "laplace 64^2": ((-64, -1, 0, 1, 64), 1, 32),
        "band +-301 D=3": ((-301, -37, -5, -1, 0, 1, 5, 37, 301), 3, 13),
        "band K=297": (tuple(range(-148, 149)), 1, 9),
        "spread past shared memory": (tuple(range(-2800, 2801, 200)), 2, 27),
    }[case]
    if symmetric:
        offs = tuple(o for o in offs if o <= 0)
    data = torch.as_tensor(rng.standard_normal((nd, nr, len(offs) * 128)) / len(offs),
                           device=cuda).to(dtype)
    x2 = torch.as_tensor(rng.standard_normal((nd * nr, nrhs * 128)), device=cuda).to(dtype)
    if nrhs == 1:
        kernel, plain = spmv_dia_cuda.spmv_dia_stacked, spmv_dia_stacked_plain
        single = spmm_dia_cuda.spmm_dia_stacked  # its column is the reference
    else:
        kernel, plain = spmm_dia_cuda.spmm_dia_stacked, spmm_dia_stacked_plain
        single = spmv_dia_cuda.spmv_dia_stacked
    y = kernel(data, x2, offs, symmetric)
    torch.cuda.synchronize()
    key = (("dia_sym" if symmetric else "dia") if nrhs == 1 else
           ("dia_sym_spmm" if symmetric else "dia_spmm"))
    assert _build.launches[key] == 1
    assert torch.equal(kernel(data, x2, offs, symmetric), y)
    want = plain(data, x2, offs, symmetric)
    err = float(torch.linalg.vector_norm((y - want).double())
                / torch.linalg.vector_norm(want.double()))
    assert err <= {torch.float32: 1e-6, torch.float64: 1e-13, torch.bfloat16: 8e-3}[dtype]
    for c, yc in zip(columns(x2), columns(y)):
        assert torch.equal(yc, single(data, c, offs, symmetric))


ROUTES = {
    # dia_spmv (vanilla, one column): its loop kernel and dia_spmv_rows
    False: [spmv_dia_cuda.Route("loop"), spmv_dia_cuda.Route("rows", 1),
            spmv_dia_cuda.Route("rows", 0)],
    # dia_sym_spmm (symmetric, a block): its direct kernel
    True: [spmv_dia_cuda.Route("loop")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("case", ["laplace 64^2", "band +-301 D=3"])
@pytest.mark.parametrize("symmetric,r", [(s, r) for s in ROUTES for r in range(len(ROUTES[s]))])
def test_dia_routes_match_on_cuda(cuda, symmetric, r, case, dtype):
    """Every design ``route`` may pick for dia_spmv (``rows_per_thread`` 0:
    16 bytes of rows a thread) and dia_sym_spmm, launched through
    ``spmv_dia_cuda.launch``, gives the bits of the tile kernel's column
    (dia_spmm at nrhs 1 for dia_spmv; dia_sym_spmv on each column of a
    3- and an 11-column block for dia_sym_spmm) and is within TOL_KERNEL's
    tolerance (bf16: 8e-3) of the plain version. K = 5 and 9, one shard
    and three stacked ones, offsets that are and are not multiples of the
    rows a thread."""
    rng = np.random.default_rng(9)
    offs, nd, nr = {"laplace 64^2": ((-64, -1, 0, 1, 64), 1, 32),
                    "band +-301 D=3": ((-301, -37, -5, -1, 0, 1, 5, 37, 301), 3, 13)}[case]
    rt = ROUTES[symmetric][r]
    if rt.kernel == "rows" and rt.rows_per_thread == 0:
        rt = spmv_dia_cuda.Route("rows", 16 // torch.empty(0, dtype=dtype).element_size())
    if symmetric:
        offs = tuple(o for o in offs if o <= 0)
    data = torch.as_tensor(rng.standard_normal((nd, nr, len(offs) * 128)) / len(offs),
                           device=cuda).to(dtype)
    tol = {torch.float32: 1e-6, torch.float64: 1e-13, torch.bfloat16: 8e-3}[dtype]
    for nrhs in ((3, 11) if symmetric else (1,)):
        x2 = torch.as_tensor(rng.standard_normal((nd * nr, nrhs * 128)),
                             device=cuda).to(dtype)
        y = spmv_dia_cuda.launch(rt, data, x2, offs, symmetric, symmetric)
        want = (spmm_dia_stacked_plain if symmetric else spmv_dia_stacked_plain)(
            data, x2, offs, symmetric)
        torch.cuda.synchronize()
        err = float(torch.linalg.vector_norm((y - want).double())
                    / torch.linalg.vector_norm(want.double()))
        assert err <= tol, err
        single = spmv_dia_cuda.spmv_dia_stacked if symmetric else spmm_dia_cuda.spmm_dia_stacked
        for c, yc in zip(columns(x2), columns(y)):
            assert torch.equal(yc, single(data, c, offs, symmetric))


def test_dia_bf16_plain_accumulates_in_f32():
    """The plain bf16 DIA apply equals the f32 apply of the same (bf16)
    values rounded once to bf16."""
    rng = np.random.default_rng(2)
    for symmetric in (False, True):
        data, x2, offs = _wide_dia_args(rng, torch.bfloat16, symmetric, 9, 1, "cpu")
        y = spmv_dia_cuda.spmv_dia_stacked(data, x2, offs, symmetric)
        want = spmv_dia_stacked_plain(data.float(), x2.float(), offs, symmetric)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, want.to(torch.bfloat16))
    assert _build.launches["dia"] == _build.launches["dia_sym"] == 0


@pytest.mark.cuda
def test_amg_cycle_on_cuda_matches_cpu(cuda):
    """One interval2d W-cycle on the card (DIA kernels on every level) vs
    the same hierarchy's cycle on the CPU (plain versions): relative L2 <=
    1e-5 (f32 sums in another order, through 3 levels)."""
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.amg import amg_setup

    a = create_laplace_2d(96, 96)
    kw = dict(aggregate="interval2d", interval_size=4, cycle=2, local_format="dia",
              coarse_max=256)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, n_devices=2, dtype=np.float32, local_format="dia",
                              device=dev)
        h = amg_setup(a, A, **kw)
        out.append(h.as_preconditioner()(A.to_dist(gaussian_bump(a.nrows,
                                                                  dtype=np.float32))))
    assert _build.launches["dia"] > 0
    got, want = out[0].cpu(), out[1]
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert err <= 1e-5, err


def _convection_diffusion(g: int, cx=12.0, cy=8.0):
    """The upwind convection-diffusion operator of the transpose tests
    (non-symmetric, the Laplacian's pattern)."""
    from spmv_torch.formats.csr import CSRHost

    n, h = g * g, 1.0 / (g + 1)
    i = np.arange(n, dtype=np.int64)
    ix, iy = i % g, i // g
    parts = [(i, i, np.full(n, 4.0 + (cx + cy) * h))]
    for ok, j, v in ((ix > 0, i - 1, -1.0 - cx * h), (ix < g - 1, i + 1, -1.0),
                     (iy > 0, i - g, -1.0 - cy * h), (iy < g - 1, i + g, -1.0)):
        parts.append((i[ok], j[ok], np.full(int(ok.sum()), v)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    return CSRHost.from_coo(rows, cols, vals, n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dia", "well"])
def test_matvec_transpose_matches_plain_on_cuda(cuda, fmt):
    """matvec_transpose of a non-symmetric operator at D=2 on the card (the
    DIA transpose through dia_spmv, the WELL transpose stack through
    well_spmv, one launch each) vs the same operator on the CPU (the plain
    versions), and vs the host A^T x."""
    from spmv_torch.corpus import fem_p1_2d
    from spmv_torch.formats.csr import CSRHost
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.reorder import rcm_reorder

    if fmt == "dia":
        a = _convection_diffusion(96)
    else:
        a, _ = rcm_reorder(fem_p1_2d(5000, dtype=np.float64), keep_best=True)
        s = np.random.default_rng(5).uniform(0.5, 1.5, a.nrows)
        a = CSRHost(a.rowptr, a.colind, a.values * np.repeat(s, a.row_nnz()), a.ncols)
    q = np.random.default_rng(6).standard_normal(a.nrows)
    ys = {}
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, n_devices=2, dtype=np.float64, local_format=fmt,
                              device=dev)
        ys[dev.type] = A.from_dist(A.matvec_transpose(A.to_dist(q, side="row")),
                                   side="col")
    want = a.transpose().matvec(q)
    assert np.linalg.norm(ys["cuda"] - ys["cpu"]) <= 1e-13 * np.linalg.norm(want)
    assert np.linalg.norm(ys["cuda"] - want) <= 1e-12 * np.linalg.norm(want)
    assert (_build.launches["dia"], _build.launches["well"]) == (
        (1, 0) if fmt == "dia" else (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gmres", "bicgstab"])
def test_general_krylov_on_cuda_matches_plain(cuda, solver):
    """One GMRES(30) and one Jacobi-BiCGStab solve of the convection-
    diffusion operator (float64, vanilla DIA, D=2) on the card, through
    dia_spmv, vs the same solve on the CPU through the plain version. The
    kernel rounds its sums otherwise than the plain version (1e-13 apart);
    GMRES's counts stay within 1 and its solutions within 1e-9, while
    BiCGStab, not monotone, parts by rounding after some dozens of steps
    (245 against 250 iterations at rtol 1e-10 on the H100): within 3% and
    1e-6 there."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.bicgstab import bicgstab
    from spmv_torch.solvers.gmres import gmres

    a = _convection_diffusion(96)
    b = np.random.default_rng(7).standard_normal(a.nrows)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, n_devices=2, dtype=np.float64, local_format="dia",
                              device=dev)
        if solver == "gmres":
            res = gmres(A.matvec, A.to_dist(b), restart=30, max_cycles=20, rtol=1e-10)
        else:
            res = bicgstab(A.matvec, A.to_dist(b), kmax=500, rtol=1e-10,
                           preconditioner=A.jacobi_preconditioner())
        out[dev.type] = (res.converged, res.iterations, A.from_dist(res.x))
    its, its_plain = out["cuda"][1], out["cpu"][1]
    slack, tol = (1, 1e-9) if solver == "gmres" else (0.03 * its_plain, 1e-6)
    assert out["cuda"][0] and out["cpu"][0] and abs(its - its_plain) <= slack
    x, xp = out["cuda"][2], out["cpu"][2]
    assert np.linalg.norm(x - xp) <= tol * np.linalg.norm(xp)
    assert _build.launches["dia"] > out["cuda"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_powers_basis_on_cuda_matches_cpu(cuda, fmt):
    """The matrix-powers basis on the card: every DIA window step is one
    dia_spmv launch for all shards (no plain path on a CUDA tensor), and
    the basis equals the CPU plan's within 1e-13 (float64)."""
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.parallel.powers import build_powers_plan, chebyshev_powers_basis

    a = create_laplace_2d(96, 96)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, n_devices=4, local_format=fmt, device=dev)
        pp = build_powers_plan(a, A, s=4)
        _build.launches.clear()
        V = chebyshev_powers_basis(pp, A.to_dist(gaussian_bump(a.nrows)), 4.4, 4.4)
        out.append((V.cpu(), _build.launches["dia"]))
    (v_gpu, n_gpu), (v_cpu, n_cpu) = out
    assert n_gpu == (4 if fmt == "dia" else 0) and n_cpu == 0
    assert float(torch.linalg.vector_norm(v_gpu - v_cpu) / torch.linalg.vector_norm(v_cpu)) < 1e-13


@pytest.mark.cuda
def test_sstep_solvers_on_cuda_match_cpu(cuda):
    """cg_sstep and gmres_sstep on the card: the CPU run's float64
    iteration counts, one dia_sym_spmv launch an apply."""
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.cg_sstep import cg_sstep
    from spmv_torch.solvers.gmres_sstep import gmres_sstep

    a = create_laplace_2d(64, 64)
    its = []
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, symmetric=True, local_format="dia", device=dev)
        b = A.to_dist(gaussian_bump(a.nrows))
        _build.launches.clear()
        r1 = cg_sstep(A.matvec, b, s=4, kmax=2000, rtol=1e-8)
        r2 = gmres_sstep(A.matvec, b, s=4, restart=32, max_cycles=40, rtol=1e-8)
        assert r1.converged and r2.converged
        its.append((r1.iterations, r2.iterations, _build.launches["dia_sym"]))
    (c1, g1, n_gpu), (c2, g2, n_cpu) = its
    assert (c1, g1) == (c2, g2) and n_cpu == 0 and n_gpu > c1 + g1


def test_eig_and_spmv_demos_refuse_missing_cuda():
    from spmv_torch.demos import demo_eig, demo_spmv

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for demo in (demo_eig, demo_spmv):
        with pytest.raises(SystemExit):
            demo.main(["--lap2d", "8"])


@pytest.mark.cuda
def test_svds_on_cuda_matches_cpu(cuda):
    """Golub-Kahan on the card (vanilla DIA, A^T by transposed()): the CPU
    run's steps, singular values within 1e-12 and certificates within 1e-6,
    and exactly 2m + 1 dia_spmv launches (m of A, m + 1 of A^T)."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.svds import svds

    a = create_laplace_2d(64, 64)
    b = np.random.default_rng(3).standard_normal(a.nrows)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, local_format="dia", device=dev)
        At = A.transposed()
        _build.launches.clear()
        r = svds(A.as_linear_operator(), At.as_linear_operator(),
                 A.to_dist(b, side="row"), k=4, m=24)
        out.append((r, _build.launches["dia"]))
    (rg, ng), (rc, nc) = out
    assert rg.steps == rc.steps and ng == 2 * 24 + 1 and nc == 0
    np.testing.assert_allclose(rg.s, rc.s, rtol=1e-12)
    np.testing.assert_allclose(rg.residuals, rc.residuals, rtol=1e-6)


@pytest.mark.cuda
def test_funm_and_slq_on_cuda_match_cpu(cuda):
    """expm_multiply on symmetric DIA (m dia_sym_spmv launches) within
    1e-12 of the CPU run; SLQ with the same probes (a CPU generator) within
    1e-12 of the CPU estimate."""
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.funm import expm_multiply, slq_logdet

    a = create_laplace_2d(64, 64)
    out = []
    for dev in (cuda, torch.device("cpu")):
        A = build_dist_matrix(a, symmetric=True, local_format="dia", device=dev)
        _build.launches.clear()
        y, _ = expm_multiply(A.matvec, A.to_dist(gaussian_bump(a.nrows)), t=-1.0, m=32)
        n = _build.launches["dia_sym"]
        mean, se = slq_logdet(A.matvec, A.to_dist(np.ones(a.nrows)),
                              torch.Generator().manual_seed(5), n_probes=4, m=24)
        out.append((A.from_dist(y), n, mean, se))
    (yg, ng, mg, sg), (yc, nc, mc, sc) = out
    assert ng == 32 and nc == 0
    assert np.linalg.norm(yg - yc) <= 1e-12 * np.linalg.norm(yc)
    assert abs(mg - mc) <= 1e-12 * abs(mc) and abs(sg - sc) <= 1e-9 * sc


@pytest.mark.cuda
def test_demo_eig_lobpcg_on_cuda_matches_cpu(cuda, capsys):
    """demo_eig's LOBPCG path (fp64 DIA, dia_spmm at nrhs 4, behind the
    Chebyshev filter) on the card and on the CPU: both converged to the
    32^2 Laplacian's four smallest eigenvalues (closed form, within the
    demo's tol 1e-6 of max|theta|), within 1e-8 of each other, and the
    iterations within 15% (the slowest pair's residual crosses tol a few
    iterations apart as the Grams round on each device: 36 and 40 on the
    H100 machine)."""
    from spmv_torch.demos import demo_eig

    def run(device):
        assert demo_eig.main(["--lap2d", "32", "-k", "4", "--cheb", "16", "--device",
                              device]) == 0
        lines = capsys.readouterr().out.splitlines()
        at = next(i for i, ln in enumerate(lines) if ln.startswith("LOBPCG ("))
        return lines[at], [float(ln.split()[2]) for ln in lines[at + 1:]]

    _build.launches.clear()
    head_g, th_g = run("cuda")
    assert _build.launches["dia_spmm"] > 0
    head_c, th_c = run("cpu")
    assert "converged=True" in head_g and "converged=True" in head_c
    its_g, its_c = (int(h.split(" in ")[1].split()[0]) for h in (head_g, head_c))
    assert abs(its_g - its_c) <= 0.15 * its_c
    c = 2.0 - 2.0 * np.cos(np.arange(1, 33) * np.pi / 33)
    lam = np.sort((c[:, None] + c[None, :]).ravel())[:4]
    for th in (th_g, th_c):
        assert np.all(np.abs(np.array(th) - lam) <= 1e-6 * max(th))
    np.testing.assert_allclose(th_g, th_c, rtol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [False, True])
def test_spmv_ell_on_cuda_matches_cpu(cuda, symmetric):
    """The standalone ELL applies (gathers, no kernel) on the card equal
    the CPU's within 1e-14, the transpose too; two applies the same bits."""
    from spmv_torch.formats.ell import csr_to_ell
    from spmv_torch.gen import random_csr
    from spmv_torch.ops.spmv_ell import spmv_ell, spmv_ell_transpose

    a = random_csr(3000, 3000, 6, seed=4, symmetric=True, spd_shift=1.0)
    x = np.random.default_rng(6).standard_normal(a.nrows)
    ys = []
    for dev in (cuda, torch.device("cpu")):
        e = csr_to_ell(a, symmetric=symmetric, device=dev)
        xd = torch.as_tensor(x, device=dev)
        y = spmv_ell(e, xd, alpha=2.0, beta=-1.0, y=xd)
        assert torch.equal(y, spmv_ell(e, xd, alpha=2.0, beta=-1.0, y=xd))
        yt = None if symmetric else spmv_ell_transpose(e, xd)
        ys.append((y.cpu(), None if yt is None else yt.cpu()))
    (yg, tg), (yc, tc) = ys
    assert float((yg - yc).norm() / yc.norm()) <= 1e-14
    if not symmetric:
        assert float((tg - tc).norm() / tc.norm()) <= 1e-14


@pytest.mark.cuda
def test_apply_spans_hold_their_kernel_launches_on_the_card(cuda):
    """Under a CUDA profiler, the DIA kernels of a 256² CG solve were
    launched (their ``cuda_runtime`` events, tied by correlation id) inside
    ``spmv_torch.apply`` spans: inside a span's trace event, and inside its
    recorded ``time_ns`` interval at ``ts + baseTimeNanoseconds`` (one
    clock). The profiler may drop device records late in a long process,
    so every kernel the trace kept is checked, and at least one must be
    there. Prints the solve's host time with no profiler."""
    import tempfile
    import time

    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.cg import cg
    from spmv_torch.utils import profiling

    n = 256
    A = build_dist_matrix(create_laplace_2d(n, n), symmetric=True,
                          local_format="dia", device=cuda)
    b = A.to_dist(np.random.default_rng(0).uniform(-1.0, 1.0, n * n))
    cg(A.matvec, b, kmax=10, rtol=0.0)  # the library and the window plan
    torch.cuda.synchronize()
    profiling.record.clear()  # what earlier profiled tests left
    t0 = time.perf_counter()
    res = cg(A.matvec, b, kmax=100, rtol=0.0)
    print(f"256² CG, no profiler: {1e6 * (time.perf_counter() - t0) / 100:.1f} "
          f"µs an iteration, {len(profiling.record)} spans recorded")
    assert res.iterations == 100 and profiling.record == []

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cg(A.matvec, b, kmax=20, rtol=0.0)
        torch.cuda.synchronize()
    applies = [s for s in profiling.record if s.name == "spmv_torch.apply"]
    profiling.record.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events = trace["traceEvents"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("name") == "spmv_torch.apply")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "dia_sym_spmv" in e.get("name", "")]
    assert len(applies) == len(spans) == 21
    launched = [launch[k["args"]["correlation"]] for k in kernels
                if k["args"].get("correlation") in launch]
    assert 1 <= len(launched) <= 21
    for e in launched:
        ts = float(e["ts"])
        assert any(a <= ts <= z for a, z in spans)
        ns = base + round(ts * 1e3)
        assert any(s.start_ns <= ns <= s.end_ns for s in applies)
