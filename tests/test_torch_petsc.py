"""spmv_torch's PETSc binary reader and writers vs spmv_tpu's.

Files written by the reference's writer are read by the port's reader and
files written by the port's writer by the reference's numpy reader (its
native C++ tier patched off), both ways bit for bit: whole matrices, row
slices and vector ranges, rectangular and empty-row matrices. The demo run
holds ``demo_cg --petsc --rhs`` against the reference demo on the same
files.
"""
import numpy as np
import pytest

import spmv_tpu.gen as ref_gen
from spmv_tpu.io import petsc as ref_petsc

from spmv_torch.formats.csr import CSRHost
from spmv_torch.io.petsc import (
    MAT_CLASSID,
    read_petsc_binary_matrix_host,
    read_petsc_binary_vector_host,
    write_petsc_binary_matrix,
    write_petsc_binary_vector,
)
from test_torch_krylov import run_both_demos
from test_torch_transpose import convection_diffusion_2d


@pytest.fixture(autouse=True)
def _numpy_tier_only(monkeypatch):
    """The reference reads through its numpy tier, the one carried across."""
    monkeypatch.setattr(ref_petsc, "_read_matrix_native", lambda path, rr: None)


def _same(got, want):
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for name in ("rowptr", "colind", "values"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def _matrices():
    a = ref_gen.random_csr(37, 29, 4, seed=30)
    empty_rows = CSRHost.from_coo(np.array([0, 0, 5]), np.array([1, 3, 2]),
                                  np.array([1.5, -2.0, 3.25]), 8, 6)
    return {"random rectangular": CSRHost(a.rowptr, a.colind, a.values, a.ncols),
            "empty rows": empty_rows, "convection-diffusion": convection_diffusion_2d(12)}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("case", ["random rectangular", "empty rows", "convection-diffusion"])
def test_matrix_both_directions(case, writer, tmp_path):
    a = _matrices()[case]
    path = str(tmp_path / "a.petsc")
    if writer == "reference":
        ref_petsc.write_petsc_binary_matrix(
            path, ref_petsc.CSRHost(a.rowptr, a.colind, a.values, a.ncols))
    else:
        write_petsc_binary_matrix(path, a)
    got = read_petsc_binary_matrix_host(path)
    _same(got, ref_petsc.read_petsc_binary_matrix_host(path))
    assert np.array_equal(got.to_dense(), a.to_dense())
    r1 = min(a.nrows, 7)
    _same(read_petsc_binary_matrix_host(path, row_range=(2, r1)),
          ref_petsc.read_petsc_binary_matrix_host(path, row_range=(2, r1)))
    if writer == "port":
        # the same bytes as the reference's writer
        other = str(tmp_path / "b.petsc")
        ref_petsc.write_petsc_binary_matrix(
            other, ref_petsc.CSRHost(a.rowptr, a.colind, a.values, a.ncols))
        assert open(path, "rb").read() == open(other, "rb").read()
        assert int.from_bytes(open(path, "rb").read(4), "big") == MAT_CLASSID


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_vector_both_directions(writer, tmp_path):
    x = np.random.default_rng(32).standard_normal(101)
    path = str(tmp_path / "x.petsc")
    (ref_petsc.write_petsc_binary_vector if writer == "reference"
     else write_petsc_binary_vector)(path, x)
    for rng in (None, (7, 55), (0, 0)):
        got = read_petsc_binary_vector_host(path, index_range=rng)
        assert np.array_equal(got, ref_petsc.read_petsc_binary_vector_host(path, rng))
    assert np.array_equal(read_petsc_binary_vector_host(path), x)


def test_malformed_files_raise(tmp_path):
    bad = str(tmp_path / "bad.petsc")
    np.array([123, 4, 4, 0], dtype=">i4").tofile(bad)
    with pytest.raises(ValueError, match="not a PETSc"):
        read_petsc_binary_matrix_host(bad)
    with pytest.raises(ValueError, match="not a PETSc"):
        read_petsc_binary_vector_host(bad)
    short = str(tmp_path / "short.petsc")
    np.array([MAT_CLASSID, 4, 4, 10, 1, 1], dtype=">i4").tofile(short)
    with pytest.raises(ValueError, match="truncated"):
        read_petsc_binary_matrix_host(short)
    good = str(tmp_path / "x.petsc")
    write_petsc_binary_vector(good, np.ones(5))
    with pytest.raises(ValueError, match="bad index_range"):
        read_petsc_binary_vector_host(good, index_range=(3, 9))


def test_demo_cg_petsc_rhs_matches_reference_demo(tmp_path, capsys, monkeypatch):
    """demo_cg --petsc A --rhs b (files of the port's writers; the
    non-symmetric convection-diffusion operator) --solver bicgstab against
    the reference demo on the same files."""
    a = convection_diffusion_2d(24)
    mat, rhs = str(tmp_path / "a.petsc"), str(tmp_path / "b.petsc")
    write_petsc_binary_matrix(mat, a)
    write_petsc_binary_vector(rhs, np.random.default_rng(3).standard_normal(a.nrows))
    common = ["--petsc", mat, "--rhs", rhs, "--devices", "2", "--kmax", "400",
              "--solver", "bicgstab", "--dia"]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    assert port[0] and port[:2] == ref[:2]
    assert abs(port[2] - ref[2]) <= 1e-8 * port[3] and port[2] < 1e-6
    assert abs(port[3] - ref[3]) <= 1e-10 * ref[3]
