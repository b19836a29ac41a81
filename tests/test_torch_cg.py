"""spmv_torch CG and the slice as a whole vs the spmv_tpu reference.

A 32² Laplacian in float64 goes through both packages' build_dist_matrix
and cg. Iteration counts must be equal; solutions and residual histories
agree to 1e-10 relative (the dots sum in another order on each side, so
the iterates drift apart by rounding only).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import spmv_tpu.gen as ref_gen
from spmv_tpu.demos import demo_cg as ref_demo
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.cg import cg as ref_cg
from spmv_tpu.solvers.cg import cg_residual_history as ref_history

import spmv_torch.gen as pt_gen
from spmv_torch.demos import demo_cg as pt_demo
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg, cg_residual_history

# (local_format, symmetric): the headline symmetric DIA path and the
# vanilla ELL path
PATHS = [("dia", True), ("ell", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_vec(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _both(n_dev, fmt, symmetric, nx=32):
    ref, pt = ref_gen.create_laplace_2d(nx, nx), pt_gen.create_laplace_2d(nx, nx)
    R = ref_build(ref, n_devices=n_dev, symmetric=symmetric, local_format=fmt,
                  dtype=np.float64)
    P = build_dist_matrix(pt, n_devices=n_dev, symmetric=symmetric,
                          local_format=fmt, dtype=np.float64, device="cpu")
    b = ref_gen.gaussian_bump(ref.nrows)
    return ref, R, P, b


@pytest.mark.parametrize("fmt,symmetric", PATHS)
@pytest.mark.parametrize("n_dev", [1, 4])
def test_cg_matches_reference(n_dev, fmt, symmetric):
    ref, R, P, b = _both(n_dev, fmt, symmetric)
    rr = jax.jit(lambda A_, bb: ref_cg(A_.as_linear_operator(), bb, kmax=1000,
                                       rtol=1e-10))(R, R.to_dist(b))
    rp = cg(P.as_linear_operator(), P.to_dist(b), kmax=1000, rtol=1e-10)
    assert bool(rr.converged) and rp.converged
    assert rp.iterations == int(rr.iterations)
    x = P.from_dist(rp.x)
    assert _rel_vec(x, R.from_dist(rr.x)) <= 1e-10
    # the reported residual is the true one, recomputed on the host
    host = np.linalg.norm(b - ref.matvec(x)) / np.linalg.norm(b)
    assert abs(host - float(rp.rnorm) / float(rp.rnorm0)) <= 1e-12


@pytest.mark.parametrize("fmt,symmetric", PATHS)
@pytest.mark.parametrize("n_dev", [1, 4])
def test_cg_residual_history_matches_reference(n_dev, fmt, symmetric):
    _, R, P, b = _both(n_dev, fmt, symmetric)
    xr, hr = jax.jit(lambda A_, bb: ref_history(A_.as_linear_operator(), bb,
                                                40))(R, R.to_dist(b))
    xp, hp = cg_residual_history(P.as_linear_operator(), P.to_dist(b), 40)
    hr = np.asarray(hr)
    assert hp.shape == (40,)
    assert np.all(np.abs(hp.numpy() - hr) <= 1e-10 * np.abs(hr))
    assert _rel_vec(P.from_dist(xp), R.from_dist(xr)) <= 1e-10


def test_pcg_jacobi_matches_reference():
    """Jacobi-preconditioned CG on a matrix with a varying diagonal."""
    ref, pt = ref_gen.create_laplace_2d(24, 24), pt_gen.create_laplace_2d(24, 24)
    scale = 1.0 + np.arange(ref.nrows) % 7
    rows = np.repeat(np.arange(ref.nrows), ref.row_nnz())
    on_diag = ref.colind == rows
    ref.values[on_diag] *= scale
    pt.values[on_diag] *= scale
    R = ref_build(ref, n_devices=4, dtype=np.float64)
    P = build_dist_matrix(pt, n_devices=4, dtype=np.float64, device="cpu")
    b = ref_gen.gaussian_bump(ref.nrows)
    rr = jax.jit(lambda A_, bb: ref_cg(
        A_.as_linear_operator(), bb, kmax=500, rtol=1e-10,
        preconditioner=A_.jacobi_preconditioner()))(R, R.to_dist(b))
    rp = cg(P.as_linear_operator(), P.to_dist(b), kmax=500, rtol=1e-10,
            preconditioner=P.jacobi_preconditioner())
    assert rp.converged and rp.iterations == int(rr.iterations)
    assert _rel_vec(P.from_dist(rp.x), R.from_dist(rr.x)) <= 1e-10


def test_cg_resume_continues_the_sequence():
    """Resuming from (r, p, rnorm0) with x0 = the saved x continues the same
    Krylov sequence: 12 + 13 iterations give the 25-iteration iterate."""
    _, _, P, b = _both(2, "dia", True)
    mv, bb = P.as_linear_operator(), P.to_dist(b)
    full = cg(mv, bb, kmax=25, rtol=0.0)
    first = cg(mv, bb, kmax=12, rtol=0.0)
    second = cg(mv, bb, x0=first.x, kmax=13, rtol=0.0,
                resume=(first.r, first.p, first.rnorm0))
    assert full.iterations == 25 and second.iterations == 13
    assert torch.equal(second.x, full.x)
    assert torch.equal(second.rnorm, full.rnorm)


def _iterations(stdout: str) -> int:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("Converged:"))
    assert line.startswith("Converged: True")
    return int(line.split(" in ")[1].split()[0])


def test_demo_cg_matches_reference_demo(capsys, monkeypatch):
    common = ["--lap2d", "48", "--dia", "--symmetric", "--devices", "2",
              "--kmax", "500"]
    assert pt_demo.main(common + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    # the reference demo parses sys.argv and may append to XLA_FLAGS;
    # both are restored after the test
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    ref_out = capsys.readouterr().out
    assert _iterations(port_out) == _iterations(ref_out)

    def value(out, key):
        return float(out.split(key)[1].split()[0])

    assert value(port_out, "r.norm = ") < 1e-8
    assert abs(value(port_out, "x.norm = ") - value(ref_out, "x.norm = ")) <= (
        1e-10 * value(ref_out, "x.norm = "))
