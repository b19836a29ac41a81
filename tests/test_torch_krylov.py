"""spmv_torch's general Krylov solvers vs the spmv_tpu reference: gmres
(plain and flexible), bicgstab, minres, lsqr and cg_pipelined.

Distributed cases: the same host CSR and right-hand side go through both
packages' build_dist_matrix and solver (the reference on the 8-device
virtual CPU mesh, under jit). Iteration counts must be equal in float64 and
within 1 in float32; solutions agree to 1e-10 (float64) and 1e-4
(float32) relative. The behaviour cases mirror the reference's tests
(``tests/test_gmres.py``, ``test_bicgstab.py``, ``test_minres.py``,
``test_lsqr.py``, ``test_cg.py``) on dense-operator matvecs, complex
systems included (complex DistMatrix storage is not ported yet). The
demo runs hold the port's ``demo_cg --solver`` against the reference
demo's printed lines.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.demos import demo_cg as ref_demo
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.bicgstab import bicgstab as ref_bicgstab
from spmv_tpu.solvers.cg import cg as ref_cg
from spmv_tpu.solvers.cg import cg_pipelined as ref_cg_pipelined
from spmv_tpu.solvers.gmres import gmres as ref_gmres
from spmv_tpu.solvers.lsqr import lsqr as ref_lsqr
from spmv_tpu.solvers.minres import minres as ref_minres

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch.demos import demo_cg as pt_demo
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.bicgstab import bicgstab
from spmv_torch.solvers.cg import cg, cg_pipelined
from spmv_torch.solvers.gmres import gmres
from spmv_torch.solvers.lsqr import lsqr
from spmv_torch.solvers.minres import minres
from test_torch_transpose import convection_diffusion_2d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _varied_diag(a, period=7):
    """a with its diagonal scaled by 1..period, so Jacobi is not a rescale."""
    rows = np.repeat(np.arange(a.nrows), a.row_nnz())
    v = a.values.copy()
    on = a.colind == rows
    v[on] *= 1.0 + rows[on] % period
    return pt_csr.CSRHost(a.rowptr, a.colind, v, a.ncols)


def _shifted(a, shift):
    """a - shift I (indefinite for a shift inside the spectrum)."""
    rows = np.repeat(np.arange(a.nrows), a.row_nnz())
    v = a.values.copy()
    v[a.colind == rows] -= shift
    return pt_csr.CSRHost(a.rowptr, a.colind, v, a.ncols)


# each case: (operator, format, symmetric storage, Jacobi or not, call); a
# call takes (solver, matvec, b, preconditioner or None, rtol), the same for
# both packages
RTOL = {np.float64: 1e-10, np.float32: 1e-5}
def _gmres_kw(flexible):
    return dict(restart=12, max_cycles=60, flexible=flexible)


CASES = {
    "gmres": (lambda: _varied_diag(convection_diffusion_2d(20)), "dia", False, True,
              lambda f, mv, b, M, rtol: f(mv, b, rtol=rtol, preconditioner=M, **_gmres_kw(False))),
    "fgmres": (lambda: _varied_diag(convection_diffusion_2d(20)), "ell", False, True,
               lambda f, mv, b, M, rtol: f(mv, b, rtol=rtol, preconditioner=M, **_gmres_kw(True))),
    "gmres-unpreconditioned": (
        lambda: convection_diffusion_2d(20), "well", False, False,
        lambda f, mv, b, M, rtol: f(mv, b, restart=30, max_cycles=20, rtol=rtol)),
    "bicgstab": (lambda: _varied_diag(convection_diffusion_2d(20)), "dia", False, True,
                 lambda f, mv, b, M, rtol: f(mv, b, kmax=400, rtol=rtol, preconditioner=M)),
    "minres-indefinite": (
        lambda: _shifted(pt_gen.create_laplace_2d(20, 20), 0.3), "dia", True, False,
        lambda f, mv, b, M, rtol: f(mv, b, kmax=800, rtol=rtol)),
    "minres-jacobi": (
        lambda: _varied_diag(pt_gen.create_laplace_2d(20, 20)), "ell", True, True,
        lambda f, mv, b, M, rtol: f(mv, b, kmax=800, rtol=rtol, preconditioner=M)),
    "cg_pipelined": (
        lambda: pt_gen.create_laplace_2d(24, 24), "dia", True, False,
        lambda f, mv, b, M, rtol: f(mv, b, kmax=800, rtol=rtol)),
    "cg_pipelined-jacobi": (
        lambda: _varied_diag(pt_gen.create_laplace_2d(24, 24)), "ell", False, True,
        lambda f, mv, b, M, rtol: f(mv, b, kmax=800, rtol=rtol, preconditioner=M)),
}
SOLVERS = {"gmres": (gmres, ref_gmres), "fgmres": (gmres, ref_gmres),
           "gmres-unpreconditioned": (gmres, ref_gmres),
           "bicgstab": (bicgstab, ref_bicgstab),
           "minres-indefinite": (minres, ref_minres), "minres-jacobi": (minres, ref_minres),
           "cg_pipelined": (cg_pipelined, ref_cg_pipelined),
           "cg_pipelined-jacobi": (cg_pipelined, ref_cg_pipelined)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_solver_matches_reference(case, dtype):
    make, fmt, symmetric, jacobi, call = CASES[case]
    port_fn, ref_fn = SOLVERS[case]
    pt = make()
    ra = ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)
    P = build_dist_matrix(pt, n_devices=2, symmetric=symmetric, dtype=dtype,
                          local_format=fmt, device="cpu")
    R = ref_build(ra, n_devices=2, symmetric=symmetric, dtype=dtype, local_format=fmt)
    b = np.random.default_rng(31).standard_normal(pt.nrows).astype(dtype)
    rr = jax.jit(lambda A_, bb: call(
        ref_fn, A_.as_linear_operator(), bb,
        A_.jacobi_preconditioner() if jacobi else None, RTOL[dtype]))(R, R.to_dist(b))
    rp = call(port_fn, P.as_linear_operator(), P.to_dist(b),
              P.jacobi_preconditioner() if jacobi else None, RTOL[dtype])
    assert bool(rr.converged) and rp.converged
    slack = 0 if dtype == np.float64 else 1
    assert abs(rp.iterations - int(rr.iterations)) <= slack
    x = P.from_dist(rp.x)
    assert _rel(x, R.from_dist(rr.x)) <= (1e-10 if dtype == np.float64 else 1e-4)
    if hasattr(rr, "cycles"):
        assert abs(rp.cycles - int(rr.cycles)) <= slack
    if case.startswith("gmres") or case in ("bicgstab", "fgmres"):
        # the reported residual is the true one
        true = np.linalg.norm(b - pt.matvec(x.astype(np.float64)))
        assert abs(float(rp.rnorm) - true) <= (1e-8 if dtype == np.float64 else 1e-3) * \
            np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", ["square", "restriction"])
def test_lsqr_matches_reference(shape, dtype):
    """LSQR with the transposed operator as rmatvec: the convection-diffusion
    system shifted by 4 I (consistent; unshifted, A^T A is conditioned so
    that both packages' rounding parts their iterates by 1e-8 within 60
    steps) and the 1-D restriction (underdetermined), at a fixed 25
    iterations (atol = btol = 0) and to convergence; the rnorm history
    follows the reference's."""
    if shape == "square":
        pt = _shifted(convection_diffusion_2d(16), -4.0)
    else:
        nf = 400
        i = np.repeat(np.arange(nf // 2), 3)
        j = 2 * i + np.tile([-1, 0, 1], nf // 2)
        ok = (j >= 0) & (j < nf)
        pt = pt_csr.CSRHost.from_coo(i[ok], j[ok], np.tile([0.25, 0.5, 0.25], nf // 2)[ok],
                                     nf // 2, nf)
    ra = ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)
    P = build_dist_matrix(pt, n_devices=2, dtype=dtype, device="cpu")
    R = ref_build(ra, n_devices=2, dtype=dtype)
    b = np.random.default_rng(41).standard_normal(pt.nrows).astype(dtype)
    Pt, Rt = P.transposed(), R.transposed()
    for kw in (dict(kmax=25, atol=0.0, btol=0.0), dict(kmax=2000, atol=1e-10, btol=1e-10)):
        rr = jax.jit(lambda A_, At_, bb: ref_lsqr(A_.matvec, At_.matvec, bb, **kw))(
            R, Rt, R.to_dist(b, side="row"))
        rp = lsqr(P.matvec, Pt.matvec, P.to_dist(b, side="row"), **kw)
        slack = 0 if dtype == np.float64 else 1
        assert rp.istop == int(rr.istop) and abs(rp.iterations - int(rr.iterations)) <= slack
        tol = 1e-10 if dtype == np.float64 else 1e-4
        assert _rel(P.from_dist(rp.x, side="col"), R.from_dist(rr.x, side="col")) <= tol
        assert abs(float(rp.rnorm) - float(rr.rnorm)) <= tol * float(rr.rnorm0)
    assert rp.history.shape == (rp.iterations,)
    assert float(rp.history[-1]) == float(rp.rnorm)
    # matvec_transpose gives the same run as the transposed operator
    bd = P.to_dist(b, side="row")
    again = lsqr(P.matvec, P.matvec_transpose, bd, kmax=25, atol=0.0, btol=0.0)
    first = lsqr(P.matvec, Pt.matvec, bd, kmax=25, atol=0.0, btol=0.0)
    assert _rel(again.history.numpy(), first.history.numpy()) <= 1e-5


def _dense_mv(dense):
    d = torch.as_tensor(dense)
    calls = []

    def mv(x):
        calls.append(1)
        return d @ x
    return mv, calls


def _nonsym_dd(n, seed, dom=1.0, k=5):
    """The reference tests' random non-symmetric diagonally dominant
    matrix (``random_csr`` pattern, dense)."""
    a = pt_gen.random_csr(n, n, k, seed=seed).to_dense()
    np.fill_diagonal(a, np.abs(a).sum(axis=1) * dom + 1.0)
    return a


def test_gmres_no_dead_applies_on_lucky_breakdown():
    """restart 100 on I + N/2, N nilpotent of index 4: the Arnoldi exits at
    the breakdown step; applies = 1 + steps + cycles, at most 10."""
    n = 120
    nil = np.zeros((n, n))
    for i in range(0, n - 3, 4):
        nil[i, i + 1] = nil[i + 1, i + 2] = nil[i + 2, i + 3] = 1.0
    dense = np.eye(n) + 0.5 * nil
    b = np.random.default_rng(41).standard_normal(n)
    mv, calls = _dense_mv(dense)
    res = gmres(mv, torch.as_tensor(b), restart=100, max_cycles=5, rtol=1e-10)
    ref = ref_gmres(lambda x: jnp.asarray(dense) @ x, jnp.asarray(b), restart=100,
                    max_cycles=5, rtol=1e-10)
    assert res.converged
    assert (res.iterations, res.cycles) == (int(ref.iterations), int(ref.cycles))
    assert len(calls) == res.iterations + res.cycles + 1 and len(calls) <= 10
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(dense, b), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("restart", [100, 7])
def test_gmres_exit_and_restarts(restart):
    """restart 100: convergence mid-cycle, no dead applies (applies =
    steps + cycles + 1); restart 7: several cycles, each making progress,
    the same counts as the reference."""
    dense = _nonsym_dd(200, seed=47, dom=3.0 if restart == 100 else 1.0)
    b = np.random.default_rng(48).standard_normal(200)
    mv, calls = _dense_mv(dense)
    res = gmres(mv, torch.as_tensor(b), restart=restart, max_cycles=60, rtol=1e-10)
    ref = ref_gmres(lambda x: jnp.asarray(dense) @ x, jnp.asarray(b), restart=restart,
                    max_cycles=60, rtol=1e-10)
    assert res.converged
    assert (res.iterations, res.cycles) == (int(ref.iterations), int(ref.cycles))
    assert len(calls) == res.iterations + res.cycles + 1
    if restart == 100:
        assert res.cycles == 1 and res.iterations < 60
    else:
        assert res.cycles > 1
        # a restarted run with a cycle's budget less does not converge
        short = gmres(mv, torch.as_tensor(b), restart=restart,
                      max_cycles=res.cycles - 1, rtol=1e-10)
        assert not short.converged and float(short.rnorm) > float(res.rnorm)
    assert _rel(res.x.numpy(), np.linalg.solve(dense, b)) <= 1e-9


@pytest.mark.parametrize("variant", ["unpreconditioned", "fixed", "variable"])
def test_fgmres(variant):
    """unpreconditioned: FGMRES is GMRES bit for bit (z_j = v_j); fixed: with
    a fixed linear M^-1 it takes the plain cycle's steps; variable: an
    inner GMRES sweep (another operator every apply) converges, with the
    reported residual the true one and under half the unpreconditioned
    steps, as in the reference's test."""
    if variant == "fixed":
        w = np.logspace(-2, 2, 240)
        dense = _nonsym_dd(240, seed=53) * w[:, None] * w[None, :]
    else:
        dense = _nonsym_dd(300 if variant == "variable" else 150,
                           seed=57, dom=0.25 if variant == "variable" else 1.0)
    n = dense.shape[0]
    b = torch.as_tensor(np.random.default_rng(58).standard_normal(n))
    mv, _ = _dense_mv(dense)
    if variant == "unpreconditioned":
        r1 = gmres(mv, b, restart=25, max_cycles=10, rtol=1e-10)
        r2 = gmres(mv, b, restart=25, max_cycles=10, rtol=1e-10, flexible=True)
        assert r1.iterations == r2.iterations and torch.equal(r1.x, r2.x)
        return
    if variant == "fixed":
        diag = torch.as_tensor(np.diag(dense).copy())
        plain = gmres(mv, b, restart=30, max_cycles=40, rtol=1e-9,
                      preconditioner=lambda r: r / diag)
        flex = gmres(mv, b, restart=30, max_cycles=40, rtol=1e-9,
                     preconditioner=lambda r: r / diag, flexible=True)
        assert flex.converged and flex.iterations == plain.iterations
        np.testing.assert_allclose(flex.x.numpy(), plain.x.numpy(), rtol=1e-6, atol=1e-8)
        return
    inner = lambda r: gmres(mv, r, restart=8, max_cycles=1, rtol=1e-3).x  # noqa: E731
    flex = gmres(mv, b, restart=20, max_cycles=15, rtol=1e-9, preconditioner=inner,
                 flexible=True)
    true = np.linalg.norm(dense @ flex.x.numpy() - b.numpy())
    assert flex.converged and true / np.linalg.norm(b.numpy()) < 1e-8
    np.testing.assert_allclose(float(flex.rnorm), true, rtol=1e-5, atol=1e-14)
    unprec = gmres(mv, b, restart=20, max_cycles=15, rtol=1e-9)
    assert flex.iterations < unprec.iterations // 2


def test_bicgstab_breakdown_returns_last_good_iterate():
    """A skew-symmetric operator breaks rho down at step 2: the result is
    the finite pre-breakdown iterate, as in the reference."""
    dense = np.array([[0.0, 1.0], [-1.0, 0.0]])
    b = np.array([1.0, 0.0])
    res = bicgstab(_dense_mv(dense)[0], torch.as_tensor(b), kmax=50, rtol=1e-12)
    ref = ref_bicgstab(lambda x: jnp.asarray(dense) @ x, jnp.asarray(b), kmax=50,
                       rtol=1e-12)
    assert res.breakdown and bool(ref.breakdown)
    assert res.iterations == int(ref.iterations)
    assert np.all(np.isfinite(res.x.numpy())) and np.isfinite(float(res.rnorm))
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(ref.x))


@pytest.mark.parametrize("solver", ["gmres", "bicgstab", "minres", "lsqr"])
def test_complex_dense_systems(solver):
    """Complex systems on dense matvecs, against numpy and the reference's
    counts: non-Hermitian for GMRES, BiCGStab and LSQR, Hermitian
    indefinite for MINRES."""
    rng = np.random.default_rng(71)
    n = 100
    dense = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) * (
        rng.random((n, n)) < 0.08)
    if solver == "minres":
        # Hermitian, indefinite: a dominant diagonal of alternating sign
        dense = dense + dense.conj().T
        np.fill_diagonal(dense, (np.abs(dense).sum(axis=1) + 2.0) * (-1.0) ** np.arange(n))
    else:
        np.fill_diagonal(dense, np.abs(dense).sum(axis=1) + 2.0)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    mv, _ = _dense_mv(dense)
    bt, bj = torch.as_tensor(b), jnp.asarray(b)
    jmv = lambda x: jnp.asarray(dense) @ x  # noqa: E731
    if solver == "gmres":
        res = gmres(mv, bt, restart=25, max_cycles=20, rtol=1e-10)
        ref = ref_gmres(jmv, bj, restart=25, max_cycles=20, rtol=1e-10)
    elif solver == "bicgstab":
        res = bicgstab(mv, bt, kmax=300, rtol=1e-10)
        ref = ref_bicgstab(jmv, bj, kmax=300, rtol=1e-10)
        assert not res.breakdown
    elif solver == "minres":
        res = minres(mv, bt, kmax=2000, rtol=1e-10)
        ref = ref_minres(jmv, bj, kmax=2000, rtol=1e-10)
    else:
        dh = torch.as_tensor(dense.conj().T.copy())
        res = lsqr(mv, lambda u: dh @ u, bt, kmax=2000, atol=1e-12, btol=1e-12)
        ref = ref_lsqr(jmv, lambda u: jnp.asarray(dense.conj().T) @ u, bj, kmax=2000,
                       atol=1e-12, btol=1e-12)
    assert res.converged and res.x.dtype == torch.complex128
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(dense, b), rtol=1e-7,
                               atol=1e-8)


def test_cg_pipelined_matches_classic():
    """Same math as cg in exact arithmetic: the count within 2 and the
    solution within 1e-8, on the reference test's 1-D operator."""
    a = pt_gen.create_laplace_1d(300)
    P = build_dist_matrix(a, n_devices=1, dtype=np.float64, device="cpu")
    b = P.to_dist(pt_gen.gaussian_bump(300))
    c = cg(P.as_linear_operator(), b, kmax=2000, rtol=1e-10)
    p = cg_pipelined(P.as_linear_operator(), b, kmax=2000, rtol=1e-10)
    assert c.converged and p.converged and abs(c.iterations - p.iterations) <= 2
    assert _rel(p.x.numpy(), c.x.numpy()) <= 1e-8


def _demo_lines(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("Converged:"))
    return (line.split()[1] == "True", int(line.split(" in ")[1].split()[0]),
            float(out.split("r.norm = ")[1].split()[0]),
            float(out.split("x.norm = ")[1].split()[0]))


def run_both_demos(common, capsys, monkeypatch):
    """The port's demo_cg (--device cpu) and the reference's (--cpu) on the
    same flags: their (converged, iterations, r.norm, x.norm). jax's backend
    starts first (8 virtual devices): the reference demo appends its own
    device count to XLA_FLAGS, which would otherwise size the backend for
    every later test in this process."""
    jax.devices()
    assert pt_demo.main(common + ["--device", "cpu"]) == 0
    port = _demo_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    return port, _demo_lines(capsys.readouterr().out)


@pytest.mark.parametrize("solver,extra", [
    ("gmres", ["--jacobi"]), ("bicgstab", ["--jacobi"]), ("minres", ["--symmetric"]),
    ("gmres", ["--amg", "--dia", "--lap2d", "64"])])
def test_demo_cg_solvers_match_reference_demo(solver, extra, capsys, monkeypatch):
    """demo_cg --solver gmres|bicgstab|minres (and AMG-preconditioned GMRES,
    at 64^2: below 3072 rows the reference's float64 AMG keeps no level and
    its coarse solve fails on the DIA operator's padding)
    against the reference demo: the same convergence and iterations (within
    1 with AMG, whose float32 levels round differently in each package, as
    the AMG tests allow), the printed residual and solution norm within
    1e-8 and 1e-10 relative (1e-9 with AMG). The
    24^2 grid keeps BiCGStab short of the 40 iterations past which its
    iterates on the symmetric Laplacian part by rounding."""
    common = ["--lap2d", "24", "--devices", "2", "--kmax", "600", "--solver", solver,
              *extra]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    amg = "--amg" in extra
    assert port[0] and ref[0] and abs(port[1] - ref[1]) <= (1 if amg else 0)
    assert abs(port[2] - ref[2]) <= 1e-8 * port[3] and port[2] < 1e-6
    assert abs(port[3] - ref[3]) <= (1e-9 if amg else 1e-10) * ref[3]


def test_cg_pipelined_fp64_counts_equal_cg_and_reference():
    """In float64 the pipelined recurrence takes cg's count, in both
    packages, on a Laplacian where cg needs over 500 iterations (200^2, b
    standard normal from seed 0, rtol 1e-6: 504 each). In float32 the
    reference's own pipelined CG takes more than its cg (2484 against 1897
    at 600^2), which is the recurrence's float32 drift, not the port's."""
    a = pt_gen.create_laplace_2d(200, 200)
    P = build_dist_matrix(a, n_devices=1, local_format="dia", device="cpu")
    R = ref_build(ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols), n_devices=1,
                  local_format="dia")
    b = np.random.default_rng(0).standard_normal(a.nrows)
    counts = [f(P.matvec, P.to_dist(b), kmax=5000, rtol=1e-6).iterations
              for f in (cg, cg_pipelined)]
    counts += [int(jax.jit(lambda A_, bb, f=f: f(A_.as_linear_operator(), bb, kmax=5000,
                                                   rtol=1e-6))(R, R.to_dist(b)).iterations)
               for f in (ref_cg, ref_cg_pipelined)]
    assert counts[0] >= 500 and len(set(counts)) == 1, counts


def test_demo_cg_still_refuses_the_s_step_group(capsys):
    """Of the reference demo's flags only --cpu (JAX's CPU backend; here
    --device cpu) is not ported; the s-step group (--sstep, --mpk,
    --newton, --deflated) runs now (tests/test_torch_sstep.py,
    test_torch_powers.py, test_torch_lobpcg.py)."""
    with pytest.raises(SystemExit):
        pt_demo.main(["--lap2d", "16", "--device", "cpu", "--cpu"])
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--mpk"], ["--newton", "8"], ["--newton", "8", "--sstep", "4"],
    ["--sstep", "4", "--amg"], ["--sstep", "4", "--spai"], ["--sstep", "4", "--fsai"],
    ["--sstep", "4", "--deflated", "2"], ["--sstep", "4", "--jacobi"],
    ["--sstep", "4", "--solver", "minres"], ["--deflated", "2", "--solver", "gmres"]])
def test_demo_cg_flag_errors_match_reference(argv, capsys, monkeypatch):
    """The s-step group's flag checks: both demos exit with argparse's
    status 2 and the same message."""
    common = ["--lap2d", "16", *argv]

    def error(run):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
        return capsys.readouterr().err.split("error: ")[-1].strip()

    jax.devices()
    port = error(lambda: pt_demo.main(common + ["--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    ref = error(ref_demo.main)
    assert port == ref and port
