"""spmv_torch's LOBPCG and deflated CG vs the spmv_tpu reference (mirrors of
``tests/test_lobpcg.py`` and ``tests/test_deflation.py``), and
``demo_cg --deflated`` against the reference demo.

The same numpy-seeded inputs go through both packages: dense operators as
a torch and a jnp apply, distributed ones through both
``build_dist_matrix`` (the reference on the 8-device virtual CPU mesh).
Tolerances: eigenvalues equal the reference's to 1e-8 relative where both
converge (LOBPCG's small eigenproblems run in another order of float64
sums); float64 deflated-CG counts equal the reference's and solutions
agree to 1e-8; float32 counts within 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.chebyshev import chebyshev_preconditioner as ref_cheb_prec
from spmv_tpu.solvers.deflation import cg_deflated as ref_cg_deflated
from spmv_tpu.solvers.lanczos import lanczos_extreme as ref_lanczos_extreme
from spmv_tpu.solvers.lobpcg import lane_block_ops as ref_lane_block_ops
from spmv_tpu.solvers.lobpcg import lobpcg as ref_lobpcg

from spmv_torch.gen import create_laplace_2d
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.chebyshev import chebyshev_preconditioner
from spmv_torch.solvers.deflation import cg_deflated
from spmv_torch.solvers.fsai import fsai_setup
from spmv_torch.solvers.lanczos import lanczos_extreme
from spmv_torch.solvers.lobpcg import lane_block_ops, lobpcg
from test_torch_krylov import run_both_demos


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _ref_csr(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


def rotated_spectrum(n, lam, seed):
    """A dense symmetric matrix with a prescribed spectrum, Q diag(lam) Q^T."""
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    return (Q * lam) @ Q.T


def _both_lobpcg(dense, X0, **kw):
    dt, dj = torch.as_tensor(dense), jnp.asarray(dense)
    return (lobpcg(lambda X: dt @ X, torch.as_tensor(X0), **kw),
            ref_lobpcg(lambda X: dj @ X, jnp.asarray(X0), **kw))


# ------------------------------------------------------------------ LOBPCG

def test_lobpcg_smallest_matches_dense_eigh():
    n = 120
    lam = np.concatenate([[1.0, 2.0, 3.5, 5.0], np.linspace(10, 100, n - 4)])
    dense = rotated_spectrum(n, lam, seed=1)
    X0 = np.random.default_rng(1).standard_normal((n, 4))
    res, ref = _both_lobpcg(dense, X0, maxiter=400, tol=1e-10)
    assert res.converged and bool(ref.converged), res.resid_norms
    np.testing.assert_allclose(res.eigenvalues, np.sort(lam)[:4], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(res.eigenvalues, np.asarray(ref.eigenvalues), rtol=1e-9)
    assert abs(res.iterations - int(ref.iterations)) <= 2
    X = res.X.numpy()
    for j in range(4):
        assert np.linalg.norm(dense @ X[:, j] - res.eigenvalues[j] * X[:, j]) < 1e-7


def test_lobpcg_largest():
    n = 90
    lam = np.concatenate([np.linspace(1, 50, n - 3), [80.0, 90.0, 100.0]])
    dense = rotated_spectrum(n, lam, seed=2)
    X0 = np.random.default_rng(2).standard_normal((n, 3))
    res, ref = _both_lobpcg(dense, X0, maxiter=400, tol=1e-10, largest=True)
    assert res.converged, res.resid_norms
    np.testing.assert_allclose(np.sort(res.eigenvalues), np.sort(lam)[-3:], rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(res.eigenvalues, np.asarray(ref.eigenvalues), rtol=1e-9)


def test_lobpcg_indefinite_smallest():
    """The most negative eigenpairs of an indefinite operator: the masked
    directions' sentinels sit past the spectrum on both sides."""
    n = 100
    lam = np.concatenate([[-8.0, -3.0, -1.0], np.linspace(0.5, 40, n - 3)])
    dense = rotated_spectrum(n, lam, seed=3)
    X0 = np.random.default_rng(3).standard_normal((n, 3))
    res, ref = _both_lobpcg(dense, X0, maxiter=400, tol=1e-10)
    assert res.converged, res.resid_norms
    np.testing.assert_allclose(res.eigenvalues, np.sort(lam)[:3], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res.eigenvalues, np.asarray(ref.eigenvalues), rtol=1e-9)


def test_lobpcg_preconditioner_accelerates():
    """An A^-1-like preconditioner cuts the iterations on a stiff spectrum,
    as in the reference's run; the answers are unchanged."""
    n = 150
    lam = np.concatenate([[1.0, 1.5], np.linspace(50, 5000, n - 2)])
    dense = rotated_spectrum(n, lam, seed=4)
    shift_inv = np.linalg.inv(dense + 0.5 * np.eye(n))
    X0 = np.random.default_rng(4).standard_normal((n, 2))
    plain, _ = _both_lobpcg(dense, X0, maxiter=600, tol=1e-8)
    st, sj = torch.as_tensor(shift_inv), jnp.asarray(shift_inv)
    dt = torch.as_tensor(dense)
    prec = lobpcg(lambda X: dt @ X, torch.as_tensor(X0), maxiter=600, tol=1e-8,
                  preconditioner=lambda R: st @ R)
    ref = ref_lobpcg(lambda X: jnp.asarray(dense) @ X, jnp.asarray(X0), maxiter=600,
                     tol=1e-8, preconditioner=lambda R: sj @ R)
    assert prec.converged, prec.resid_norms
    np.testing.assert_allclose(prec.eigenvalues, np.sort(lam)[:2], rtol=1e-7)
    assert prec.iterations < plain.iterations
    assert abs(prec.iterations - int(ref.iterations)) <= 2


@pytest.mark.parametrize("n_dev", [1, 4])
def test_lobpcg_distributed_lane_layout(n_dev):
    """Over DistMatrix.matmat in the SpMM lane layout: the dense oracle's
    eigenvalues and the reference's on the mesh."""
    a = create_laplace_2d(16, 16)
    n = a.nrows
    dense = a.to_dense()
    want = np.linalg.eigvalsh(dense)[:2]
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    R = ref_build(_ref_csr(a), n_devices=n_dev)
    X0 = np.random.default_rng(5).standard_normal((n, 2))
    res = lobpcg(A.matmat, A.to_dist_block(X0), k=2, maxiter=800, tol=1e-7,
                 block_ops=lane_block_ops())
    ref = jax.jit(lambda M, X: ref_lobpcg(M.matmat, X, k=2, maxiter=800, tol=1e-7,
                                          block_ops=ref_lane_block_ops()))(
        R, R.to_dist_block(X0))
    assert res.converged, res.resid_norms
    np.testing.assert_allclose(res.eigenvalues, want, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.eigenvalues, np.asarray(ref.eigenvalues), rtol=1e-8)
    X = A.from_dist_block(res.X)
    for j in range(2):
        assert np.linalg.norm(dense @ X[:, j] - res.eigenvalues[j] * X[:, j]) < 1e-5


def test_lobpcg_chebyshev_filter_converges_where_plain_stalls():
    """The Chebyshev spectral filter on the Laplacian's clustered bottom:
    plain LOBPCG stalls within the budget, the filtered run converges to
    the oracle (DIA operator, so the block applies run dia_spmm's plain
    version here and the kernel on the card)."""
    a = create_laplace_2d(32, 32)
    n = a.nrows
    want = np.linalg.eigvalsh(a.to_dense())[:2]
    A = build_dist_matrix(a, n_devices=4, local_format="dia", device="cpu")
    X0 = A.to_dist_block(np.random.default_rng(7).standard_normal((n, 2)))
    _, lmax_d = lanczos_extreme(A.as_linear_operator(), A.to_dist(np.ones(n)), m=32)
    lmax = float(lmax_d) * 1.05
    deg = 12
    lo = (2.0 / deg) ** 2 * lmax

    def run(filtered):
        pre = chebyshev_preconditioner(A.matmat, lo, lmax, degree=deg) if filtered else None
        return lobpcg(A.matmat, X0, k=2, maxiter=120, tol=1e-7, preconditioner=pre,
                      block_ops=lane_block_ops())

    plain, filt = run(False), run(True)
    assert not plain.converged
    assert filt.converged, filt.resid_norms
    np.testing.assert_allclose(filt.eigenvalues, want, rtol=1e-8, atol=1e-10)


def test_lobpcg_needs_k_with_custom_block_ops():
    with pytest.raises(ValueError, match="k must be given"):
        lobpcg(lambda X: X, torch.ones(256, 128, dtype=torch.float64),
               block_ops=lane_block_ops())


# ----------------------------------------------------------- deflated CG

def _lap_setup(g=32, d=8, seed=0):
    a = create_laplace_2d(g, g)
    dense = a.to_dense()
    w, V = np.linalg.eigh(dense)
    W = V[:, :d].T.copy()
    b = np.random.default_rng(seed).standard_normal(a.nrows)
    return a, dense, w, W, b


def _both_deflated(dense, b, W, dtype=np.float64, **kw):
    """cg_deflated of both packages on one dense operator, b and W; a
    ``preconditioner`` keyword is a dense matrix applied as M @ r."""
    pm = kw.pop("preconditioner", None)
    x0 = kw.pop("x0", None)
    dt, dj = torch.as_tensor(dense.astype(dtype)), jnp.asarray(dense.astype(dtype))
    pkw = dict(kw, x0=None if x0 is None else torch.as_tensor(x0.astype(dtype)),
               preconditioner=None if pm is None else (
                   lambda r, m=torch.as_tensor(pm.astype(dtype)): m @ r))
    rkw = dict(kw, x0=None if x0 is None else jnp.asarray(x0.astype(dtype)),
               preconditioner=None if pm is None else (
                   lambda r, m=jnp.asarray(pm.astype(dtype)): m @ r))
    p = cg_deflated(lambda x: dt @ x, torch.as_tensor(b.astype(dtype)),
                    torch.as_tensor(W.astype(dtype)), **pkw)
    r = ref_cg_deflated(lambda x: dj @ x, jnp.asarray(b.astype(dtype)),
                        jnp.asarray(W.astype(dtype)), **rkw)
    return p, r


def _true(dense, x, b):
    return np.linalg.norm(dense @ np.asarray(x, np.float64) - b) / np.linalg.norm(b)


def test_deflation_reduces_iterations():
    """Deflating the 8 bottom eigenvectors: under 0.8x plain CG's count,
    the reference's count and solution."""
    _a, dense, _w, W, b = _lap_setup()
    plain = cg(lambda x, d=torch.as_tensor(dense): d @ x, torch.as_tensor(b), kmax=600,
               rtol=1e-10)
    p, r = _both_deflated(dense, b, W, kmax=600, rtol=1e-10)
    assert p.converged and _true(dense, p.x.numpy(), b) < 1e-9
    assert p.iterations < 0.8 * plain.iterations
    assert p.iterations == int(r.iterations) and _rel(p.x.numpy(), np.asarray(r.x)) < 1e-8


def test_deflation_keeps_residual_w_orthogonal():
    _a, _dense, _w, W, b = _lap_setup(d=6)
    p, _r = _both_deflated(_dense, b, W, kmax=600, rtol=1e-10)
    assert np.abs(W @ p.r.numpy()).max() < 1e-12 * float(p.rnorm0)


def test_deflation_depends_only_on_span():
    """A mixed, non-orthonormal basis of the same span: the same path."""
    _a, dense, _w, W, b = _lap_setup(d=5, seed=3)
    Cm = np.random.default_rng(4).standard_normal((5, 5)) + 3 * np.eye(5)
    p1, r1 = _both_deflated(dense, b, W, kmax=600, rtol=1e-10)
    p2, _r2 = _both_deflated(dense, b, Cm @ W, kmax=600, rtol=1e-10)
    assert p1.iterations == p2.iterations == int(r1.iterations)
    np.testing.assert_allclose(p1.x.numpy(), p2.x.numpy(), rtol=1e-8, atol=1e-10)


def test_deflation_rank_deficient_basis_degrades_gracefully():
    _a, dense, _w, W, b = _lap_setup(d=4, seed=5)
    p, r = _both_deflated(dense, b, np.concatenate([W, W[:2]]), kmax=600, rtol=1e-10)
    assert p.converged and np.all(np.isfinite(p.x.numpy()))
    assert _true(dense, p.x.numpy(), b) < 1e-9
    assert abs(p.iterations - int(r.iterations)) <= 1


def test_deflation_composes_with_preconditioner():
    """FSAI plus deflation of the preconditioned operator's slow modes beats
    FSAI alone, in the reference's count."""
    a, dense, _w, _W, b = _lap_setup(g=32, seed=7)
    gd = fsai_setup(a).to_dense()
    _wp, Vp = np.linalg.eigh(gd @ dense @ gd.T)
    W = (gd.T @ Vp[:, :6]).T.copy()
    M = gd.T @ gd
    mt, dt = torch.as_tensor(M), torch.as_tensor(dense)
    base = cg(lambda x: dt @ x, torch.as_tensor(b), kmax=600, rtol=1e-10,
              preconditioner=lambda r: mt @ r)
    p, r = _both_deflated(dense, b, W, kmax=600, rtol=1e-10, preconditioner=M)
    assert p.converged and _true(dense, p.x.numpy(), b) < 1e-9
    assert p.iterations < base.iterations and p.iterations == int(r.iterations)


def test_deflation_nonzero_x0():
    """rtol is relative to the residual of x0 before the correction."""
    _a, dense, _w, W, b = _lap_setup(d=4, seed=9)
    x0 = np.random.default_rng(10).standard_normal(b.shape[0])
    p, r = _both_deflated(dense, b, W, x0=x0, kmax=600, rtol=1e-10)
    assert p.converged and p.iterations == int(r.iterations)
    np.testing.assert_allclose(float(p.rnorm0), np.linalg.norm(b - dense @ x0), rtol=1e-12)
    assert _true(dense, p.x.numpy(), b) < 1e-9


def test_deflation_fp32_inexact_basis_stable():
    """float32 with an approximate basis (3e-3 perturbed): stable through
    the per-iteration Galerkin correction, fewer iterations than CG, within
    2 of the reference's count."""
    a = create_laplace_2d(48, 48)
    dense = a.to_dense()
    n = a.nrows
    _w, V = np.linalg.eigh(dense)
    rng = np.random.default_rng(21)
    W = V[:, :6].T + 3e-3 * rng.standard_normal((6, n))
    b = rng.standard_normal(n)
    p, r = _both_deflated(dense, b, W, dtype=np.float32, kmax=800, rtol=1e-6)
    d32 = torch.as_tensor(dense.astype(np.float32))
    plain = cg(lambda x: d32 @ x, torch.as_tensor(b.astype(np.float32)), kmax=800, rtol=1e-6)
    assert p.converged and _true(dense, p.x.numpy(), b) < 1e-5
    assert p.iterations < plain.iterations and abs(p.iterations - int(r.iterations)) <= 2


def test_deflation_empty_basis_raises():
    _a, dense, _w, _W, b = _lap_setup()
    with pytest.raises(ValueError, match="empty deflation basis"):
        cg_deflated(lambda x: x, torch.as_tensor(b), torch.zeros((0, b.shape[0]),
                                                                 dtype=torch.float64))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_deflation_distributed(n_dev):
    """W rows in the operator's padded layout: fewer iterations than plain
    CG, the host solve, and the reference's count on the mesh."""
    a = create_laplace_2d(24, 24)
    dense = a.to_dense()
    n = a.nrows
    _w, V = np.linalg.eigh(dense)
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    R = ref_build(_ref_csr(a), n_devices=n_dev)
    W = torch.stack([A.to_dist(np.ascontiguousarray(V[:, i])) for i in range(6)])
    Wr = jnp.stack([R.to_dist(np.ascontiguousarray(V[:, i])) for i in range(6)])
    b = np.random.default_rng(11 + n_dev).standard_normal(n)
    res = cg_deflated(A.as_linear_operator(), A.to_dist(b), W, kmax=600, rtol=1e-10)
    ref = jax.jit(lambda A_, v, Wb: ref_cg_deflated(A_.as_linear_operator(), v, Wb, kmax=600,
                                                    rtol=1e-10))(R, R.to_dist(b), Wr)
    assert res.converged and res.iterations == int(ref.iterations)
    x = A.from_dist(res.x, side="col")
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9
    plain = cg(A.as_linear_operator(), A.to_dist(b), kmax=600, rtol=1e-10)
    assert res.iterations < 0.85 * plain.iterations


def test_deflation_basis_from_lobpcg_like_the_demo():
    """demo_cg --deflated's set-up on a symmetric DIA operator: the
    Lanczos bound, the filtered LOBPCG (the reference's eigenvalues to
    1e-4, its iterations within 2), the basis as the block layout's
    columns, and deflated CG in fewer iterations than CG."""
    from spmv_torch.demos.demo_cg import deflation_basis

    a = create_laplace_2d(48, 48)
    n, d = a.nrows, 3
    A = build_dist_matrix(a, symmetric=True, local_format="dia", device="cpu")
    R = ref_build(_ref_csr(a), symmetric=True, local_format="dia")
    W, eig = deflation_basis(A, d, np.float64)
    assert eig.iterations <= 100
    assert W.shape == (d,) + tuple(A.to_dist(np.ones(n)).shape)
    _, lmax_d = ref_lanczos_extreme(R.as_linear_operator(), R.to_dist(np.ones(n)), m=32)
    lmax = float(lmax_d) * 1.05
    X0 = np.random.default_rng(0).standard_normal((n, d))
    ref = jax.jit(lambda A_, X: ref_lobpcg(
        A_.matmat, X, k=d, maxiter=100, tol=1e-3,
        preconditioner=ref_cheb_prec(A_.matmat, (2.0 / 16) ** 2 * lmax, lmax, degree=16),
        block_ops=ref_lane_block_ops()))(R, R.to_dist_block(X0))
    Wr = np.stack([R.from_dist(ref.X[:, j * 128:(j + 1) * 128]) for j in range(d)])
    # the same subspace: the port's basis lies in the reference's span
    Wp = np.stack([A.from_dist(w) for w in W])
    Qr, _ = np.linalg.qr(Wr.T)
    assert np.linalg.norm(Wp.T - Qr @ (Qr.T @ Wp.T)) / np.linalg.norm(Wp) < 1e-4
    b = A.to_dist(np.random.default_rng(1).standard_normal(n))
    defl = cg_deflated(A.as_linear_operator(), b, W, kmax=2000, rtol=1e-8)
    plain = cg(A.as_linear_operator(), b, kmax=2000, rtol=1e-8)
    assert defl.converged and defl.iterations < plain.iterations


@pytest.mark.parametrize("extra", [["--symmetric", "--dia"], ["--fp32", "--dia", "--symmetric"],
                                   ["--devices", "2", "--jacobi"]])
def test_demo_cg_deflated_matches_reference_demo(extra, capsys, monkeypatch):
    """demo_cg --deflated 4 against the reference demo: the same
    convergence and iterations (float32: within 2); the printed residuals
    within 1e-8 (float32: 1e-6) of the solution norm, since LOBPCG's
    loose tolerance (1e-3) carries each package's rounding into the basis;
    the solution norms within 1e-10 (float32: 1e-5) relative."""
    common = ["--lap2d", "32", "--kmax", "2000", "--rtol", "1e-6", "--deflated", "4", *extra]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    fp32 = "--fp32" in extra
    assert port[0] and ref[0] and abs(port[1] - ref[1]) <= (2 if fp32 else 0)
    assert abs(port[2] - ref[2]) <= (1e-6 if fp32 else 1e-8) * ref[3]
    assert abs(port[3] - ref[3]) <= (1e-5 if fp32 else 1e-10) * ref[3]
