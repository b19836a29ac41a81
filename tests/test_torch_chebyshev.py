"""spmv_torch Chebyshev iteration and Lanczos bounds vs the spmv_tpu
reference (mirrors ``tests/test_chebyshev.py`` and ``tests/test_lanczos.py``).

Both packages get the same seeded numpy inputs. The recurrences are the
same arithmetic in the same dtypes, so in float64 the iterates agree to
1e-10 relative (the dense products sum in another order); the float32
adaptive sweeps take the reference's control decisions, so their sweep
counts are equal. The refined block solves with the Chebyshev inner
solver are held against the reference's counts: the same outer passes,
inner applies within one sweep of 16 per pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.gen as ref_gen
import spmv_tpu.solvers.chebyshev as ref_cheb
import spmv_tpu.solvers.lanczos as ref_lanczos
from spmv_tpu.solvers.block_cg import block_cg_refined as ref_block_refined
from spmv_tpu.solvers.block_cg import block_cg_refined_dist as ref_block_refined_dist

import spmv_torch.gen as pt_gen
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.block_cg import block_cg_refined, block_cg_refined_dist
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.chebyshev import (
    chebyshev,
    chebyshev_adaptive,
    chebyshev_bounds,
    chebyshev_iterations_for,
    chebyshev_preconditioner,
)
from spmv_torch.solvers.lanczos import (
    condition_estimate,
    condition_interval,
    lanczos_extreme,
    lanczos_factorization,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(n, seed, kappa=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.geomspace(1.0, kappa, n)
    return (q * evals) @ q.T, 1.0, kappa


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ops(dense, dtype=np.float64):
    d_t = torch.as_tensor(dense.astype(dtype))
    d_j = jnp.asarray(dense.astype(dtype))
    return (lambda x: d_t @ x), (lambda x: d_j @ x)


def test_chebyshev_hits_theoretical_contraction():
    dense, lmin, lmax = _spd(300, 3)
    b = np.random.default_rng(4).standard_normal(300)
    mv, mv_ref = _ops(dense)
    iters = chebyshev_iterations_for(lmax / lmin, 1e-8)
    assert iters == ref_cheb.chebyshev_iterations_for(lmax / lmin, 1e-8)
    res = chebyshev(mv, torch.as_tensor(b), lmin, lmax, iters)
    want = np.linalg.solve(dense, b)
    assert _rel(res.x, want) < 1e-6
    assert res.iterations == iters
    ref = ref_cheb.chebyshev(mv_ref, jnp.asarray(b), lmin, lmax, iters)
    assert _rel(res.x, ref.x) < 1e-10


@pytest.mark.parametrize("x0", [False, True])
def test_chebyshev_block_shares_matmat(x0):
    """Multi-RHS: one matmat serves the whole block, every column
    converges, and a warm start takes one extra apply."""
    dense, lmin, lmax = _spd(200, 5, kappa=50.0)
    B = np.random.default_rng(6).standard_normal((200, 4))
    calls = []
    d_t = torch.as_tensor(dense)

    def mm(X):
        calls.append(X.shape)
        return d_t @ X

    iters = chebyshev_iterations_for(lmax / lmin, 1e-8)
    X0 = torch.full((200, 4), 0.5, dtype=torch.float64) if x0 else None
    res = chebyshev(mm, torch.as_tensor(B), lmin, lmax, iters, x0=X0)
    assert len(calls) == iters + (1 if x0 else 0)
    assert all(c == (200, 4) for c in calls)
    assert _rel(res.x, np.linalg.solve(dense, B)) < 1e-6
    ref = ref_cheb.chebyshev(lambda X: jnp.asarray(dense) @ X, jnp.asarray(B),
                             lmin, lmax, iters,
                             x0=None if X0 is None else jnp.asarray(X0.numpy()))
    assert _rel(res.x, ref.x) < 1e-10


def test_chebyshev_float32_steps_match_reference():
    """float32 vectors: theta/delta from the float64 bounds cast to float32,
    the step scalars in float32; the iterate agrees with the reference's to
    float32 rounding of the (differently summed) dense products."""
    dense, lmin, lmax = _spd(128, 13, kappa=30.0)
    b = np.random.default_rng(14).standard_normal(128).astype(np.float32)
    mv, mv_ref = _ops(dense, np.float32)
    got = chebyshev(mv, torch.as_tensor(b), 0.9, 31.0, 12).x
    want = ref_cheb.chebyshev(mv_ref, jnp.asarray(b), 0.9, 31.0, 12).x
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


def test_chebyshev_bounds_enclose_spectrum():
    dense, lmin, lmax = _spd(250, 7, kappa=200.0)
    mv, mv_ref = _ops(dense)
    v0 = np.random.default_rng(8).standard_normal(250)
    lo, hi = chebyshev_bounds(mv, torch.as_tensor(v0), m=80)
    assert float(hi) >= lmax * 0.999
    assert float(lo) <= lmin * 1.001
    lo_r, hi_r = ref_cheb.chebyshev_bounds(mv_ref, jnp.asarray(v0), m=80)
    assert float(hi) == pytest.approx(float(hi_r), rel=1e-8)
    assert float(lo) == pytest.approx(float(lo_r), rel=1e-6)


def test_chebyshev_adaptive_corrects_bad_floor():
    """A Lanczos floor above the clustered bottom: the adaptive variant
    measures the rate, jumps to the rate-consistent bound and converges;
    its sweeps and corrected bound are the reference's."""
    n = 2048
    rng = np.random.default_rng(0)
    ev = np.concatenate([[1e-5, 1.2e-5, 1.5e-5],
                         rng.uniform(0.3, 1.0, n - 3)]).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ev_t = torch.as_tensor(ev)
    lo_bad = 6.25e-5
    res = chebyshev_adaptive(lambda v: ev_t * v, torch.as_tensor(b), lo_bad, 1.0,
                             rtol=1e-5, sweep_iters=16, max_sweeps=400)
    rel = float(np.linalg.norm(b - ev * res.x.numpy()) / np.linalg.norm(b))
    assert rel < 2e-5, rel
    assert 1e-9 < res.lmin_final < lo_bad
    assert res.sweeps < 400 and res.iterations == res.sweeps * 16
    ev_j = jnp.asarray(ev)
    ref = ref_cheb.chebyshev_adaptive(lambda v: ev_j * v, jnp.asarray(b), lo_bad,
                                      1.0, rtol=1e-5, sweep_iters=16,
                                      max_sweeps=400)
    assert res.sweeps == int(ref.sweeps)
    # the corrected bound is a function of the measured contraction, whose
    # float32 norms sum in another order: 1e-4 relative
    assert res.lmin_final == pytest.approx(float(ref.lmin_final), rel=1e-4)


def test_chebyshev_adaptive_good_bounds_untouched():
    dense, lmin, lmax = _spd(300, 3)
    b = np.random.default_rng(4).standard_normal(300).astype(np.float32)
    mv, mv_ref = _ops(dense, np.float32)
    res = chebyshev_adaptive(mv, torch.as_tensor(b), lmin * 0.9, lmax,
                             rtol=1e-6, sweep_iters=16, max_sweeps=100)
    assert res.lmin_final == pytest.approx(lmin * 0.9, rel=1e-6)
    assert _rel(res.x, np.linalg.solve(dense, b)) < 1e-4
    ref = ref_cheb.chebyshev_adaptive(mv_ref, jnp.asarray(b), lmin * 0.9, lmax,
                                      rtol=1e-6, sweep_iters=16, max_sweeps=100)
    assert res.sweeps == int(ref.sweeps)


def test_chebyshev_preconditioner_accelerates_cg():
    dense, lmin, lmax = _spd(300, 9, kappa=2000.0)
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(300))
    mv, _ = _ops(dense)
    plain = cg(mv, b, kmax=600, rtol=1e-10)
    prec = cg(mv, b, kmax=600, rtol=1e-10,
              preconditioner=chebyshev_preconditioner(mv, lmin, lmax, degree=8))
    assert prec.converged
    assert _rel(prec.x, np.linalg.solve(dense, b.numpy())) < 1e-8
    assert prec.iterations * 2 < plain.iterations


def _block_case(nx, nrhs, seed):
    B = np.random.default_rng(seed).standard_normal((nx * nx, nrhs))
    return ref_gen.create_laplace_2d(nx, nx), pt_gen.create_laplace_2d(nx, nx), B


def _true_rel(a, X, B):
    R = np.stack([a.matvec(X[:, r]) for r in range(B.shape[1])], axis=1) - B
    return np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)


def _same_counts(got, want):
    """Same outer passes; inner applies within one sweep (16) per pass."""
    assert got[1] == want[1], (got[1:3], want[1:3])
    assert abs(got[2] - int(want[2])) <= 16 * got[1], (got[2], want[2])


def test_refined_block_chebyshev_inner_f64_class():
    """block_cg_refined(inner_solver='chebyshev'): float64-class residuals
    from reduction-free inner sweeps, the reference's counts (its Pallas
    kernels in interpret mode)."""
    ref, pt, B = _block_case(64, 3, 9)
    kw = dict(rtol=1e-11, inner_rtol=1e-4, inner_kmax=2000,
              inner_solver="chebyshev")
    got = block_cg_refined(pt, B, device="cpu", **kw)
    assert np.all(_true_rel(pt, got[0], B) < 1e-9)
    _same_counts(got, ref_block_refined(ref, B, interpret=True, **kw))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_dist_refined_chebyshev_inner(n_dev):
    ref, pt, B = _block_case(24, 2, 10)
    kw = dict(rtol=1e-11, inner_rtol=1e-4, inner_kmax=2000,
              inner_solver="chebyshev")
    got = block_cg_refined_dist(pt, B, n_devices=n_dev, device="cpu", **kw)
    assert np.all(_true_rel(pt, got[0], B) < 1e-9)
    _same_counts(got, ref_block_refined_dist(ref, B, n_devices=n_dev, **kw))


# ----- Lanczos -----

def test_lanczos_factorization_matches_reference():
    a = ref_gen.create_laplace_2d(16, 16)
    dense = a.to_dense()
    v0 = np.random.default_rng(1).standard_normal(a.nrows)
    mv, mv_ref = _ops(dense)
    al, be, basis, nrm0 = lanczos_factorization(mv, torch.as_tensor(v0), m=40)
    al_r, be_r, basis_r, nrm0_r = ref_lanczos.lanczos_factorization(
        mv_ref, jnp.asarray(v0), m=40)
    assert _rel(al, al_r) < 1e-10 and _rel(be, be_r) < 1e-10
    assert float(nrm0) == pytest.approx(float(nrm0_r), rel=1e-14)
    q = basis.numpy()[:41]
    assert np.abs(q @ q.T - np.eye(41)).max() < 1e-10


def test_extremes_match_dense_eigvals():
    a = pt_gen.create_laplace_2d(16, 16)
    dense = a.to_dense()
    want = np.linalg.eigvalsh(dense)
    v0 = torch.as_tensor(np.random.default_rng(1).standard_normal(a.nrows))
    lmin, lmax = lanczos_extreme(_ops(dense)[0], v0, m=120)
    np.testing.assert_allclose(float(lmax), want[-1], rtol=1e-8)
    np.testing.assert_allclose(float(lmin), want[0], rtol=1e-6)


def test_condition_estimate_vs_dense():
    a = pt_gen.create_laplace_2d(12, 12)
    dense = a.to_dense()
    v0 = torch.as_tensor(np.random.default_rng(2).standard_normal(a.nrows))
    got = float(condition_estimate(_ops(dense)[0], v0, m=144))
    np.testing.assert_allclose(got, np.linalg.cond(dense), rtol=1e-4)


def test_extremes_distributed_padded_operator():
    """Through a DistMatrix on 4 stacked shards: padding rows (zero in v0,
    mapped to zero) add no spurious zero eigenvalue."""
    a = pt_gen.random_csr(200, 200, 4, seed=5, symmetric=True, spd_shift=1.0)
    want = np.linalg.eigvalsh(a.to_dense())
    A = build_dist_matrix(a, n_devices=4, device="cpu")
    v0 = A.to_dist(np.random.default_rng(6).standard_normal(200))
    lmin, lmax = lanczos_extreme(A.as_linear_operator(), v0, m=150)
    np.testing.assert_allclose(float(lmax), want[-1], rtol=1e-8)
    np.testing.assert_allclose(float(lmin), want[0], rtol=1e-4)


def test_breakdown_on_invariant_subspace():
    d = np.array([1.0, 2.0, 3.0, 4.0])
    dense = np.diag(np.concatenate([d, np.full(60, 2.5)]))
    v0 = np.zeros(64)
    v0[:4] = 1.0
    lmin, lmax = lanczos_extreme(_ops(dense)[0], torch.as_tensor(v0), m=40)
    np.testing.assert_allclose(float(lmin), 1.0, rtol=1e-10)
    np.testing.assert_allclose(float(lmax), 4.0, rtol=1e-10)


def test_small_norm_operator_no_false_breakdown():
    a = pt_gen.create_laplace_2d(12, 12)
    dense = a.to_dense() * 1e-7
    want = np.linalg.eigvalsh(dense)
    v0 = torch.as_tensor(np.random.default_rng(3).standard_normal(a.nrows))
    lmin, lmax = lanczos_extreme(_ops(dense)[0], v0, m=144)
    np.testing.assert_allclose(float(lmax), want[-1], rtol=1e-6)
    np.testing.assert_allclose(float(lmin), want[0], rtol=1e-3)


def test_condition_interval_brackets_true_kappa():
    n = 300
    rng = np.random.default_rng(61)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    dense = (q * np.linspace(1.0, 50.0, n)) @ q.T
    v0 = torch.as_tensor(rng.standard_normal(n))
    lo, hi = condition_interval(_ops(dense)[0], v0, m=120)
    assert float(lo) <= 50.0 * 1.01 and 50.0 * 0.99 <= float(hi) < 500.0
    dense2 = (q * np.concatenate([[1e-4], np.linspace(1.0, 2.0, n - 1)])) @ q.T
    _, hi2 = condition_interval(_ops(dense2)[0], v0, m=6)
    assert not np.isfinite(float(hi2)) or float(hi2) > 1e3
