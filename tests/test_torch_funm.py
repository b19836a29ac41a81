"""spmv_torch's Lanczos matrix functions and SLQ vs the spmv_tpu reference
(mirrors of ``tests/test_funm.py``).

The same numpy-seeded operators and vectors go through both packages:
dense operators as a torch and a jnp apply, distributed ones through both
``build_dist_matrix`` (the reference on the 8-device virtual CPU mesh).
float64 throughout. f(A) v agrees with the reference's to 1e-12 relative
(the tridiagonal eigh runs in numpy here, in XLA there). The SLQ probes
come from a ``torch.Generator`` in the port and from ``jax.random`` in the
reference, so their estimates differ by Monte-Carlo noise: the per-probe
quadrature is held equal on the reference's own probe (1e-12), the
estimates each within their error bars of the exact value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers import funm as ref_funm
from spmv_tpu.solvers.lanczos import lanczos_factorization as ref_lanczos_factorization

from spmv_torch.gen import create_laplace_2d
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.funm import (
    expm_multiply,
    funm_multiply,
    inv_sqrt_multiply,
    rademacher_probe,
    slq_logdet,
    slq_quadrature,
    slq_trace,
    sqrt_multiply,
)

REF_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _setup(g=20, seed=0):
    a = create_laplace_2d(g, g)
    dense = a.to_dense()
    w, V = np.linalg.eigh(dense)
    b = np.random.default_rng(seed).standard_normal(a.nrows)
    td, jd = torch.from_numpy(dense), jnp.asarray(dense)
    return dense, w, V, b, (lambda x: td @ x), (lambda x: jd @ x)


def _f_dense(w, V, b, f):
    return V @ (f(w) * (V.T @ b))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("t", [-1.0, -0.1, 0.5])
def test_expm_multiply_matches_dense_and_reference(t):
    _dense, w, V, b, mv, ref_mv = _setup()
    y, est = expm_multiply(mv, torch.from_numpy(b), t=t, m=48)
    want = _f_dense(w, V, b, lambda x: np.exp(t * x))
    assert _rel(y.numpy(), want) < 1e-12
    assert est < 1e-10 * np.linalg.norm(want)
    ry, rest = ref_funm.expm_multiply(ref_mv, jnp.asarray(b), t=t, m=48)
    assert _rel(y.numpy(), np.asarray(ry)) < REF_TOL
    assert abs(est - float(rest)) <= 1e-6 * np.linalg.norm(want)


def test_inv_sqrt_multiply():
    """A^{-1/2} b vs dense and the reference; A^{-1/2}(A^{-1/2} b) = A^{-1} b."""
    dense, w, V, b, mv, ref_mv = _setup(seed=1)
    y, _ = inv_sqrt_multiply(mv, torch.from_numpy(b), m=64)
    want = _f_dense(w, V, b, lambda x: x ** -0.5)
    assert _rel(y.numpy(), want) < 1e-8
    ry, _ = ref_funm.inv_sqrt_multiply(ref_mv, jnp.asarray(b), m=64)
    assert _rel(y.numpy(), np.asarray(ry)) < REF_TOL
    y2, _ = inv_sqrt_multiply(mv, y, m=64)
    assert _rel(y2.numpy(), np.linalg.solve(dense, b)) < 1e-8


def test_sqrt_multiply_squares_back():
    """A^{1/2}(A^{1/2} b) = A b to rounding, and A^{1/2} b equals the
    reference's."""
    dense, _w, _V, b, mv, ref_mv = _setup(seed=2)
    y, _ = sqrt_multiply(mv, torch.from_numpy(b), m=64)
    ry, _ = ref_funm.sqrt_multiply(ref_mv, jnp.asarray(b), m=64)
    assert _rel(y.numpy(), np.asarray(ry)) < REF_TOL
    y2, _ = sqrt_multiply(mv, y, m=64)
    assert _rel(y2.numpy(), dense @ b) < 1e-9


def test_funm_identity_is_matvec():
    """f(x) = x reproduces A b essentially exactly at any m >= 2."""
    dense, _w, _V, b, mv, ref_mv = _setup(seed=3)
    y, _est = funm_multiply(mv, torch.from_numpy(b), lambda th: th, m=8)
    assert _rel(y.numpy(), dense @ b) < 1e-12
    ry, _ = ref_funm.funm_multiply(ref_mv, jnp.asarray(b), lambda th: th, m=8)
    assert _rel(y.numpy(), np.asarray(ry)) < REF_TOL


def test_funm_error_estimate_tracks_convergence():
    """err_est decreases as m grows, certifies a small true error once
    small, and follows the reference's estimate."""
    _dense, w, V, b, mv, ref_mv = _setup(seed=4)
    want = _f_dense(w, V, b, lambda x: np.exp(-x))
    errs, ests = [], []
    for m in (6, 12, 24, 48):
        y, est = expm_multiply(mv, torch.from_numpy(b), t=-1.0, m=m)
        errs.append(np.linalg.norm(y.numpy() - want))
        ests.append(est)
        _ry, rest = ref_funm.expm_multiply(ref_mv, jnp.asarray(b), t=-1.0, m=m)
        # equal to 1e-6 of the estimate, or both at the rounding floor
        assert abs(est - float(rest)) <= 1e-6 * float(rest) + 1e-13 * np.linalg.norm(want)
    assert ests[-1] < ests[0]
    assert errs[-1] < 1e-10 * np.linalg.norm(want)
    assert errs[1] < 100 * max(ests[1], 1e-300)


def test_funm_identity_operator_breakdown():
    """A = c*I breaks down at step 1 and still returns exp(t c) b exactly:
    dead Lanczos steps must not pollute f(T)."""
    c = 0.7
    b = np.random.default_rng(5).standard_normal(64)
    y, est = expm_multiply(lambda x: c * x, torch.from_numpy(b), t=2.0, m=16)
    np.testing.assert_allclose(y.numpy(), np.exp(2.0 * c) * b, rtol=1e-12)
    assert est < 1e-12


def test_funm_keeps_shape_dtype_and_device():
    """The counterpart of the reference's jit test: the result has v0's
    (lane-layout) shape and dtype and equals the dense propagator."""
    _dense, w, V, b, mv, _ref_mv = _setup(seed=6)
    v0 = torch.from_numpy(b.reshape(4, 100))
    y, _ = expm_multiply(lambda x: mv(x.reshape(-1)).reshape(x.shape), v0, t=-0.5, m=32)
    assert y.shape == v0.shape and y.dtype == v0.dtype and y.device == v0.device
    want = _f_dense(w, V, b, lambda x: np.exp(-0.5 * x))
    assert _rel(y.numpy().ravel(), want) < 1e-11


def test_slq_quadrature_equals_reference_formula_on_its_probe():
    """The per-probe quadrature on the reference's own Rademacher probe
    equals the reference's formula computed with its own
    lanczos_factorization on the same z."""
    dense, _w, _V, _b, mv, ref_mv = _setup(g=16)
    n = dense.shape[0]
    z = jax.random.rademacher(jax.random.PRNGKey(7), (n,), dtype=jnp.float64)
    alphas, betas, _basis, nrm0 = ref_lanczos_factorization(ref_mv, z, 24)
    t = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    evals, evecs = jnp.linalg.eigh(t)
    for f_np, f_jnp in ((np.log, jnp.log), (lambda th: th, lambda th: th)):
        want = float(nrm0 ** 2 * jnp.sum(evecs[0, :] ** 2 * f_jnp(evals)))
        got = slq_quadrature(mv, torch.from_numpy(np.array(z)), f_np, m=24)
        assert abs(got - want) <= REF_TOL * abs(want)


def test_slq_logdet_within_error_bars():
    """SLQ log-det lands within 4 standard errors of the exact slogdet and
    the bar is itself sane (< 3% of the value); so does the reference's,
    whose probes differ."""
    a = create_laplace_2d(24, 24)
    dense = a.to_dense()
    want = np.linalg.slogdet(dense)[1]
    td = torch.from_numpy(dense)
    mean, se = slq_logdet(lambda x: td @ x, torch.ones(a.nrows, dtype=torch.float64),
                          _gen(0), n_probes=24, m=40)
    assert abs(mean - want) < 4 * se and se < 0.03 * abs(want)
    rmean, rse = ref_funm.slq_logdet(lambda x: jnp.asarray(dense) @ x, jnp.ones(a.nrows),
                                     jax.random.PRNGKey(0), n_probes=24, m=40)
    assert abs(float(rmean) - want) < 5 * float(rse)
    assert abs(mean - float(rmean)) < 4 * np.hypot(se, float(rse))


def test_slq_trace_identity_function():
    """f = id: the estimator targets tr(A) (Hutchinson through exact
    quadrature)."""
    a = create_laplace_2d(20, 20)
    td = torch.from_numpy(a.to_dense())
    mean, se = slq_trace(lambda x: td @ x, lambda th: th,
                         torch.ones(a.nrows, dtype=torch.float64), _gen(1), n_probes=24, m=32)
    assert abs(mean - np.trace(a.to_dense())) < 4 * max(se, 1e-12)


def test_slq_exact_on_diagonal_operator():
    """Diagonal A with four distinct eigenvalues: every Rademacher probe
    gives the exact trace and the quadrature is exact once m exceeds four,
    so the variance is exactly zero, as in the reference."""
    d = torch.from_numpy(np.repeat([1.0, 2.0, 3.0, 4.0], 16))
    mean, se = slq_trace(lambda x: d * x, lambda th: th ** 2,
                         torch.ones(64, dtype=torch.float64), _gen(2), n_probes=4, m=8)
    np.testing.assert_allclose(mean, float((d ** 2).sum()), rtol=1e-10)
    assert se < 1e-10


def test_slq_respects_padding_support():
    """Zero entries of the template never receive probe mass: the estimate
    equals the one on the dense subproblem."""
    d = np.arange(1.0, 33.0)
    dpad = torch.from_numpy(np.concatenate([d, np.zeros(8)]))
    tmpl = (dpad != 0).to(torch.float64)
    z = rademacher_probe(tmpl, _gen(3))
    assert torch.all(z[32:] == 0) and torch.all(z[:32].abs() == 1)
    mean, _se = slq_trace(lambda x: dpad * x, lambda th: th, tmpl, _gen(3),
                          n_probes=8, m=40)
    np.testing.assert_allclose(mean, d.sum(), rtol=1e-9)


def _ref_csr(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_slq_logdet_distributed(n_dev):
    """SLQ through a DistMatrix with its shards stacked, probes on the
    padded lane layout's true support: within 4 sigma of the exact log det,
    and each probe's quadrature equal to the reference's on its mesh
    operator for the same probe."""
    a = create_laplace_2d(16, 16)
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    tmpl = A.to_dist(np.ones(a.nrows))
    mean, se = slq_logdet(A.as_linear_operator(), tmpl, _gen(4), n_probes=20, m=40)
    want = np.linalg.slogdet(a.to_dense())[1]
    assert abs(mean - want) < 4 * se
    R = ref_build(_ref_csr(a), n_devices=n_dev)
    z_host = np.random.default_rng(n_dev).choice([-1.0, 1.0], a.nrows)
    got = slq_quadrature(A.as_linear_operator(), A.to_dist(z_host), np.log, m=40)
    zr = R.to_dist(z_host)
    alphas, betas, _basis, nrm0 = ref_lanczos_factorization(R.as_linear_operator(), zr, 40)
    t = np.diag(np.asarray(alphas)) + np.diag(np.asarray(betas)[:-1], 1) + np.diag(
        np.asarray(betas)[:-1], -1)
    ev, evec = np.linalg.eigh(t)
    want_q = float(nrm0) ** 2 * np.sum(evec[0] ** 2 * np.log(ev))
    assert abs(got - want_q) <= REF_TOL * abs(want_q)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_funm_distributed(n_dev):
    """Heat propagation exp(-t A) b through a DistMatrix matches the host
    dense propagator and the reference's on its mesh."""
    a = create_laplace_2d(16, 16)
    dense = a.to_dense()
    w, V = np.linalg.eigh(dense)
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    b = np.random.default_rng(7 + n_dev).standard_normal(a.nrows)
    y, _ = expm_multiply(A.as_linear_operator(), A.to_dist(b), t=-0.8, m=48)
    got = A.from_dist(y, side="col")
    np.testing.assert_allclose(got, _f_dense(w, V, b, lambda x: np.exp(-0.8 * x)),
                               rtol=1e-9, atol=1e-11)
    R = ref_build(_ref_csr(a), n_devices=n_dev)
    ry, _ = jax.jit(lambda M, v: ref_funm.expm_multiply(
        M.as_linear_operator(), v, t=-0.8, m=48))(R, R.to_dist(b))
    assert _rel(got, R.from_dist(ry, side="col")) < REF_TOL
