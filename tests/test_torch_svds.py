"""spmv_torch's Golub-Kahan svds vs the spmv_tpu reference (mirrors of
``tests/test_svds.py``).

The same numpy-seeded dense operators go through both packages as a torch
and a jnp apply pair; the distributed case through both
``build_dist_matrix`` and ``transposed()`` (the reference on the 8-device
virtual CPU mesh). float64. The singular values, certificates and
informative steps equal the reference's (1e-12 relative; the steps
exactly), the vectors up to sign (1e-10), and each triplet its dense SVD.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.svds import svds as ref_svds

from spmv_torch.formats.csr import CSRHost
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.svds import gk_factorization, svds

REF_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(dense):
    d, dt = torch.from_numpy(dense), torch.from_numpy(np.ascontiguousarray(dense.T))
    return (lambda x: d @ x), (lambda y: dt @ y)


def _ref_ops(dense):
    d, dt = jnp.asarray(dense), jnp.asarray(dense.T)
    return (lambda x: d @ x), (lambda y: dt @ y)


def _tall(mr, nc, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((mr, nc)) * np.logspace(0, -spread, nc)[None]


def _both(dense, b0, k, m):
    """The port's and the reference's svds on the same operator and start;
    their values, certificates and steps held equal, the vectors up to
    sign. Returns the port's result."""
    r = svds(*_ops(dense), torch.from_numpy(b0), k=k, m=m)
    w = ref_svds(*_ref_ops(dense), jnp.asarray(b0), k=k, m=m)
    assert r.steps == w.steps
    np.testing.assert_allclose(r.s, w.s, rtol=REF_TOL)
    np.testing.assert_allclose(r.residuals, w.residuals, rtol=1e-6,
                               atol=REF_TOL * r.s[0])
    for got, want in ((r.u, w.u), (r.v, w.v)):
        got, want = got.numpy(), np.asarray(want)
        for i in range(len(r.s)):
            sign = np.sign(got[i] @ want[i])
            np.testing.assert_allclose(sign * got[i], want[i], atol=1e-10)
    return r


def test_svds_exact_at_full_steps():
    """m = ncols on a full-rank operator reproduces the dense SVD."""
    dense = _tall(120, 60, seed=1)
    r = _both(dense, np.random.default_rng(2).standard_normal(120), k=6, m=60)
    np.testing.assert_allclose(r.s, np.linalg.svd(dense, compute_uv=False)[:6], rtol=1e-12)
    assert r.steps == 60
    assert r.residuals.max() < 1e-10 * r.s[0]


def test_svds_certificate_equals_true_residual():
    """Unconverged: the certificate equals |A^T u_i - s_i v_i| and
    |A v_i - s_i u_i| stays at rounding level."""
    dense = _tall(120, 70, seed=3, spread=0.5)
    r = _both(dense, np.random.default_rng(4).standard_normal(120), k=4, m=10)
    for i in range(4):
        u, v = r.u[i].numpy(), r.v[i].numpy()
        np.testing.assert_allclose(r.residuals[i], np.linalg.norm(dense.T @ u - r.s[i] * v),
                                   rtol=1e-8)
        assert np.linalg.norm(dense @ v - r.s[i] * u) < 1e-10 * r.s[0]


def test_svds_top_values_converge_before_m_exhausts():
    dense = _tall(200, 120, seed=5, spread=3.0)
    r = _both(dense, np.random.default_rng(6).standard_normal(200), k=2, m=24)
    np.testing.assert_allclose(r.s[0], np.linalg.svd(dense, compute_uv=False)[0], rtol=1e-9)
    assert r.residuals[0] < 1e-8 * r.s[0]


def test_svds_ritz_vectors_orthonormal():
    dense = _tall(90, 50, seed=7)
    r = _both(dense, np.random.default_rng(8).standard_normal(90), k=5, m=30)
    U, V = r.u.numpy(), r.v.numpy()
    np.testing.assert_allclose(U @ U.T, np.eye(5), atol=1e-10)
    np.testing.assert_allclose(V @ V.T, np.eye(5), atol=1e-10)


def test_svds_breakdown_on_exact_rank():
    """Rank 5: the process breaks down at step 5 with the nonzero singular
    values exact, zero-certificate triplets, and exact zeros in alpha and
    beta from the breakdown on, as in the reference."""
    rng = np.random.default_rng(9)
    dense = (rng.standard_normal((80, 5)) * [5, 4, 3, 2, 1]) @ rng.standard_normal((5, 40))
    b0 = rng.standard_normal(80)
    r = _both(dense, b0, k=8, m=20)
    assert r.steps == 5
    np.testing.assert_allclose(r.s, np.linalg.svd(dense, compute_uv=False)[:5], rtol=1e-10)
    assert r.residuals.max() < 1e-10 * r.s[0]
    alpha, beta, cert, U, V = gk_factorization(*_ops(dense), torch.from_numpy(b0), m=20)
    assert torch.all(alpha[5:] == 0) and torch.all(beta[5:] == 0) and float(cert) == 0
    assert torch.all(U[6:] == 0) and torch.all(V[5:] == 0)


def test_svds_wide_operator():
    """Wide (nrows < ncols): b0 lives in the short row space."""
    dense = np.ascontiguousarray(_tall(110, 50, seed=11).T)
    r = _both(dense, np.random.default_rng(12).standard_normal(50), k=3, m=40)
    np.testing.assert_allclose(r.s, np.linalg.svd(dense, compute_uv=False)[:3], rtol=1e-9)
    assert r.v.shape == (3, 110)


def test_svds_zero_start_raises():
    with pytest.raises(ValueError, match="breakdown at step 0"):
        svds(*_ops(_tall(30, 20, seed=13)), torch.zeros(30, dtype=torch.float64), k=2, m=10)


def test_gk_applies_each_side_as_the_count_says():
    """2m + 1 applies: m of A and m + 1 of A^T (step 0's A^T u_1 is the
    apply the reference spends probing the column shape)."""
    dense = _tall(60, 30, seed=14)
    mv, rmv = _ops(dense)
    calls = {"A": 0, "At": 0}

    def count(name, f):
        def g(x):
            calls[name] += 1
            return f(x)
        return g

    gk_factorization(count("A", mv), count("At", rmv),
                     torch.from_numpy(np.random.default_rng(15).standard_normal(60)), m=12)
    assert calls == {"A": 12, "At": 13}


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_svds_distributed_rectangular(n_dev):
    """A tall rectangular DistMatrix (ELL, stacked shards), A^T by
    transposed(): values match the dense SVD and the reference's on its
    mesh; the triplet identity holds through the operator."""
    mr, nc = 520, 260
    rng = np.random.default_rng(20 + n_dev)
    rows, cols, vals = [], [], []
    for off in (0, 3, 17, 130, 200):
        i = np.arange(mr)
        rows.append(i)
        cols.append((i + off) % nc)
        vals.append(rng.standard_normal(mr))
    a = CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
                         mr, nc)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="ell", device="cpu")
    b = rng.standard_normal(mr)
    r = svds(A.as_linear_operator(), A.transposed().as_linear_operator(),
             A.to_dist(b, side="row"), k=3, m=48)
    np.testing.assert_allclose(r.s, np.linalg.svd(a.to_dense(), compute_uv=False)[:3],
                               rtol=1e-7)
    R = ref_build(ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols), n_devices=n_dev,
                  local_format="ell")
    w = ref_svds(R.as_linear_operator(), R.transposed().as_linear_operator(),
                 R.to_dist(b, side="row"), k=3, m=48)
    assert r.steps == w.steps
    np.testing.assert_allclose(r.s, w.s, rtol=1e-10)
    av = A.from_dist(A.matvec(r.v[0]), side="row")
    u0 = A.from_dist(r.u[0], side="row")
    np.testing.assert_allclose(av, r.s[0] * u0, rtol=1e-6, atol=1e-9)
