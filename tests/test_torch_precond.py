"""spmv_torch block Jacobi vs the spmv_tpu reference (mirrors
``tests/test_precond.py``).

The block inverses are the same float64 host inverses cast to the
operator's dtype, so one apply agrees with the reference's to the dtype's
summation-order rounding (1e-12 relative in float64). The PCG tests run the
port's own solve.
"""
import jax
import numpy as np
import pytest

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.precond import block_jacobi_preconditioner as ref_block_jacobi

import spmv_torch.gen as pt_gen
from spmv_torch.formats.csr import CSRHost
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.precond import block_jacobi_preconditioner


def scaled_spd(n_side, spread, seed=0):
    a0 = pt_gen.create_laplace_2d(n_side, n_side)
    n = a0.nrows
    w = np.logspace(-spread, spread, n)
    w = w[np.random.default_rng(seed).permutation(n)]
    rows = np.repeat(np.arange(n), a0.row_nnz())
    return CSRHost(rowptr=a0.rowptr, colind=a0.colind,
                   values=a0.values * w[rows] * w[a0.colind], ncols=n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_block_jacobi_identity_on_padding(n_dev):
    """The preconditioned solve reaches the unpreconditioned answer: block
    inverses leave padding alone."""
    a = pt_gen.create_laplace_2d(20, 20)
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    b = pt_gen.gaussian_bump(a.nrows)
    res = cg(A.as_linear_operator(), A.to_dist(b), kmax=300, rtol=1e-10,
             preconditioner=block_jacobi_preconditioner(a, A))
    assert res.converged
    assert _rel(a.matvec(A.from_dist(res.x)), b) < 1e-9


def test_block_jacobi_beats_point_jacobi():
    a = scaled_spd(32, 2.0, seed=5)
    A = build_dist_matrix(a, n_devices=4, device="cpu")
    b = pt_gen.gaussian_bump(a.nrows)
    bd = A.to_dist(b)
    blk = cg(A.as_linear_operator(), bd, kmax=3000, rtol=1e-8,
             preconditioner=block_jacobi_preconditioner(a, A))
    point = cg(A.as_linear_operator(), bd, kmax=3000, rtol=1e-8,
               preconditioner=A.jacobi_preconditioner())
    assert blk.converged
    assert _rel(a.matvec(A.from_dist(blk.x)), b) < 1e-7
    assert blk.iterations < point.iterations, (blk.iterations, point.iterations)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_block_jacobi_apply_matches_reference_nonsymmetric(n_dev):
    """A nonsymmetric diagonally dominant matrix (the reference's GMRES
    case, whose solver is not ported): one apply on a seeded residual
    equals the reference's apply to 1e-12."""
    a0 = ref_gen.random_csr(512, 512, 5, seed=9)
    dense = a0.to_dense()
    np.fill_diagonal(dense, np.abs(dense).sum(axis=1) + 1.0)
    ref = ref_csr.CSRHost.from_dense(dense)
    pt = CSRHost.from_dense(dense)
    R = ref_build(ref, n_devices=n_dev)
    A = build_dist_matrix(pt, n_devices=n_dev, device="cpu")
    r = np.random.default_rng(10).standard_normal(512)
    got = A.from_dist(block_jacobi_preconditioner(pt, A)(A.to_dist(r)))
    want = R.from_dist(jax.jit(ref_block_jacobi(ref, R))(R.to_dist(r)))
    assert _rel(got, want) < 1e-12
