"""spmv_torch block solvers (``solvers/block_cg.py``) vs the spmv_tpu
reference, on the reference tests' matrices (``tests/test_block_cg.py``,
``tests/test_spmm.py``) with the same numpy-seeded right-hand sides.

Tolerances: float64 iteration counts within 1% (summation order alone
moves them by a few), float32 inner counts within 5% per solve (fp32 CG
counts move with the dot's summation order); refinement outer passes
equal; true residuals under the reference tests' own bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.formats.dia import csr_to_dia as ref_csr_to_dia
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers import block_cg as ref_block

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch import _build
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.ops.spmm_dia import spmm_from_layout, spmm_to_layout
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.block_cg import (
    block_cg,
    block_cg_dia,
    block_cg_refined,
    block_cg_refined_dist,
)
from spmv_torch.solvers.cg import cg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launches():
    _build.launches.clear()
    yield
    # CPU tensors take the plain versions: nothing launches
    assert _build.launches["dia_spmm"] == _build.launches["dia_sym_spmm"] == 0
    assert _build.launches["well_spmm"] == _build.launches["well_ds_spmm"] == 0
    assert _build.launches["dia_ds_spmm"] == 0


def _lap(nx, ny=None):
    ny = ny or nx
    return ref_gen.create_laplace_2d(nx, ny), pt_gen.create_laplace_2d(nx, ny)


def _true_rel(a, X, B):
    R = np.stack([a.matvec(X[:, r]) for r in range(B.shape[1])], axis=1) - B
    return np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)


def _close(got: int, want: int, frac: float) -> bool:
    return abs(got - want) <= max(frac * want, 1)


@pytest.mark.parametrize("nrhs", [2, 4])
def test_block_cg_dia_matches_reference(nrhs):
    """Coupled block CG over the vanilla DIA block apply, float64
    (``test_block_cg.py:12``): every column below 1e-9."""
    ref, pt = _lap(48)
    B = np.random.default_rng(nrhs).standard_normal((pt.nrows, nrhs))
    r = ref_csr_to_dia(ref, dtype=np.float64, row_align=4096)
    Xr, rr = ref_block.block_cg_dia(r, B, kmax=800, rtol=1e-10, interpret=True)
    d = csr_to_dia(pt, dtype=np.float64, row_align=4096, device="cpu")
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-10)
    assert res.converged and bool(rr.converged)
    assert _close(res.iterations, int(rr.iterations), 0.01)
    assert np.all(_true_rel(pt, X.numpy(), B) < 1e-9)
    assert np.abs(X.numpy() - np.asarray(Xr)).max() <= 1e-8 * np.abs(np.asarray(Xr)).max()


def test_block_cg_dia_symmetric_storage_matches_reference():
    """The symmetric block apply under block CG (``test_spmm.py:136``)."""
    from spmv_torch.gen import gaussian_bump

    ref, pt = _lap(48)
    rng = np.random.default_rng(99)
    B = np.stack([gaussian_bump(pt.nrows), rng.standard_normal(pt.nrows)], axis=1)
    r = ref_csr_to_dia(ref, dtype=np.float64, row_align=4096, symmetric=True)
    _, rr = ref_block.block_cg_dia(r, B, kmax=800, rtol=1e-10, interpret=True)
    d = csr_to_dia(pt, dtype=np.float64, row_align=4096, symmetric=True, device="cpu")
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-10)
    assert res.converged and _close(res.iterations, int(rr.iterations), 0.01)
    assert np.all(_true_rel(pt, X.numpy(), B) < 1e-9)


def _dense_pair(nx=24):
    """The same dense float64 operator in both frameworks, in the SpMM lane
    layout: the solvers' recurrences compared without a kernel between."""
    _, pt = _lap(nx)
    npad = -(-pt.nrows // 128) * 128
    dense = np.zeros((npad, npad))
    dense[: pt.nrows, : pt.nrows] = pt.to_dense()

    def to_cols(v2, nrhs, xp):
        return v2.reshape(-1, nrhs, 128).transpose(1, 2).reshape(-1, nrhs) if xp is torch \
            else v2.reshape(-1, nrhs, 128).transpose(0, 2, 1).reshape(-1, nrhs)

    def pt_mm(nrhs):
        m = torch.from_numpy(dense)

        def mm(x2):
            y = m @ to_cols(x2, nrhs, torch)
            return y.reshape(-1, 128, nrhs).transpose(1, 2).reshape(x2.shape)
        return mm

    def ref_mm(nrhs):
        m = jnp.asarray(dense)

        def mm(x2):
            y = m @ to_cols(x2, nrhs, jnp)
            return y.reshape(-1, 128, nrhs).transpose(0, 2, 1).reshape(x2.shape)
        return mm

    return pt, npad, pt_mm, ref_mm


@pytest.mark.parametrize("independent", [False, True])
def test_block_cg_recurrences_match_reference(independent):
    """Coupled (O'Leary) and simultaneous (``independent=True``, the
    ``live`` freeze) recurrences on one float64 operator: the same
    iteration count within 1% and the same solution; one column starts
    converged (``test_block_cg.py:55``), which the ridge and the freeze
    must survive."""
    pt, npad, pt_mm, ref_mm = _dense_pair()
    rng = np.random.default_rng(11)
    B = np.zeros((npad, 3))
    B[: pt.nrows] = np.stack([pt.matvec(rng.standard_normal(pt.nrows)) * 1e-8,
                              rng.standard_normal(pt.nrows),
                              rng.standard_normal(pt.nrows)], axis=1)
    b2 = B.reshape(-1, 128, 3).transpose(0, 2, 1).reshape(-1, 3 * 128)
    rr = jax.jit(lambda b: ref_block.block_cg(ref_mm(3), b, 3, kmax=800, rtol=1e-9,
                                              independent=independent))(jnp.asarray(b2))
    res = block_cg(pt_mm(3), torch.from_numpy(b2.copy()), 3, kmax=800, rtol=1e-9,
                   independent=independent)
    assert res.converged and bool(rr.converged)
    assert _close(res.iterations, int(rr.iterations), 0.01)
    np.testing.assert_allclose(res.rnorm0.numpy(), np.asarray(rr.rnorm0), rtol=1e-12)
    X = spmm_from_layout(res.x, 3).numpy()[: pt.nrows]
    assert np.all(_true_rel(pt, X, B[: pt.nrows]) < 1e-8)
    Xr = np.asarray(rr.x).reshape(-1, 3, 128).transpose(0, 2, 1).reshape(-1, 3)
    assert np.abs(X - Xr[: pt.nrows]).max() <= 1e-7 * np.abs(Xr).max()


def test_block_cg_fewer_iterations_than_worst_column():
    """Sharing the Krylov block needs no more iterations than the hardest
    column alone under plain CG (``test_block_cg.py:26``)."""
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.ops.spmv_dia_cuda import spmv_dia_2d

    _, pt = _lap(32)
    d = csr_to_dia(pt, dtype=np.float64, row_align=4096, device="cpu")
    rng = np.random.default_rng(9)
    B = np.stack([gaussian_bump(pt.nrows), rng.standard_normal(pt.nrows),
                  rng.standard_normal(pt.nrows)], axis=1)
    _, res = block_cg_dia(d, B, kmax=800, rtol=1e-9)
    assert res.converged
    b2 = spmm_to_layout(d, B)
    worst = max(cg(lambda p: spmv_dia_2d(d, p), c, kmax=800, rtol=1e-9).iterations
                for c in (b2.reshape(-1, 3, 128)[:, r].contiguous() for r in range(3)))
    assert res.iterations <= worst


def test_dist_block_cg_matches_reference():
    """block_cg over DistMatrix.matmat on D=4 shards (``test_spmm.py:98``)."""
    ref, pt = _lap(20)
    B = np.random.default_rng(70).standard_normal((pt.nrows, 3))
    R = ref_build(ref, n_devices=4)
    rr = jax.jit(lambda M, b: ref_block.block_cg(M.matmat, b, 3, kmax=600, rtol=1e-10))(
        R, R.to_dist_block(B))
    P = build_dist_matrix(pt, n_devices=4, device="cpu")
    res = block_cg(P.matmat, P.to_dist_block(B), 3, kmax=600, rtol=1e-10)
    assert res.converged and _close(res.iterations, int(rr.iterations), 0.01)
    assert np.all(_true_rel(pt, P.from_dist_block(res.x), B) < 1e-9)


def _same_refinement(got, want):
    """(X, outer, inner, rnorms) of the port vs the reference's."""
    _, outer, inner, _ = got
    _, r_outer, r_inner, _ = want
    assert outer == r_outer, (outer, r_outer)
    assert _close(inner, r_inner, 0.05), (inner, r_inner)


def test_block_cg_refined_matches_reference():
    """One device, banded (``test_block_cg.py:72``): f64-class true
    residuals on every column from fp32 block CG inner passes."""
    ref, pt = _lap(48)
    B = np.random.default_rng(21).standard_normal((pt.nrows, 3))
    kw = dict(rtol=1e-11, inner_kmax=2000, inner_rtol=1e-5)
    want = ref_block.block_cg_refined(ref, B, interpret=True, **kw)
    got = block_cg_refined(pt, B, device="cpu", **kw)
    _same_refinement(got, want)
    X, _, _, rnorms = got
    assert X.dtype == np.float64 and X.shape == B.shape
    assert np.all(_true_rel(pt, X, B) < 1e-10)
    assert np.all(rnorms <= 1e-11 * np.linalg.norm(B, axis=0))


def test_block_cg_refined_dist_dia_matches_reference():
    """D = 4 stacked shards (``test_block_cg.py:117``), nrhs 4."""
    ref, pt = _lap(48)
    B = np.random.default_rng(22).standard_normal((pt.nrows, 4))
    kw = dict(rtol=1e-11, inner_rtol=1e-5, inner_kmax=800)
    want = ref_block.block_cg_refined_dist(ref, B, n_devices=4, **kw)
    got = block_cg_refined_dist(pt, B, n_devices=4, device="cpu", **kw)
    _same_refinement(got, want)
    X, _, _, rnorms = got
    assert np.all(_true_rel(pt, X, B) < 1e-9)
    assert np.all(rnorms / np.linalg.norm(B, axis=0) < 1e-9)


def _banded_random_spd(n=2000, seed=0, diag=3.0):
    """``tests/test_spmm.py:251``'s matrix, in both packages."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-170, -1, 1, 130):
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.8]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)) * 0.1)
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    i = np.concatenate([rows, cols, np.arange(n)])
    j = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, diag)])
    return (ref_csr.CSRHost.from_coo(i, j, v, n, n),
            pt_csr.CSRHost.from_coo(i, j, v, n, n))


def test_block_cg_refined_dist_well_matches_reference():
    """General sparsity through the WELL block kernels, D = 4
    (``test_spmm.py:303``): every column below 1e-12."""
    ref, pt = _banded_random_spd()
    B = np.random.default_rng(2).standard_normal((pt.nrows, 3))
    kw = dict(local_format="well", rtol=1e-12, max_outer=8)
    want = ref_block.block_cg_refined_dist(ref, B, n_devices=4, **kw)
    got = block_cg_refined_dist(pt, B, n_devices=4, device="cpu", **kw)
    _same_refinement(got, want)
    assert np.all(_true_rel(pt, got[0], B) < 1e-12)


def test_refined_solvers_refuse_what_is_not_ported():
    _, pt = _lap(8)
    B = np.ones((pt.nrows, 2))
    # inner_solver="chebyshev" is ported (tests/test_torch_chebyshev.py);
    # an unknown inner solver is refused by both
    with pytest.raises(ValueError, match="inner_solver"):
        block_cg_refined_dist(pt, B, inner_solver="gmres", device="cpu")
    with pytest.raises(ValueError, match="inner_solver"):
        block_cg_refined(pt, B, inner_solver="gmres", device="cpu")
    with pytest.raises(ValueError, match="local_format"):
        block_cg_refined_dist(pt, B, local_format="ell", device="cpu")
