"""spmv_torch's scipy.sparse and torch.sparse bridges vs the spmv_tpu
reference (mirrors of ``tests/test_interop.py``, with torch sparse COO and
CSR tensors in place of BCOO/BCSR).

Round trips are exact and canonical (sorted columns, summed duplicates),
and ``from_scipy`` gives the reference's CSRHost bit for bit. One
deviation, shown here: the port's ``from_scipy`` copies the caller's
matrix, where the reference's aliases its arrays and canonicalizes it in
place.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_tpu.interop import from_scipy as ref_from_scipy

from spmv_torch.gen import random_csr
from spmv_torch.interop import from_scipy, from_torch_sparse, to_scipy, to_torch_sparse
from spmv_torch.parallel.dist_matrix import build_dist_matrix


def _rand(n=37, m=29, seed=0):
    return random_csr(n, m, 4, seed=seed)


def _same(b, a):
    np.testing.assert_array_equal(b.rowptr, a.rowptr)
    np.testing.assert_array_equal(b.colind, a.colind)
    np.testing.assert_array_equal(b.values, a.values)
    assert b.ncols == a.ncols


def test_scipy_round_trip_exact():
    a = _rand()
    s = to_scipy(a)
    assert s.shape == a.shape
    b = from_scipy(s)
    _same(b, a)
    _same(b, ref_from_scipy(s.copy()))


@pytest.mark.parametrize("conv", ["tocoo", "tocsc", "tolil", "todia"])
def test_from_scipy_any_container(conv):
    a = _rand(seed=3)
    s = getattr(to_scipy(a), conv)()
    b = from_scipy(s)
    np.testing.assert_array_equal(b.colind, a.colind)
    np.testing.assert_array_equal(b.values, a.values)
    _same(b, ref_from_scipy(getattr(to_scipy(a), conv)()))


def test_from_scipy_sums_duplicates_and_sorts():
    coo = sp.coo_array((np.array([1.0, 2.0, 4.0, 8.0]),
                        (np.array([1, 0, 1, 1]), np.array([2, 1, 0, 2]))), shape=(3, 4))
    b = from_scipy(coo)
    assert b.nnz == 3
    np.testing.assert_array_equal(b.rowptr, [0, 1, 3, 3])
    np.testing.assert_array_equal(b.colind, [1, 0, 2])
    np.testing.assert_array_equal(b.values, [2.0, 4.0, 9.0])
    np.testing.assert_allclose(b.matvec(np.arange(4.0)), coo @ np.arange(4.0))


def test_from_scipy_rejects_non_sparse():
    with pytest.raises(TypeError):
        from_scipy(np.eye(3))


def test_from_scipy_leaves_the_callers_matrix_alone():
    """The caller's CSR (unsorted, with a duplicate) is unchanged after the
    bridge and shares no buffer with the result; the reference's bridge
    canonicalizes it in place and aliases it (the deviation)."""
    data, indices, indptr = np.array([1.0, 2.0, 4.0]), np.array([2, 0, 2]), np.array([0, 3, 3])

    def caller():
        return sp.csr_array((data.copy(), indices.copy(), indptr.copy()), shape=(2, 3))

    m = caller()
    b = from_scipy(m)
    np.testing.assert_array_equal(m.data, data)
    np.testing.assert_array_equal(m.indices, indices)
    np.testing.assert_array_equal(m.indptr, indptr)
    for ours in (b.values, b.colind, b.rowptr):
        for theirs in (m.data, m.indices, m.indptr):
            assert not np.shares_memory(ours, theirs)
    np.testing.assert_array_equal(b.values, [2.0, 5.0])
    r = caller()
    ref_from_scipy(r)
    assert r.nnz == 2 and not np.array_equal(r.indices[: len(indices)], indices)


@pytest.mark.parametrize("layout", [torch.sparse_coo, torch.sparse_csr])
def test_torch_sparse_round_trip_exact(layout):
    a = _rand(seed=5)
    t = to_torch_sparse(a, layout=layout, device="cpu")
    assert t.shape == a.shape and t.layout == layout
    if layout == torch.sparse_coo:
        assert t.is_coalesced()
    x = np.linspace(-1, 1, a.ncols)
    np.testing.assert_allclose((t @ torch.from_numpy(x)).numpy(), a.matvec(x), rtol=1e-12)
    _same(from_torch_sparse(t), a)


def test_from_torch_sparse_sums_duplicates_drops_padding():
    """Duplicate (0, 1) entries plus an out-of-range padded entry."""
    idx = torch.tensor([[0, 0, 2, 3], [1, 1, 0, 2]])
    t = torch.sparse_coo_tensor(idx, torch.tensor([1.5, 2.5, 7.0, 99.0]), (3, 2),
                                check_invariants=False)
    b = from_torch_sparse(t)
    assert b.shape == (3, 2) and b.nnz == 2
    np.testing.assert_allclose(b.to_dense(), [[0.0, 4.0], [0.0, 0.0], [7.0, 0.0]])


@pytest.mark.parametrize("layout", ["coo", "csr", "hybrid"])
def test_from_torch_sparse_rejects_batched(layout):
    dense = torch.arange(1.0, 25.0).reshape(2, 3, 4)
    t = {"coo": lambda: dense.to_sparse(), "csr": lambda: dense.to_sparse_csr(),
         "hybrid": lambda: dense.to_sparse(2)}[layout]()
    with pytest.raises(ValueError, match="n_batch"):
        from_torch_sparse(t)
    with pytest.raises(TypeError):
        from_torch_sparse(dense)


def test_torch_csr_accepted():
    a = _rand(seed=9)
    b = from_torch_sparse(torch.from_numpy(a.to_dense()).to_sparse_csr())
    np.testing.assert_allclose(b.to_dense(), a.to_dense())


def test_interop_to_dist_matrix_end_to_end():
    """scipy matrix in, distributed matvec out."""
    a = _rand(n=64, m=64, seed=11)
    A = build_dist_matrix(from_scipy(to_scipy(a)), n_devices=4, device="cpu")
    x = np.linspace(-1, 1, 64)
    np.testing.assert_allclose(A.from_dist(A.matvec(A.to_dist(x))), a.matvec(x), rtol=1e-12)


def test_scipy_complex_round_trip():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((9, 9)) + 1j * rng.standard_normal((9, 9))
    d[np.abs(d.real) < 0.8] = 0
    s = sp.csr_array(d)
    b = from_scipy(s)
    assert b.dtype == np.complex128
    np.testing.assert_allclose(b.to_dense(), s.todense())
    np.testing.assert_allclose(to_scipy(b).todense(), s.todense())
    x = rng.standard_normal(9) + 1j * rng.standard_normal(9)
    np.testing.assert_allclose(b.matvec(x), s @ x)
