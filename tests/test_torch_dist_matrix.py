"""spmv_torch DistMatrix vs the spmv_tpu reference.

The port stacks every shard on one torch device; the reference runs the
same shards on the 8-device virtual CPU mesh. Assembly must give the
reference's arrays exactly (plan tables, DIA data, ELL blocks, diagonals);
matvec must agree to the dtype tolerance (relative max-abs 1e-13 in
float64, 2e-6 in float32: same products, summation order may differ).
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.parallel.dist_matrix import build_dist_matrix

TOL = {np.float32: 2e-6, np.float64: 1e-13}
N_DEVICES = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _pair(nx=20, ny=24):
    return ref_gen.create_laplace_2d(nx, ny), pt_gen.create_laplace_2d(nx, ny)


def _both(n_dev, fmt, symmetric, dtype=np.float64, pair=None):
    ref, pt = pair or _pair()
    R = ref_build(ref, n_devices=n_dev, symmetric=symmetric, local_format=fmt,
                  dtype=dtype)
    P = build_dist_matrix(pt, n_devices=n_dev, symmetric=symmetric,
                          local_format=fmt, dtype=dtype, device="cpu")
    return ref, R, P


def _ref_matvec(R, x_host):
    y = jax.jit(lambda A_, v: A_.matvec(v))(R, R.to_dist(x_host))
    return R.from_dist(y)


def _same(port_tensor, ref_array):
    got = port_tensor.numpy()
    want = np.asarray(ref_array)
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("n_dev", N_DEVICES)
def test_assembly_matches_reference(n_dev, fmt, symmetric):
    _, R, P = _both(n_dev, fmt, symmetric)
    assert P.plan.rounds == R.plan.rounds
    assert P.n_devices == R.n_devices == n_dev
    assert (P.plan.nlocal_pad, P.plan.nghost_pad, P.row_pad) == (
        R.plan.nlocal_pad, R.plan.nghost_pad, R.row_pad)
    for name in ("send_idx", "recv_pos", "nlocal", "nghosts"):
        assert _same(getattr(P.plan, name), getattr(R.plan, name)), name
    assert _same(P.remote_colind, R.remote_colind)
    assert _same(P.remote_values, R.remote_values)
    assert _same(P.jacobi_diag, R.jacobi_diag)
    if fmt == "dia":
        assert P.dia_offsets == R.dia_offsets
        assert _same(P.local_dia_data, R.local_dia_data)
        assert P.local_colind is None and P.local_values is None
    else:
        assert _same(P.local_colind, R.local_colind)
        assert _same(P.local_values, R.local_values)
    if symmetric:
        assert _same(P.diagonal, R.diagonal)
    else:
        assert P.diagonal is None and R.diagonal is None
    assert P.nnz_global == R.nnz_global


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("n_dev", N_DEVICES)
def test_matvec_matches_reference(n_dev, fmt, symmetric, dtype):
    ref, R, P = _both(n_dev, fmt, symmetric, dtype)
    x = np.random.default_rng(n_dev).standard_normal(ref.nrows).astype(dtype)
    y = P.matvec(P.to_dist(x))
    assert y.dtype == P.dtype and tuple(y.shape) == (n_dev * P.row_pad // 128, 128)
    got = P.from_dist(y)
    assert got.dtype == np.dtype(dtype)
    assert _rel(got, _ref_matvec(R, x)) <= TOL[dtype]
    assert _rel(got, ref.matvec(x.astype(np.float64))) <= 10 * TOL[dtype]


@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("n_dev", [3, 5])
def test_random_banded_odd_shard_counts(n_dev, fmt):
    """Nonsymmetric banded matrix with odd offsets on odd shard counts: the
    plan has several rounds and uneven shards."""
    rng = np.random.default_rng(40 + n_dev)
    n = 700
    dense = np.zeros((n, n))
    for off in (-131, -37, -1, 0, 2, 5, 150):
        dense += np.diag(rng.standard_normal(n - abs(off)), off)
    pair = (ref_csr.CSRHost.from_dense(dense), pt_csr.CSRHost.from_dense(dense))
    ref, R, P = _both(n_dev, fmt, False, pair=pair)
    assert P.plan.rounds == R.plan.rounds and len(P.plan.rounds) >= 1
    x = rng.standard_normal(n)
    got = P.from_dist(P.matvec(P.to_dist(x)))
    assert _rel(got, _ref_matvec(R, x)) <= TOL[np.float64]
    assert _rel(got, dense @ x) <= 10 * TOL[np.float64]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_non_canonical_csr_is_summed_and_sorted(fmt, symmetric):
    """A CSR with unsorted columns and duplicate entries, built directly,
    assembles as its canonical form: duplicates sum."""
    ref, pt = _pair(12, 10)
    rng = np.random.default_rng(17)
    rowptr, cols, vals = [0], [], []
    for i in range(pt.nrows):
        lo, hi = pt.rowptr[i], pt.rowptr[i + 1]
        c, v = pt.colind[lo:hi], pt.values[lo:hi]
        # split every entry into two halves, in reversed column order
        c2 = np.concatenate([c, c])[::-1]
        v2 = np.concatenate([v / 2, v / 2])[::-1]
        cols.append(c2)
        vals.append(v2)
        rowptr.append(rowptr[-1] + len(c2))
    messy = pt_csr.CSRHost(np.array(rowptr), np.concatenate(cols),
                           np.concatenate(vals), pt.ncols)
    A = build_dist_matrix(messy, n_devices=3, symmetric=symmetric,
                          local_format=fmt, dtype=np.float64, device="cpu")
    B = build_dist_matrix(pt, n_devices=3, symmetric=symmetric,
                          local_format=fmt, dtype=np.float64, device="cpu")
    x = rng.standard_normal(pt.nrows)
    assert torch.equal(A.matvec(A.to_dist(x)), B.matvec(B.to_dist(x)))
    assert _rel(A.from_dist(A.matvec(A.to_dist(x))), ref.matvec(x)) <= 1e-13


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_from_numpy_matches_own_assembly(fmt, symmetric):
    """A DistMatrix carried across from the reference's fields applies
    exactly like the port's own assembly."""
    ref, R, P = _both(4, fmt, symmetric)
    names = ["remote_colind", "remote_values", "jacobi_diag", "diagonal"]
    names += ["local_dia_data"] if fmt == "dia" else ["local_colind", "local_values"]
    arrays = {k: np.asarray(getattr(R, k)) for k in names
              if getattr(R, k) is not None}
    arrays.update({k: np.asarray(getattr(R.plan, k))
                   for k in ("send_idx", "recv_pos", "nlocal", "nghosts")})
    meta = dict(nrows_global=R.nrows_global, ncols_global=R.ncols_global,
                row_pad=R.row_pad, symmetric=R.symmetric,
                nnz_global=R.nnz_global, local_format=R.local_format,
                dia_offsets=R.dia_offsets, rounds=R.plan.rounds,
                n_devices=R.n_devices, nlocal_pad=R.plan.nlocal_pad,
                nghost_pad=R.plan.nghost_pad)
    C = dist_matrix_from_numpy(arrays, meta, device="cpu")
    x = P.to_dist(np.random.default_rng(9).standard_normal(ref.nrows))
    assert torch.equal(C.matvec(x), P.matvec(x))


def test_jacobi_preconditioner_matches_reference():
    ref, R, P = _both(4, "ell", False)
    r = np.random.default_rng(2).standard_normal(ref.nrows)
    got = P.from_dist(P.jacobi_preconditioner()(P.to_dist(r)))
    want = R.from_dist(R.jacobi_preconditioner()(R.to_dist(r)))
    assert np.array_equal(got, want)


def test_unported_options_raise():
    _, pt = _pair()
    with pytest.raises(ValueError, match="ROADMAP"):
        build_dist_matrix(pt, local_format="well_ds", device="cpu")
    # a hub row: the reference's degree-skew decision would split it out
    rows = np.concatenate([np.arange(400), np.zeros(200, np.int64)])
    cols = np.concatenate([np.arange(400), np.arange(1, 201)])
    hub = pt_csr.CSRHost.from_coo(rows, cols, np.ones(600), 400, 400)
    with pytest.raises(NotImplementedError, match="hub"):
        build_dist_matrix(hub, n_devices=2, device="cpu")
    # hub_cap=None keeps every row in the row-uniform format
    A = build_dist_matrix(hub, n_devices=2, hub_cap=None, device="cpu")
    x = np.random.default_rng(0).standard_normal(400)
    assert _rel(A.from_dist(A.matvec(A.to_dist(x))), hub.matvec(x)) <= 1e-13
    with pytest.raises(ValueError, match="hub_cap"):
        build_dist_matrix(pt, hub_cap=8, device="cpu")


def test_dia_diagonal_limit_is_the_kernels():
    # 65 distinct diagonals: one more than the DIA kernels take
    n = 200
    offs = np.arange(-32, 33)
    rows = np.concatenate([np.arange(max(0, -o), min(n, n - o)) for o in offs])
    cols = np.concatenate([np.arange(max(0, -o), min(n, n - o)) + o for o in offs])
    wide = pt_csr.CSRHost.from_coo(rows, cols, np.ones(len(rows)), n, n)
    with pytest.raises(ValueError, match="64, the DIA kernels' limit"):
        build_dist_matrix(wide, local_format="dia", device="cpu")
    build_dist_matrix(wide, local_format="ell", device="cpu")
