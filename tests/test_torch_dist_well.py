"""spmv_torch DistMatrix with WELL local blocks, the automatic format
choice and the general-sparsity path as a whole vs the spmv_tpu reference.

The port stacks every shard on one torch device; the reference runs the
same shards on the 8-device virtual CPU mesh, its WELL Pallas kernel in
interpret mode. Assembly must give the reference's stacked arrays exactly;
matvec agrees to relative max-abs 1e-13 in float64 and 2e-6 in float32.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import spmv_tpu.corpus as ref_corpus
import spmv_tpu.reorder as ref_reorder
from spmv_tpu.demos import demo_cg as ref_demo
from spmv_tpu.gen import gaussian_bump
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.parallel.dist_matrix import select_local_format as ref_select
from spmv_tpu.solvers.cg import cg as ref_cg

import spmv_torch.corpus as pt_corpus
import spmv_torch.reorder as pt_reorder
from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.demos import demo_cg as pt_demo
from spmv_torch.io.matrix_market import write_matrix_market
from spmv_torch.parallel.dist_matrix import build_dist_matrix, select_local_format
from spmv_torch.solvers.cg import cg

TOL = {np.float32: 2e-6, np.float64: 1e-13}
WELL_FIELDS = ("local_well_values", "local_well_pos", "local_well_w0",
               "far_rows", "far_cols", "far_vals", "local_wellT_values",
               "local_wellT_pos", "local_wellT_w0", "farT_rows", "farT_cols",
               "farT_vals")


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


def _fem(n=2000, seed=0):
    """An RCM'd FEM operator, from both packages."""
    ref, _ = ref_reorder.rcm_reorder(ref_corpus.fem_p1_2d(n, seed=seed),
                                     native=False, keep_best=True)
    pt, _ = pt_reorder.rcm_reorder(pt_corpus.fem_p1_2d(n, seed=seed),
                                   keep_best=True)
    return ref, pt


def _circuit():
    """A circuit network: a grid plus random long-range resistors, which
    the shards see as ghosts."""
    return (ref_corpus.circuit_network(70, extra_frac=0.05, seed=2),
            pt_corpus.circuit_network(70, extra_frac=0.05, seed=2))


def _long_range(n=80_000, pairs=300, seed=3):
    """A symmetric tridiagonal operator plus entries joining the first and
    the last rows: columns further apart than the 512-segment window, so a
    single shard's window split leaves a far remainder."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pi = rng.integers(0, 5000, pairs)
    pj = rng.integers(n - 5000, n, pairs)
    rows = np.concatenate([i, i[1:], i[:-1], pi, pj])
    cols = np.concatenate([i, i[:-1], i[1:], pj, pi])
    vals = np.concatenate([np.full(n, 4.0), np.full(2 * (n - 1), -1.0),
                           np.full(2 * pairs, -0.5)])
    return (ref_corpus.CSRHost.from_coo(rows, cols, vals, n, n),
            pt_corpus.CSRHost.from_coo(rows, cols, vals, n, n))


def _both(pair, n_dev, symmetric, dtype, fmt="well"):
    ref, pt = pair
    R = ref_build(ref, n_devices=n_dev, symmetric=symmetric, dtype=dtype,
                  local_format=fmt)
    P = build_dist_matrix(pt, n_devices=n_dev, symmetric=symmetric, dtype=dtype,
                          local_format=fmt, device="cpu")
    return ref, R, P


def _ref_matvec(R, x_host):
    y = jax.jit(lambda A_, v: A_.matvec(v))(R, R.to_dist(x_host))
    return R.from_dist(y)


def _same(port_tensor, ref_array):
    got = port_tensor.numpy()
    want = np.asarray(ref_array)
    return got.shape == want.shape and np.array_equal(got, want)


def _assert_same_assembly(R, P):
    assert P.local_format == R.local_format == "well"
    assert (P.row_pad, P.plan.nlocal_pad, P.plan.nghost_pad, P.plan.rounds) == (
        R.row_pad, R.plan.nlocal_pad, R.plan.nghost_pad, R.plan.rounds)
    assert tuple(P.well_meta) == tuple(R.well_meta)
    assert tuple(P.wellT_meta) == tuple(R.wellT_meta)
    assert (P.well_far_nnz, P.well_farT_nnz) == (R.well_far_nnz, R.well_farT_nnz)
    for name in WELL_FIELDS + ("remote_colind", "remote_values", "jacobi_diag",
                               "diagonal"):
        got, want = getattr(P, name), getattr(R, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert _same(got, want), name
    assert P.local_colind is None and P.local_values is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_well_matches_reference(n_dev, symmetric, dtype):
    ref, R, P = _both(_fem(), n_dev, symmetric, dtype)
    _assert_same_assembly(R, P)
    x = np.random.default_rng(n_dev).standard_normal(ref.nrows).astype(dtype)
    y = P.matvec(P.to_dist(x))
    assert y.dtype == P.dtype and tuple(y.shape) == (n_dev * P.row_pad // 128, 128)
    got = P.from_dist(y)
    assert _rel(got, _ref_matvec(R, x)) <= TOL[dtype]
    assert _rel(got, ref.matvec(x.astype(np.float64))) <= 10 * TOL[dtype]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("case,n_dev", [("long_range", 1), ("circuit", 4)])
def test_well_far_and_ghosts_match_reference(case, n_dev, symmetric):
    pair = _long_range() if case == "long_range" else _circuit()
    ref, R, P = _both(pair, n_dev, symmetric, np.float64)
    _assert_same_assembly(R, P)
    if case == "long_range":
        assert P.well_far_nnz + P.well_farT_nnz > 0
    else:
        assert P.plan.nghost_pad > 0
    x = np.random.default_rng(7).standard_normal(ref.nrows)
    got = P.from_dist(P.matvec(P.to_dist(x)))
    assert _rel(got, _ref_matvec(R, x)) <= TOL[np.float64]
    assert _rel(got, ref.matvec(x)) <= 10 * TOL[np.float64]


CHOICES = [
    ("fem_p1_2d", {"n_nodes": 3000}, True),
    ("fem_p1_3d", {"n_nodes": 1500}, True),
    ("powerlaw_laplacian", {"n": 3000, "m": 4}, False),
    ("circuit_network", {"nx": 50}, True),
    ("aniso_laplace_2d", {"nx": 40}, False),
    ("stencil27_3d", {"nx": 10}, False),
]


@pytest.mark.parametrize("name,kw,reorder", CHOICES, ids=[c[0] for c in CHOICES])
def test_select_local_format_matches_reference(name, kw, reorder):
    ref = getattr(ref_corpus, name)(**kw)
    pt = getattr(pt_corpus, name)(**kw)
    if reorder:
        ref, _ = ref_reorder.rcm_reorder(ref, native=False, keep_best=True)
        pt, _ = pt_reorder.rcm_reorder(pt, keep_best=True)
    for symmetric in (False, True):
        for dtype in (np.float32, np.float64):
            got = select_local_format(pt, symmetric=symmetric, dtype=dtype)
            assert got == ref_select(ref, symmetric=symmetric, dtype=dtype), (
                symmetric, dtype)


def test_auto_picks_well_for_fem_and_raises_for_float64():
    ref, pt = _fem()
    P = build_dist_matrix(pt, symmetric=True, dtype=np.float32,
                          local_format="auto", device="cpu")
    R = ref_build(ref, symmetric=True, dtype=np.float32, local_format="auto",
                  n_devices=1)
    assert P.local_format == R.local_format == "well"
    _assert_same_assembly(R, P)
    # for float64 the reference picks a double-single format, and so does
    # the port (held against the reference in test_torch_dist_ds.py)
    assert select_local_format(pt, symmetric=True, dtype=np.float64) == "well_ds"
    D = build_dist_matrix(pt, symmetric=True, dtype=np.float64,
                          local_format="auto", device="cpu")
    assert D.local_format == "well_ds" and D.local_wellT_values_lo is not None
    lap = pt_corpus.aniso_laplace_2d(30)
    assert select_local_format(lap, dtype=np.float64) == "dia_ds"
    L = build_dist_matrix(lap, dtype=np.float64, local_format="auto",
                          device="cpu")
    assert L.local_format == "dia_ds" and L.local_dia_data_lo is not None
    x = np.random.default_rng(4).standard_normal(lap.nrows)
    y = L.from_dist(L.matvec(L.to_dist(x)))
    assert _rel(y, lap.matvec(x)) <= TOL[np.float64]
    assert P.format_size_bytes() > 0
    assert D.format_size_bytes() > 0


@pytest.mark.parametrize("symmetric", [True, False])
def test_cg_iterations_match_reference(symmetric):
    """Jacobi-preconditioned fp64 CG on a 3000-node RCM'd FEM (the port's
    general-sparsity main path at test size). Counts agree within 1%: on
    this ill-conditioned operator fp64 rounding alone (another summation
    order, another shard count) moves the count by a few iterations."""
    ref, R, P = _both(_fem(3000), 2, symmetric, np.float64)
    b = gaussian_bump(ref.nrows)
    rr = jax.jit(lambda A_, bb: ref_cg(
        A_.as_linear_operator(), bb, kmax=3000, rtol=1e-6,
        preconditioner=A_.jacobi_preconditioner()))(R, R.to_dist(b))
    rp = cg(P.as_linear_operator(), P.to_dist(b), kmax=3000, rtol=1e-6,
            preconditioner=P.jacobi_preconditioner())
    assert bool(rr.converged) and rp.converged
    assert abs(rp.iterations - int(rr.iterations)) <= 0.01 * int(rr.iterations)
    x = P.from_dist(rp.x)
    assert np.linalg.norm(x - R.from_dist(rr.x)) <= 1e-6 * np.linalg.norm(x)
    host = np.linalg.norm(b - ref.matvec(x)) / np.linalg.norm(b)
    assert abs(host - float(rp.rnorm) / float(rp.rnorm0)) <= 1e-8


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("case,n_dev", [("long_range", 1), ("circuit", 4)])
def test_from_numpy_matches_own_assembly(case, n_dev, symmetric):
    """A DistMatrix(local_format="well") carried across from the reference's
    fields applies exactly like the port's own assembly."""
    pair = _long_range() if case == "long_range" else _circuit()
    ref, R, P = _both(pair, n_dev, symmetric, np.float64)
    names = ("remote_colind", "remote_values", "jacobi_diag", "diagonal") + WELL_FIELDS
    arrays = {k: np.asarray(getattr(R, k)) for k in names
              if getattr(R, k) is not None}
    arrays.update({k: np.asarray(getattr(R.plan, k))
                   for k in ("send_idx", "recv_pos", "nlocal", "nghosts")})
    meta = dict(nrows_global=R.nrows_global, ncols_global=R.ncols_global,
                row_pad=R.row_pad, symmetric=R.symmetric,
                nnz_global=R.nnz_global, local_format=R.local_format,
                rounds=R.plan.rounds, n_devices=R.n_devices,
                nlocal_pad=R.plan.nlocal_pad, nghost_pad=R.plan.nghost_pad,
                well_meta=R.well_meta, well_far_nnz=R.well_far_nnz,
                wellT_meta=R.wellT_meta, well_farT_nnz=R.well_farT_nnz)
    C = dist_matrix_from_numpy(arrays, meta, device="cpu")
    x = P.to_dist(np.random.default_rng(9).standard_normal(ref.nrows))
    assert torch.equal(C.matvec(x), P.matvec(x))


def _iterations(stdout: str) -> int:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("Converged:"))
    assert line.startswith("Converged: True")
    return int(line.split(" in ")[1].split()[0])


def _value(out, key):
    return float(out.split(key)[1].split()[0])


def test_demo_mtx_rcm_well_matches_reference_demo(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "fem.mtx")
    write_matrix_market(path, pt_corpus.fem_p1_2d(1500, seed=4, dtype=np.float64))
    common = ["--mtx", path, "--reorder", "rcm", "--format", "well",
              "--symmetric", "--jacobi", "--kmax", "2000", "--rtol", "1e-8"]
    assert pt_demo.main(common + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert "local_format=well" in port.err and "RCM: bandwidth" in port.err
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    ref_out = capsys.readouterr().out
    assert abs(_iterations(port.out) - _iterations(ref_out)) <= 1
    assert abs(_value(port.out, "x.norm = ") - _value(ref_out, "x.norm = ")) <= (
        1e-6 * _value(ref_out, "x.norm = "))


def test_demo_format_auto(tmp_path, capsys):
    path = str(tmp_path / "fem.mtx")
    write_matrix_market(path, pt_corpus.fem_p1_2d(1500, seed=4))
    args = ["--mtx", path, "--reorder", "rcm", "--format", "auto",
            "--symmetric", "--jacobi", "--kmax", "4000", "--rtol", "1e-5",
            "--device", "cpu"]
    assert pt_demo.main(args + ["--fp32"]) == 0
    out = capsys.readouterr()
    assert "local_format=well" in out.err
    _iterations(out.out)
    # float64 input selects the double-single dual-WELL format
    assert pt_demo.main(args) == 0
    out = capsys.readouterr()
    assert "local_format=well_ds" in out.err and "dtype=float64" in out.err
    _iterations(out.out)
