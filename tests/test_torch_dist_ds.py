"""spmv_torch DistMatrix with the double-single local formats ("dia_ds",
"well_ds") vs the spmv_tpu reference.

The port stacks every shard on one torch device; the reference runs the
same shards on the 8-device virtual CPU mesh. Assembly must give the
reference's stacked arrays exactly, every hi and lo plane included.
``matvec_ds`` is held against the reference's (compiled by XLA, which may
contract ``ds_mul_f32``'s cross term into an fma: hi planes equal, hi + lo
within 4e-15 relative L2, see ``test_torch_ds.py``) and against the host
float64 CSR oracle (< 1e-13 relative L2).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import spmv_tpu.corpus as ref_corpus
import spmv_tpu.gen as ref_gen
import spmv_tpu.reorder as ref_reorder
from spmv_tpu.demos import demo_cg as ref_demo
from spmv_tpu.ds import ds_to_f64
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.cg import cg as ref_cg

import spmv_torch.corpus as pt_corpus
import spmv_torch.gen as pt_gen
import spmv_torch.reorder as pt_reorder
from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.demos import demo_cg as pt_demo
from spmv_torch.ds import ds_add, ds_from_f64
from spmv_torch.io.matrix_market import write_matrix_market
from spmv_torch.parallel import comm_plan
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg

CONTRACTION_TOL = 4e-15  # see the module docstring
ORACLE_TOL = 1e-13
DS_FIELDS = (
    "remote_colind", "remote_values", "remote_values_lo", "jacobi_diag",
    "diagonal", "diagonal_lo", "local_dia_data", "local_dia_data_lo",
    "local_well_values", "local_well_values_lo", "local_well_pos",
    "local_well_w0", "local_wellT_values", "local_wellT_values_lo",
    "local_wellT_pos", "local_wellT_w0", "farT_cols", "farT_vals",
    "farT_vals_lo", "remoteT_colind", "remoteT_vals", "remoteT_vals_lo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _laplace(seed=0, nx=48):
    """A 2-D Laplacian with values perturbed below float32 resolution."""
    ref, pt = ref_gen.create_laplace_2d(nx, nx), pt_gen.create_laplace_2d(nx, nx)
    rng = np.random.default_rng(seed)
    ref.values[:] = ref.values * (1 + 1e-9 * rng.standard_normal(ref.nnz))
    pt.values[:] = ref.values
    return ref, pt


def _random_sym(n=700, seed=95):
    """The reference's symmetric general DS test matrix (random_csr)."""
    return (ref_gen.random_csr(n, n, 5, seed=seed, symmetric=True, spd_shift=1.0),
            pt_gen.random_csr(n, n, 5, seed=seed, symmetric=True, spd_shift=1.0))


def _long_range(n=80_000, pairs=300, seed=3):
    """Tridiagonal plus entries joining the first and the last rows: a
    single shard's window split leaves a far remainder (both triangles)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pi, pj = rng.integers(0, 5000, pairs), rng.integers(n - 5000, n, pairs)
    rows = np.concatenate([i, i[1:], i[:-1], pi, pj])
    cols = np.concatenate([i, i[:-1], i[1:], pj, pi])
    vals = np.concatenate([np.full(n, 4.0), np.full(2 * (n - 1), -1.0),
                           np.full(2 * pairs, -0.5)])
    return (ref_corpus.CSRHost.from_coo(rows, cols, vals, n, n),
            pt_corpus.CSRHost.from_coo(rows, cols, vals, n, n))


def _both(pair, n_dev, fmt, symmetric=False):
    ref, pt = pair
    R = ref_build(ref, n_devices=n_dev, symmetric=symmetric, local_format=fmt)
    P = build_dist_matrix(pt, n_devices=n_dev, symmetric=symmetric,
                          local_format=fmt, device="cpu")
    return ref, R, P


def _assert_same_assembly(R, P):
    assert P.local_format == R.local_format
    assert (P.row_pad, P.plan.nlocal_pad, P.plan.nghost_pad, P.plan.rounds) == (
        R.row_pad, R.plan.nlocal_pad, R.plan.nghost_pad, R.plan.rounds)
    assert P.dia_offsets == R.dia_offsets
    assert tuple(P.well_meta) == tuple(R.well_meta)
    assert tuple(P.wellT_meta) == tuple(R.wellT_meta)
    assert (P.well_far_nnz, P.well_farT_nnz) == (R.well_far_nnz, R.well_farT_nnz)
    names = DS_FIELDS
    if P.local_format == "well_ds":  # the far ELL (dia_ds keeps placeholders)
        names += ("local_colind", "local_values", "local_values_lo")
    if not P.local_format.endswith("_ds"):
        # a symmetric non-DS operator with ghosts keeps the port's own gather
        # form of its ghost-column term, which the reference does not store
        names = tuple(n for n in names if n not in ("remoteT_colind", "remoteT_vals"))
    for name in names:
        got, want = getattr(P, name), getattr(R, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.shape == want.shape and np.array_equal(got.numpy(),
                                                              np.asarray(want)), name
    for name in ("send_idx", "recv_pos"):
        assert np.array_equal(getattr(P.plan, name).numpy(),
                              np.asarray(getattr(R.plan, name)))


def _ds_x(P, x):
    xh, xl = ds_from_f64(x)
    return P.to_dist(xh), P.to_dist(xl)


def _ref_matvec_ds(R, x):
    xh, xl = ds_from_f64(x)
    yh, yl = jax.jit(lambda M, h, l: M.matvec_ds(h, l))(
        R, R.to_dist(xh), R.to_dist(xl))
    return R.from_dist(yh), R.from_dist(yl)


def _check_matvec_ds(ref, R, P, x):
    yh, yl = P.matvec_ds(*_ds_x(P, x))
    assert yh.dtype == yl.dtype == torch.float32
    got = ds_to_f64(P.from_dist(yh), P.from_dist(yl))
    wh, wl = _ref_matvec_ds(R, x)
    assert np.array_equal(P.from_dist(yh), wh)
    want = ds_to_f64(wh, wl)
    assert np.linalg.norm(got - want) <= CONTRACTION_TOL * np.linalg.norm(want)
    oracle = ref.matvec(x)
    assert np.linalg.norm(got - oracle) < ORACLE_TOL * np.linalg.norm(oracle)
    return got


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_dia_ds_matches_reference(n_dev):
    ref, R, P = _both(_laplace(), n_dev, "dia_ds")
    _assert_same_assembly(R, P)
    assert P.local_colind is None and P.local_values is None
    assert P.dtype == torch.float32 and P.local_dia_data_lo.abs().max() > 0
    x = np.random.default_rng(n_dev).standard_normal(ref.nrows) * 1e3
    _check_matvec_ds(ref, R, P, x)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_well_ds_matches_reference(n_dev, symmetric):
    ref, R, P = _both(_random_sym(), n_dev, "well_ds", symmetric)
    _assert_same_assembly(R, P)
    if symmetric and n_dev > 1:
        # the error-free reverse exchange runs
        assert P.remoteT_colind is not None and P.plan.nghost_pad > 0
    x = np.random.default_rng(96).standard_normal(ref.nrows)
    _check_matvec_ds(ref, R, P, x)


@pytest.mark.parametrize("symmetric", [False, True])
def test_well_ds_far_remainder_matches_reference(symmetric):
    ref, R, P = _both(_long_range(), 1, "well_ds", symmetric)
    _assert_same_assembly(R, P)
    assert P.well_far_nnz > 0 and (P.well_farT_nnz > 0) == symmetric
    x = np.random.default_rng(7).standard_normal(ref.nrows)
    _check_matvec_ds(ref, R, P, x)


@pytest.mark.parametrize("fmt,pair,symmetric", [
    ("dia_ds", _laplace, False), ("well_ds", _random_sym, False),
    ("well_ds", _random_sym, True)])
def test_transparent_f64_matvec(fmt, pair, symmetric):
    ref, R, P = _both(pair(), 4, fmt, symmetric)
    x = np.random.default_rng(98).standard_normal(ref.nrows)
    y = P.matvec(P.to_dist(x))
    assert y.dtype == torch.float64
    got = P.from_dist(y)
    want = R.from_dist(jax.jit(lambda M, v: M.matvec(v))(R, R.to_dist(x)))
    assert np.linalg.norm(got - want) <= CONTRACTION_TOL * np.linalg.norm(want)
    oracle = ref.matvec(x)
    assert np.linalg.norm(got - oracle) < ORACLE_TOL * np.linalg.norm(oracle)
    # the float64 x splits exactly as the host split does
    yh, yl = P.matvec_ds(*_ds_x(P, x))
    assert torch.equal(y, yh.double() + yl.double())


def test_float32_matvec_raises():
    _, _, P = _both(_laplace(), 2, "dia_ds")
    with pytest.raises(ValueError, match="matvec_ds"):
        P.matvec(P.to_dist(pt_gen.gaussian_bump(P.nrows_global).astype(np.float32)))
    _, _, Q = _both(_laplace(), 2, "dia")
    with pytest.raises(ValueError, match="matvec_ds requires"):
        Q.matvec_ds(*_ds_x(Q, np.ones(Q.nrows_global)))


def test_dia_ds_symmetric_raises():
    _, pt = _laplace()
    with pytest.raises(ValueError, match="dia_ds"):
        build_dist_matrix(pt, symmetric=True, local_format="dia_ds", device="cpu")


@pytest.mark.parametrize("symmetric", [False, True])
def test_auto_on_float64_builds_ds_as_the_reference(symmetric):
    for pair in (_laplace(), _random_sym()):
        ref, pt = pair
        R = ref_build(ref, n_devices=2, symmetric=symmetric, local_format="auto")
        P = build_dist_matrix(pt, n_devices=2, symmetric=symmetric,
                              local_format="auto", device="cpu")
        assert P.local_format == R.local_format
        _assert_same_assembly(R, P)
    # symmetric banded float64 stays "dia"; general sparsity goes "well_ds"
    assert P.local_format == "well_ds"


@pytest.mark.parametrize("fmt,pair,symmetric", [
    ("dia_ds", _laplace, False), ("well_ds", _random_sym, True),
    ("well_ds", _long_range, True)])
def test_from_numpy_matches_own_assembly(fmt, pair, symmetric):
    """A DS DistMatrix carried across from the reference's fields applies
    exactly like the port's own assembly."""
    n_dev = 1 if pair is _long_range else 4
    ref, R, P = _both(pair(), n_dev, fmt, symmetric)
    names = DS_FIELDS + ("local_colind", "local_values", "local_values_lo",
                         "local_dia_data", "local_dia_data_lo")
    arrays = {k: np.asarray(getattr(R, k)) for k in names
              if getattr(R, k, None) is not None}
    arrays.update({k: np.asarray(getattr(R.plan, k))
                   for k in ("send_idx", "recv_pos", "nlocal", "nghosts")})
    meta = dict(nrows_global=R.nrows_global, ncols_global=R.ncols_global,
                row_pad=R.row_pad, symmetric=R.symmetric,
                nnz_global=R.nnz_global, local_format=R.local_format,
                dia_offsets=R.dia_offsets, rounds=R.plan.rounds,
                n_devices=R.n_devices, nlocal_pad=R.plan.nlocal_pad,
                nghost_pad=R.plan.nghost_pad, well_meta=R.well_meta,
                well_far_nnz=R.well_far_nnz, wellT_meta=R.wellT_meta,
                well_farT_nnz=R.well_farT_nnz)
    C = dist_matrix_from_numpy(arrays, meta, device="cpu")
    xs = _ds_x(P, np.random.default_rng(9).standard_normal(ref.nrows))
    for got, want in zip(C.matvec_ds(*xs), P.matvec_ds(*xs)):
        assert torch.equal(got, want)


def test_ds_reverse_exchange_is_a_placement():
    """halo_scatter_add_ds on a D=4 plan with padding slots: zero ghost
    contributions leave the accumulator's bits as they are, and the sums
    equal the float64 scatter-add oracle to the DS rounding level."""
    ref, pt = _random_sym()
    P = build_dist_matrix(pt, n_devices=4, symmetric=True, local_format="well_ds",
                          device="cpu")
    plan = P.plan
    assert (plan.recv_pos == int(comm_plan.OOB)).any()  # padding present
    rng = np.random.default_rng(12)
    nd = plan.n_devices
    acc = ds_from_f64(rng.standard_normal((nd, plan.nlocal_pad)) * 1e3)
    acc = [torch.from_numpy(a) for a in acc]
    zeros = torch.zeros((nd, plan.nghost_pad))
    out = comm_plan.halo_scatter_add_ds(zeros, zeros, *acc, plan.send_idx,
                                        plan.recv_pos, plan.rounds)
    assert all(torch.equal(o, a) for o, a in zip(out, acc))
    gz64 = rng.standard_normal((nd, plan.nghost_pad))
    gz = [torch.from_numpy(g) for g in ds_from_f64(gz64)]
    out = comm_plan.halo_scatter_add_ds(*gz, *acc, plan.send_idx, plan.recv_pos,
                                        plan.rounds)
    want = comm_plan.halo_scatter_add(
        torch.from_numpy(gz64), torch.from_numpy(ds_to_f64(*acc)),
        plan.send_idx, plan.recv_pos, plan.rounds)
    got = ds_to_f64(*out)
    assert np.abs(got - want.numpy()).max() <= 1e-14 * np.abs(want.numpy()).max()
    # a DS sum of two DS values through the plain ds_add, no rounding at f32
    assert not np.array_equal(out[1].numpy(), acc[1].numpy())
    assert torch.equal(ds_add(*acc, *[torch.zeros_like(a) for a in acc])[0], acc[0])


def _fem(n=3000, seed=0):
    ref, _ = ref_reorder.rcm_reorder(
        ref_corpus.fem_p1_2d(n, seed=seed, dtype=np.float64), native=False,
        keep_best=True)
    pt, _ = pt_reorder.rcm_reorder(
        pt_corpus.fem_p1_2d(n, seed=seed, dtype=np.float64), keep_best=True)
    return ref, pt


def test_ds_jacobi_pcg_matches_reference_and_native_f64():
    """The float64 general-sparsity main path at test size: "auto" on a
    symmetric float64 RCM'd FEM builds dual-WELL DS; Jacobi-PCG through the
    transparent float64 matvec takes the reference's count within 1% and
    the native float64 "well" operator's within 2% (DS carries ~48 bits to
    float64's 53), and ends within 1e-8 of the native solution."""
    ref, pt = _fem()
    b = pt_gen.gaussian_bump(pt.nrows)
    R = ref_build(ref, n_devices=2, symmetric=True, local_format="auto")
    P = build_dist_matrix(pt, n_devices=2, symmetric=True, local_format="auto",
                          device="cpu")
    assert P.local_format == R.local_format == "well_ds"
    rr = jax.jit(lambda A_, bb: ref_cg(
        A_.as_linear_operator(), bb, kmax=3000, rtol=1e-6,
        preconditioner=A_.jacobi_preconditioner()))(R, R.to_dist(b))
    rp = cg(P.as_linear_operator(), P.to_dist(b), kmax=3000, rtol=1e-6,
            preconditioner=P.jacobi_preconditioner())
    assert rp.x.dtype == torch.float64
    assert bool(rr.converged) and rp.converged
    assert abs(rp.iterations - int(rr.iterations)) <= 0.01 * int(rr.iterations)
    N = build_dist_matrix(pt, n_devices=2, symmetric=True, local_format="well",
                          dtype=np.float64, device="cpu")
    rn = cg(N.as_linear_operator(), N.to_dist(b), kmax=3000, rtol=1e-6,
            preconditioner=N.jacobi_preconditioner())
    assert abs(rp.iterations - rn.iterations) <= 0.02 * rn.iterations
    x, xn = P.from_dist(rp.x), N.from_dist(rn.x)
    assert np.linalg.norm(x - xn) <= 1e-8 * np.linalg.norm(xn)


def _iterations(stdout: str) -> int:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("Converged:"))
    assert line.startswith("Converged: True")
    return int(line.split(" in ")[1].split()[0])


def _value(out, key):
    return float(out.split(key)[1].split()[0])


def test_demo_format_auto_float64_runs_dia_ds(capsys, monkeypatch):
    common = ["--lap2d", "48", "--format", "auto", "--kmax", "2000",
              "--rtol", "1e-10"]
    assert pt_demo.main(common + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert "local_format=dia_ds" in port.err and "dtype=float64" in port.err
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    ref_out = capsys.readouterr().out
    assert abs(_iterations(port.out) - _iterations(ref_out)) <= 1
    assert _value(port.out, "r.norm = ") < 1e-8
    assert abs(_value(port.out, "x.norm = ") - _value(ref_out, "x.norm = ")) <= (
        1e-10 * _value(ref_out, "x.norm = "))


def test_demo_format_well_ds_mtx(tmp_path, capsys):
    path = str(tmp_path / "fem.mtx")
    write_matrix_market(path, pt_corpus.fem_p1_2d(1500, seed=4))
    assert pt_demo.main(["--mtx", path, "--reorder", "rcm", "--format", "well_ds",
                         "--jacobi", "--kmax", "4000", "--rtol", "1e-8",
                         "--devices", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "local_format=well_ds" in out.err
    _iterations(out.out)
