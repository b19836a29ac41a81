"""spmv_torch AMG vs the spmv_tpu reference (mirrors ``tests/test_amg.py``).

The host setup is the reference's numpy code, so on the same CSR the port
must build the reference's hierarchy exactly: level sizes, strides,
formats, smoother bounds and weights, gather tables, 1/diag and every
level operator's stacked arrays bit for bit, the coarse inverse bit for
bit. The reference's native host tier (which the port does not have)
differs from its numpy tier by ULPs in the Galerkin products, so the
reference runs here with that tier switched off (``spmv_tpu.native.lib.
get_lib`` patched to return None, in these tests only).

One cycle apply on a seeded residual agrees with the reference's to 1e-5
relative (float32 sums in another order through every level), and PCG
counts equal the reference's within 1 (that order moves an fp32 count by
at most one iteration here). The mirrors of ``tests/test_amg.py`` and the
solves are in ``tests/test_torch_amg_mirrors.py``.
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.corpus as ref_corpus
import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
import spmv_tpu.native.lib as ref_native
import spmv_tpu.solvers.amg as ref_amg
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.cg import cg as ref_cg

import spmv_torch.formats.csr as pt_csr
from spmv_torch.gen import gaussian_bump
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers import amg
from spmv_torch.solvers.amg import AMGHierarchy, amg_preconditioner, amg_setup
from spmv_torch.solvers.cg import cg

N_DEVICES = [1, 2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_numpy_tier(monkeypatch):
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)


def _port_csr(a):
    out = pt_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    out._sorted_unique = getattr(a, "_sorted_unique", False)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _lap(nx, ny=None):
    return ref_gen.create_laplace_2d(nx, ny or nx, dtype=np.float32)


# name -> (reference CSR maker, fine-operator format, amg_setup keywords)
CONFIGS = {
    "interval2d": (lambda: _lap(73, 71), "dia",
                   dict(aggregate="interval2d", interval_size=4, cycle=2,
                        local_format="dia", coarse_max=300)),
    "interval2d_3d": (lambda: ref_corpus.stencil27_3d(12), "ell",
                      dict(aggregate="interval2d", interval_size=2,
                           coarse_max=200, galerkin_budget=1e9)),
    "interval": (lambda: _lap(49, 47), "dia",
                 dict(aggregate="interval", local_format="dia", coarse_max=300)),
    "match": (lambda: _lap(40, 40), "ell", dict(coarse_max=200)),
    "match_unsmoothed": (lambda: _lap(40, 40), "ell",
                         dict(smooth=False, passes=2, omega=1.7, coarse_max=200)),
}


def _both(config, n_dev):
    make, fmt, kw = CONFIGS[config]
    ref = make()
    pt = _port_csr(ref)
    R = ref_build(ref, n_devices=n_dev, local_format=fmt, dtype=np.float32)
    P = build_dist_matrix(pt, n_devices=n_dev, local_format=fmt, dtype=np.float32,
                          device="cpu")
    return ref, pt, R, P, ref_amg.amg_setup(ref, R, **kw), amg_setup(pt, P, **kw)


def _same(t, arr):
    got, want = t.numpy(), np.asarray(arr)
    return got.shape == want.shape and np.array_equal(got, want)


def _same_operator(P, R):
    assert P.local_format == R.local_format
    assert (P.nrows_global, P.ncols_global, P.row_pad, P.col_pad) == (
        R.nrows_global, R.ncols_global, R.row_pad, R.col_pad)
    assert P.hub_nnz == R.hub_nnz and P.nnz_global == R.nnz_global
    assert _same(P.remote_colind, R.remote_colind)
    assert _same(P.remote_values, R.remote_values)
    if P.local_format == "dia":
        assert P.dia_offsets == R.dia_offsets
        assert _same(P.local_dia_data, R.local_dia_data)
    else:
        assert _same(P.local_colind, R.local_colind)
        assert _same(P.local_values, R.local_values)


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_hierarchy_matches_reference(config, n_dev):
    ref, pt, R, P, hr, hp = _both(config, n_dev)
    assert hp.n_levels == hr.n_levels >= 2
    assert hp.grid_complexity() == hr.grid_complexity()
    for lp, lr in zip(hp.levels, hr.levels):
        for name in ("lmax", "lmin", "nc_pad", "degree", "interval", "omega_p",
                     "omega_c", "smoothed", "stride", "stride2"):
            assert getattr(lp, name) == getattr(lr, name), name
        _same_operator(lp.A, lr.A)
        assert _same(lp.dinv, lr.dinv)
        for name in ("restrict_tab", "prolong_tab"):
            t, want = getattr(lp, name), getattr(lr, name)
            assert (t is None) == (want is None), name
            if t is not None:
                assert np.array_equal(t.numpy(), np.asarray(want)), name
        for name in ("P", "R"):
            op, want = getattr(lp, name), getattr(lr, name)
            assert (op is None) == (want is None), name
            if op is not None:
                _same_operator(op, want)
    _same_operator(hp.coarse_A, hr.coarse_A)
    assert _same(hp.coarse_dinv, hr.coarse_dinv)
    assert (hp.coarse_lmax, hp.coarse_lmin, hp.cycle, hp.omega) == (
        hr.coarse_lmax, hr.coarse_lmin, hr.cycle, hr.omega)
    assert _same(hp.coarse_inv, hr.coarse_inv)
    # one cycle on a seeded residual
    r = np.random.default_rng(n_dev).standard_normal(pt.nrows).astype(np.float32)
    got = P.from_dist(hp.as_preconditioner()(P.to_dist(r)))
    want = R.from_dist(jax.jit(lambda h_, v: h_.as_preconditioner()(v))(hr, R.to_dist(r)))
    assert _rel(got, want) <= 1e-5


def test_galerkin_product_matches_reference():
    """csr_matmul is the reference's numpy ESC tier: the triple product of a
    smoothed prolongator equals the reference's bit for bit."""
    ref = _lap(30, 30)
    pt = _port_csr(ref)
    diag, lmax = amg._level_diag(pt)
    agg = np.arange(pt.nrows) // 3
    dinv = 1.0 / diag
    p = amg._smoothed_prolongator(pt, agg, int(agg.max()) + 1, dinv, lmax, theta=0.05)
    p_r = ref_amg._smoothed_prolongator(ref, agg, int(agg.max()) + 1, dinv, lmax,
                                        theta=0.05)
    c = pt_csr.csr_matmul(p.transpose(), pt_csr.csr_matmul(pt, p))
    c_r = ref_csr.csr_matmul(p_r.transpose(), ref_csr.csr_matmul(ref, p_r))
    for name in ("rowptr", "colind", "values"):
        assert np.array_equal(getattr(c, name), getattr(c_r, name)), name


def _pcg_pair(a_ref, n_dev, dtype, kw, fmt="ell", rtol=1e-6, kmax=200):
    pt = _port_csr(a_ref)
    b = gaussian_bump(pt.nrows, dtype=dtype)
    R = ref_build(a_ref, n_devices=n_dev, local_format=fmt, dtype=dtype)
    P = build_dist_matrix(pt, n_devices=n_dev, local_format=fmt, dtype=dtype,
                          device="cpu")
    hr = ref_amg.amg_setup(a_ref, R, **kw)
    hp = amg_setup(pt, P, **kw)
    res_r = jax.jit(lambda A_, b_, h_: ref_cg(
        A_.as_linear_operator(), b_, kmax=kmax, rtol=rtol,
        preconditioner=h_.as_preconditioner()))(R, R.to_dist(b), hr)
    res = cg(P.as_linear_operator(), P.to_dist(b), kmax=kmax, rtol=rtol,
             preconditioner=hp.as_preconditioner())
    return pt, P, b, hp, hr, res, res_r


PCG_CASES = {
    "interval2d_wcycle": (lambda: _lap(64, 64), np.float32, "dia",
                          dict(aggregate="interval2d", interval_size=4, cycle=2,
                               local_format="dia", coarse_max=300), 1e-6),
    "f64_outer": (lambda: ref_gen.create_laplace_2d(32, 32), np.float64, "ell",
                  dict(coarse_max=200), 1e-12),
    "chebyshev_coarse": (lambda: _lap(32, 32), np.float32, "ell",
                         dict(dense_cap=0, coarse_iters=32), 1e-6),
    "match_wcycle": (lambda: _lap(32, 32), np.float32, "ell", dict(cycle=2), 1e-6),
}


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("case", list(PCG_CASES))
def test_pcg_counts_match_reference(case, n_dev):
    make, dtype, fmt, kw, rtol = PCG_CASES[case]
    pt, P, b, hp, _, res, res_r = _pcg_pair(make(), n_dev, dtype, kw, fmt, rtol)
    assert res.converged and bool(res_r.converged)
    assert abs(res.iterations - int(res_r.iterations)) <= 1, (
        res.iterations, int(res_r.iterations))
    if dtype == np.float64:
        # the float32 cycle does not limit the float64 outer residual
        assert hp.levels[0].A.dtype == torch.float32
        assert _rel(pt.matvec(P.from_dist(res.x)), b) < 1e-11
    if case == "chebyshev_coarse":
        assert hp.coarse_inv is None


def test_amg_preconditioner_convenience():
    a = _port_csr(_lap(32, 32))
    A = build_dist_matrix(a, n_devices=4, dtype=np.float32, device="cpu")
    apply_m, h = amg_preconditioner(a, A, cycle=2)
    assert isinstance(h, AMGHierarchy) and h.cycle == 2
    res = cg(A.as_linear_operator(), A.to_dist(gaussian_bump(a.nrows, dtype=np.float32)),
             kmax=60, rtol=1e-6, preconditioner=apply_m)
    assert res.converged


@pytest.mark.parametrize("kw,match", [
    (dict(aggregate="blocks"), "aggregate"),
    (dict(aggregate="interval", interval_size=1), "interval_size"),
    (dict(aggregate="interval2d", interval_size=1), "interval_size"),
])
def test_setup_errors_match_reference(kw, match):
    ref = _lap(16, 16)
    pt = _port_csr(ref)
    A = build_dist_matrix(pt, device="cpu")
    with pytest.raises(ValueError, match=match):
        amg_setup(pt, A, **kw)
    with pytest.raises(ValueError, match=match):
        ref_amg.amg_setup(ref, ref_build(ref, n_devices=1), **kw)


def test_amg_rejects_rectangular():
    rect = pt_csr.CSRHost.from_coo(np.array([0, 1]), np.array([0, 1]), np.ones(2), 2, 3)
    A = build_dist_matrix(_port_csr(_lap(8, 8)), device="cpu")
    with pytest.raises(ValueError, match="square"):
        amg_setup(rect, A)


@pytest.mark.parametrize("nx", [40, 72])
def test_amg_on_a_float64_dia_operator_of_other_padding(nx):
    """A float64 DIA operator gets a float32 ELL fine level of its own,
    padded to 128 rows a shard where the DIA operator pads to 1024: at 40^2
    over 2 shards (no level: the ELL operator is the coarsest) and 72^2
    (one level) the preconditioner re-pads the residual, and PCG converges
    (the reference's coarse solve raises a shape error at 40^2)."""
    a = pt_csr.CSRHost.from_coo(*_triplets(_lap(nx)), nx * nx, nx * nx)
    A = build_dist_matrix(a, n_devices=2, dtype=np.float64, local_format="dia",
                          device="cpu")
    h = amg_setup(a, A, aggregate="interval2d", interval_size=4, cycle=2)
    first = h.levels[0].A if h.levels else h.coarse_A
    assert first.row_pad != A.row_pad
    b = A.to_dist(gaussian_bump(a.nrows))
    res = cg(A.as_linear_operator(), b, kmax=200, rtol=1e-10,
             preconditioner=h.as_preconditioner())
    x = A.from_dist(res.x)
    assert res.converged
    assert np.linalg.norm(a.matvec(x) - gaussian_bump(a.nrows)) <= 1e-9 * np.linalg.norm(
        gaussian_bump(a.nrows))


def _triplets(a):
    rows = np.repeat(np.arange(a.nrows), a.row_nnz())
    return rows, a.colind, a.values.astype(np.float64)
