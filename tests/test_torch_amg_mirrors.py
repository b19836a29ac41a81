"""spmv_torch AMG: the mirrors of ``tests/test_amg.py`` on the port alone,
and the solves held against the reference's (the hierarchy itself is held
bit for bit in ``tests/test_torch_amg.py``).

Transfers: <R r, xc> == <r, P xc> to 1e-4 of the larger side and the
coarse operator equal to P^T A P (densely, with the P the cycle applies)
to 2e-4, the reference test's bounds. PCG counts against the reference's
within the tolerance each test states. The reference runs with its native
host tier switched off, as in ``tests/test_torch_amg.py``.
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
from spmv_tpu.solvers.refine import cg_refined_dist as ref_refined_dist

import spmv_torch.formats.csr as pt_csr
from spmv_torch.gen import gaussian_bump
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers import amg
from spmv_torch.solvers.amg import amg_setup
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.refine import cg_refined_dist


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


def _same_arrays(P, R):
    """The port's level operator holds the reference's stacked arrays."""
    assert (P.local_format, P.nrows_global, P.ncols_global, P.hub_nnz) == (
        R.local_format, R.nrows_global, R.ncols_global, R.hub_nnz)
    for name in ("local_colind", "local_values", "remote_colind", "remote_values"):
        assert np.array_equal(getattr(P, name).numpy(), np.asarray(getattr(R, name)))


def _dist_to_dense(A):
    n = A.nrows_global
    out = np.zeros((n, n), np.float64)
    eye = np.eye(n, dtype=np.float32)
    for j in range(n):
        out[:, j] = A.from_dist(A.matvec(A.to_dist(eye[:, j])))[:n]
    return out


def _adjoint_galerkin(a, h, galerkin=True):
    """<R r, xc> == <r, P xc>, and the coarse operator equals P^T A P with
    the P the cycle applies (densely on the host)."""
    lvl = h.levels[0]
    A_c = h.levels[1].A if len(h.levels) > 1 else h.coarse_A
    nc = A_c.nrows_global
    rng = np.random.default_rng(6)
    r_h = rng.standard_normal(a.nrows).astype(np.float32)
    xc_h = rng.standard_normal(nc).astype(np.float32)
    Rr = A_c.from_dist(amg._restrict(lvl, lvl.A.to_dist(r_h)))
    Pxc = lvl.A.from_dist(amg._prolong(lvl, A_c.to_dist(xc_h)))
    lhs = float(np.dot(Rr.astype(np.float64), xc_h))
    rhs = float(np.dot(r_h.astype(np.float64), Pxc))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0), (lhs, rhs)
    if not galerkin:
        return
    p = np.zeros((a.nrows, nc))
    eye = np.eye(nc, dtype=np.float32)
    for j in range(nc):
        p[:, j] = lvl.A.from_dist(amg._prolong(lvl, A_c.to_dist(eye[:, j])))[: a.nrows]
    want = p.T @ a.to_dense().astype(np.float64) @ p
    np.testing.assert_allclose(_dist_to_dense(A_c), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["unsmoothed", "smoothed", "interval", "interval2d",
                                  "interval2d_3d"])
def test_transfer_adjointness_and_galerkin(mode):
    """The reference's adjointness and Galerkin checks (test_amg.py:81,
    :127, :273, :327, :398), on the port's transfers."""
    if mode == "interval2d_3d":
        a = _port_csr(ref_corpus.stencil27_3d(16))
        kw = dict(aggregate="interval2d", interval_size=2, coarse_max=8,
                  max_levels=2, galerkin_budget=1e9)
    else:
        a = _port_csr(_lap(28 if mode == "unsmoothed" else 26))
        kw = {"unsmoothed": dict(smooth=False, passes=2, coarse_max=8),
              "smoothed": dict(smooth=True, passes=1, coarse_max=8),
              "interval": dict(aggregate="interval", coarse_max=8),
              "interval2d": dict(aggregate="interval2d", coarse_max=8)}[mode]
    A = build_dist_matrix(a, n_devices=4, dtype=np.float32, device="cpu")
    h = amg_setup(a, A, **kw)
    lvl = h.levels[0]
    if mode == "unsmoothed":
        assert lvl.prolong_tab is not None and lvl.P is None
    elif mode == "smoothed":
        assert lvl.P is not None and lvl.R is not None
        assert lvl.P.ncols_global != lvl.P.nrows_global
    else:
        assert lvl.interval and lvl.omega_p > 0
        assert (lvl.stride > 1) == mode.startswith("interval2d")
        assert (lvl.stride2 > 1) == (mode == "interval2d_3d")
    _adjoint_galerkin(a, h, galerkin=mode != "interval2d_3d")


def test_amg_interval2d_bounded_stencil():
    a = _port_csr(_lap(256, 256))
    A = build_dist_matrix(a, local_format="dia", dtype=np.float32, device="cpu")
    h = amg_setup(a, A, aggregate="interval2d", interval_size=4, local_format="dia")
    for lvl in h.levels[1:]:
        assert lvl.A.nnz_global / lvl.A.nrows_global <= 15
    assert all(lvl.smoothed for lvl in h.levels)


def test_amg_interval2d_mesh_independent_1024():
    """The bench configuration's counts stay flat from 256^2 to 1024^2 and
    at most 16 (test_amg.py:423-440)."""
    iters = {}
    for nx in (256, 1024):
        a = pt_csr.CSRHost(*(lambda r: (r.rowptr, r.colind, r.values, r.ncols))(
            _lap(nx)))
        A = build_dist_matrix(a, local_format="dia", dtype=np.float32, device="cpu")
        h = amg_setup(a, A, aggregate="interval2d", interval_size=4, cycle=2,
                      local_format="dia")
        res = cg(A.as_linear_operator(), A.to_dist(gaussian_bump(a.nrows, dtype=np.float32)),
                 kmax=60, rtol=1e-6, preconditioner=h.as_preconditioner())
        assert res.converged, nx
        iters[nx] = res.iterations
    assert iters[1024] <= iters[256] + 4 and iters[1024] <= 16, iters


def test_default_smoothed_aggregation_on_fem_uses_rectangular_and_hubs(monkeypatch):
    """amg_setup's default (smoothed matching) on an RCM'd FEM at D = 4:
    rectangular ELL P/R and hub-split coarse operators, the reference's
    arrays and hub splits on every level; every apply is gathers only, and
    PCG converges with the reference's count within 5% (about 115 fp32
    iterations on this operator, whose count moves by a few with the
    summation order, as the refinement tests' inner CG counts do)."""
    from spmv_torch.corpus import fem_p1_2d
    from spmv_torch.reorder import rcm_reorder

    a, _ = rcm_reorder(fem_p1_2d(12_000), keep_best=True)
    ref = ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    ref._sorted_unique = True
    pt = _port_csr(ref)
    b = gaussian_bump(pt.nrows, dtype=np.float32)
    R = ref_build(ref, n_devices=4, dtype=np.float32)
    P = build_dist_matrix(pt, n_devices=4, dtype=np.float32, device="cpu")
    hr, hp = ref_amg.amg_setup(ref, R), amg_setup(pt, P)
    res_r = jax.jit(lambda A_, b_, h_: ref_cg(
        A_.as_linear_operator(), b_, kmax=400, rtol=1e-6,
        preconditioner=h_.as_preconditioner()))(R, R.to_dist(b), hr)
    res = cg(P.as_linear_operator(), P.to_dist(b), kmax=400, rtol=1e-6,
             preconditioner=hp.as_preconditioner())
    assert hp.n_levels == hr.n_levels
    for lp, lr in zip(hp.levels, hr.levels):
        for name in ("A", "P", "R"):
            _same_arrays(getattr(lp, name), getattr(lr, name))
    ops = [op for lvl in hp.levels for op in (lvl.A, lvl.P, lvl.R)] + [hp.coarse_A]
    assert any(lvl.P.ncols_global < lvl.P.nrows_global for lvl in hp.levels)
    assert sum(op.hub_nnz for op in ops) > 0
    assert res.converged and bool(res_r.converged)
    assert abs(res.iterations - int(res_r.iterations)) <= 0.05 * int(res_r.iterations)

    def refuse(*args, **kwargs):
        raise AssertionError("an apply called a scatter-add")

    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "scatter_add_"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)
    hp.as_preconditioner()(P.to_dist(b))


@pytest.mark.parametrize("n_dev,amg_kw", [
    (1, True), (4, {"aggregate": "interval2d", "interval_size": 4, "cycle": 2})])
def test_refined_amg_matches_reference_loop(n_dev, amg_kw):
    """cg_refined_dist(amg=...) against the reference's loop: the same outer
    passes, inner AMG-PCG iterations within one per pass, and the
    reference's float64-class true residual."""
    ref = ref_gen.create_laplace_2d(48, 48)
    pt = _port_csr(ref)
    b = gaussian_bump(pt.nrows)
    kw = dict(rtol=1e-10, inner_kmax=200, amg=amg_kw)
    got = cg_refined_dist(pt, b, n_devices=n_dev, device="cpu", **kw)
    want = ref_refined_dist(ref, b, n_devices=n_dev, **kw)
    assert got.converged and want.converged
    assert got.outer_iterations == want.outer_iterations
    assert abs(got.inner_iterations - want.inner_iterations) <= got.outer_iterations
    assert _rel(pt.matvec(got.x), b) < 1e-9


@pytest.mark.parametrize("extra", [[], ["--refine"]])
def test_demo_amg(extra, capsys):
    from spmv_torch.demos import demo_cg

    assert demo_cg.main(["--lap2d", "96", "--device", "cpu", "--amg", "--fp32",
                         "--dia", "--rtol", "1e-6", *extra]) == 0
    out = capsys.readouterr()
    assert "Converged: True" in out.out
    if not extra:
        assert "AMG: 2 levels" in out.err
        assert "0.AMGSetup" in out.out
