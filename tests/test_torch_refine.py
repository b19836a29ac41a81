"""spmv_torch mixed-precision refinement vs the spmv_tpu reference
(mirrors ``tests/test_refine.py``).

Both packages run the same outer loop on the same seeded inputs. The
outer-pass counts must be equal and the first residual (b itself through
the DS residual) equal to float32 rounding of the norm (1e-6 relative:
the two frameworks sum the norm in another order). Later passes start
from an fp32 inner CG solution, whose dots also sum in another order, so
inner iterations agree within 5% per inner solve (not 1%: an fp32 CG
count moves by a few iterations with the summation order, 332 vs 325 in
all on the 48^2 Laplacian, 135 vs 141.3 per solve on its diagonally
scaled twin) and the later residuals only to their order of magnitude;
the true float64 residual is held against the bound the reference's own
test uses.
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.gen as ref_gen
from spmv_tpu.solvers.refine import cg_refined as ref_refined
from spmv_tpu.solvers.refine import cg_refined_dist as ref_refined_dist

import spmv_torch.gen as pt_gen
from spmv_torch.ds import ds_from_f64, ds_to_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.ops.spmv_dia import spmv_dia
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.refine import cg_refined, cg_refined_dist

INNER_TOL = 0.05
DS_FLOOR = 1e-8  # a residual at or below this x history[0] is at the DS floor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, x, b):
    return np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)


def _stalled(res) -> bool:
    """The loop's own stall rule fired: its last two passes each contracted
    the residual by less than 0.95x."""
    stalls = 0
    for prev, cur in zip(res.history, res.history[1:]):
        stalls = stalls + 1 if cur > 0.95 * prev else 0
    return stalls >= 2


def _inner_solves(res) -> int:
    """Inner solves the loop ran: one per residual, except after the last
    residual when the loop stopped there (converged, or stalled)."""
    return len(res.history) - (1 if res.converged or _stalled(res) else 0)


def _floor_pass(res):
    """The first outer pass whose residual reaches the double-single floor
    (history[i] <= DS_FLOOR * history[0]), None if none does."""
    return next((i for i, h in enumerate(res.history)
                 if h <= DS_FLOOR * res.history[0]), None)


def _same_loop(got, want, max_outer):
    """The outer passes equal up to the first pass that reaches the DS
    floor (the same index in both loops), or all of them where neither
    reaches it; the first residual to float32 rounding of its norm, inner
    iterations per inner solve within INNER_TOL. Past the floor the
    residuals are rounding noise, and which pass a stall rule reads as two
    poor contractions depends on the CPU's reduction order (on one host
    the Jacobi case below stops the port after 6 outer passes and runs the
    reference to its 8th). There each loop only has to have stopped within
    max_outer: at max_outer, or before it by convergence or its own stall
    rule."""
    floor = _floor_pass(want)
    assert _floor_pass(got) == floor
    if floor is None:
        assert got.outer_iterations == want.outer_iterations
        assert got.converged == want.converged
    else:
        for res in (got, want):
            assert len(res.history) <= max_outer
            assert (len(res.history) == max_outer or res.converged
                    or _stalled(res)), res.history
    assert abs(got.history[0] - want.history[0]) <= 1e-6 * want.history[0]
    per_got = got.inner_iterations / _inner_solves(got)
    per_want = want.inner_iterations / _inner_solves(want)
    assert abs(per_got - per_want) <= INNER_TOL * per_want, (per_got, per_want)


def _scaled(w):
    """D A D of the 48^2 Laplacian with D = diag(w): SPD with its diagonal
    spread over orders of magnitude."""
    a0 = pt_gen.create_laplace_2d(48, 48)
    rows = np.repeat(np.arange(a0.nrows), a0.row_nnz())
    vals = a0.values * w[rows] * w[a0.colind]
    return (ref_gen.CSRHost(rowptr=a0.rowptr, colind=a0.colind, values=vals,
                            ncols=a0.nrows),
            CSRHost(rowptr=a0.rowptr, colind=a0.colind, values=vals,
                    ncols=a0.nrows))


def test_refinement_reaches_f64_class_residual():
    a = pt_gen.create_laplace_2d(48, 48)
    b = pt_gen.gaussian_bump(a.nrows)
    res = cg_refined(a, b, rtol=1e-12, inner_kmax=2000, device="cpu")
    assert res.converged
    rel = _rel(a, res.x, b)
    assert rel < 1e-11, rel
    # monotone contraction ~inner_rtol per outer pass
    assert res.history[1] < res.history[0] * 1e-3
    assert res.outer_iterations <= 4
    _same_loop(res, ref_refined(ref_gen.create_laplace_2d(48, 48), b, rtol=1e-12,
                                inner_kmax=2000, interpret=True), max_outer=6)


def test_refinement_beats_pure_fp32_floor():
    """A single fp32 solve cannot go below ~1e-7 relative residual; the
    refined solve lands orders of magnitude lower."""
    a = pt_gen.create_laplace_2d(48, 48)
    b = pt_gen.gaussian_bump(a.nrows)
    d32 = csr_to_dia(a, row_align=1024, dtype=np.float32, device="cpu")
    b32 = torch.from_numpy(np.pad(b, (0, d32.nrows_pad - a.nrows)).astype(np.float32))
    res32 = cg(lambda p: spmv_dia(d32, p), b32, kmax=4000, rtol=1e-14)
    rel32 = _rel(a, res32.x.numpy().astype(np.float64)[: a.nrows], b)
    ref = cg_refined(a, b, rtol=1e-12, inner_kmax=2000, device="cpu")
    rel_ref = _rel(a, ref.x, b)
    assert rel32 > 1e-9          # the fp32 floor is real
    assert rel_ref < rel32 / 100  # refinement breaks through it


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_distributed_ds_matvec(n_dev):
    """Sharded double-single SpMV (DS halo + DS kernel) matches the f64
    oracle to f64-class accuracy."""
    a = pt_gen.create_laplace_2d(48, 48)
    rng = np.random.default_rng(0)
    a.values[:] = a.values * (1 + 1e-9 * rng.standard_normal(a.nnz))
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia_ds", device="cpu")
    x = rng.standard_normal(a.nrows) * 1e3
    xh, xl = ds_from_f64(x)
    yh, yl = A.matvec_ds(A.to_dist(xh), A.to_dist(xl))
    got = ds_to_f64(A.from_dist(yh), A.from_dist(yl))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


@pytest.mark.parametrize("n_dev", [2, 4])
def test_distributed_refinement(n_dev):
    a = pt_gen.create_laplace_2d(48, 48)
    b = pt_gen.gaussian_bump(a.nrows)
    res = cg_refined_dist(a, b, n_devices=n_dev, rtol=1e-12, inner_kmax=2000,
                          device="cpu")
    assert res.converged
    rel = _rel(a, res.x, b)
    assert rel < 1e-11, rel
    _same_loop(res, ref_refined_dist(ref_gen.create_laplace_2d(48, 48), b,
                                     n_devices=n_dev, rtol=1e-12, inner_kmax=2000),
               max_outer=8)


def test_dia_ds_rejects_plain_matvec():
    a = pt_gen.create_laplace_2d(48, 48)
    A = build_dist_matrix(a, n_devices=2, local_format="dia_ds", device="cpu")
    with pytest.raises(ValueError, match="matvec_ds"):
        A.matvec(A.to_dist(pt_gen.gaussian_bump(a.nrows).astype(np.float32)))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_distributed_refinement_general_sparsity(n_dev):
    """f64-class distributed solves for general (non-banded) SPD matrices:
    inner fp32 WELL CG + double-single WELL residuals."""
    rng = np.random.default_rng(5)
    n = 400
    er = rng.integers(0, n, 2400)
    ec = rng.integers(0, n, 2400)
    keep = er != ec
    er, ec = er[keep], ec[keep]
    w = 0.5 + rng.random(len(er))
    deg = np.zeros(n)
    np.add.at(deg, er, w)
    np.add.at(deg, ec, w)
    coo = (np.concatenate([er, ec, np.arange(n)]), np.concatenate([ec, er, np.arange(n)]),
           np.concatenate([-w, -w, deg + 0.05]), n, n)
    b = rng.standard_normal(n)
    res = cg_refined_dist(CSRHost.from_coo(*coo), b, n_devices=n_dev, rtol=1e-12,
                          inner_kmax=3000, local_format="well", device="cpu")
    rel = _rel(CSRHost.from_coo(*coo), res.x, b)
    assert rel < 1e-10, rel
    _same_loop(res, ref_refined_dist(ref_gen.CSRHost.from_coo(*coo), b,
                                     n_devices=n_dev, rtol=1e-12,
                                     inner_kmax=3000, local_format="well"),
               max_outer=8)


def test_refinement_jacobi_inner():
    """Jacobi-scaled inner solves on a badly diagonally-scaled SPD operator:
    same f64-class floor, strictly fewer inner iterations."""
    ref, a = _scaled(np.logspace(-3, 3, 48 * 48))
    b = pt_gen.gaussian_bump(a.nrows)
    plain = cg_refined(a, b, rtol=1e-10, inner_kmax=4000, max_outer=8,
                       device="cpu")
    jac = cg_refined(a, b, rtol=1e-10, inner_kmax=4000, max_outer=8,
                     jacobi=True, device="cpu")
    rel = _rel(a, jac.x, b)
    assert rel < 1e-9, rel
    assert jac.inner_iterations < plain.inner_iterations, (
        jac.inner_iterations, plain.inner_iterations)
    _same_loop(jac, ref_refined(ref, b, rtol=1e-10, inner_kmax=4000, max_outer=8,
                                jacobi=True, interpret=True), max_outer=8)


def test_distributed_refinement_jacobi():
    """cg_refined_dist(jacobi=True) on a badly diagonally-scaled SPD
    operator: f64-class floor with fewer inner iterations than unscaled."""
    ref, a = _scaled(np.logspace(-2, 2, 48 * 48))
    b = pt_gen.gaussian_bump(a.nrows)
    plain = cg_refined_dist(a, b, n_devices=4, rtol=1e-10, inner_kmax=4000,
                            device="cpu")
    jac = cg_refined_dist(a, b, n_devices=4, rtol=1e-10, inner_kmax=4000,
                          jacobi=True, device="cpu")
    rel = _rel(a, jac.x, b)
    assert rel < 1e-9, rel
    assert jac.inner_iterations < plain.inner_iterations
    _same_loop(jac, ref_refined_dist(ref, b, n_devices=4, rtol=1e-10,
                                     inner_kmax=4000, jacobi=True), max_outer=8)


@pytest.mark.parametrize("amg", [True, {"aggregate": "interval2d"}])
def test_amg_inner_solves_raise(amg):
    """AMG-preconditioned inner solves are ported: they reach a float64-
    class true residual; an unknown aggregation raises amg_setup's error."""
    a = pt_gen.create_laplace_2d(16, 16)
    b = pt_gen.gaussian_bump(a.nrows)
    res = cg_refined_dist(a, b, amg=amg, device="cpu")
    assert res.converged and _rel(a, res.x, b) < 1e-11
    with pytest.raises(ValueError, match="aggregate"):
        cg_refined_dist(a, b, amg={"aggregate": "blocks"}, device="cpu")


def test_unknown_local_format_raises():
    a = pt_gen.create_laplace_2d(16, 16)
    with pytest.raises(ValueError, match="local_format"):
        cg_refined_dist(a, pt_gen.gaussian_bump(a.nrows), local_format="ell",
                        device="cpu")


def _lines(out: str) -> dict:
    conv = next(ln for ln in out.splitlines() if ln.startswith("Converged:"))
    words = conv.split()
    return {"converged": words[1] == "True", "outer": int(words[3]),
            "inner": int(words[6]),
            "r": float(out.split("r.norm = ")[1].split()[0]),
            "x": float(out.split("x.norm = ")[1].split()[0])}


@pytest.mark.parametrize("devices", [[], ["--devices", "2", "--jacobi"]])
def test_demo_refine(devices, capsys, monkeypatch):
    import os
    import sys

    from spmv_tpu.demos import demo_cg as ref_demo

    from spmv_torch.demos import demo_cg as pt_demo

    common = ["--lap2d", "48", "--refine", "--kmax", "2000", "--rtol", "1e-12",
              *devices]
    assert pt_demo.main(common + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert "(TRUE f64 residual)" in port
    monkeypatch.setattr(sys, "argv", ["demo_cg"] + common + ["--cpu"])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    got, want = _lines(port), _lines(capsys.readouterr().out)
    assert got["converged"] and want["converged"]
    assert got["outer"] == want["outer"]
    assert abs(got["inner"] - want["inner"]) <= INNER_TOL * want["inner"]
    assert got["r"] < 1e-11 * np.linalg.norm(pt_gen.gaussian_bump(48 * 48))
    assert abs(got["x"] - want["x"]) <= 1e-10 * want["x"]


def test_demo_refine_amg_still_exits(capsys):
    """--refine --amg runs (cg_refined_dist with AMG inner solves) and
    exits 0 with a float64-class true residual."""
    from spmv_torch.demos import demo_cg as pt_demo

    assert pt_demo.main(["--lap2d", "16", "--refine", "--amg", "--device", "cpu",
                         "--rtol", "1e-12"]) == 0
    got = _lines(capsys.readouterr().out)
    assert got["converged"]
    assert got["r"] < 1e-11 * np.linalg.norm(pt_gen.gaussian_bump(16 * 16))
