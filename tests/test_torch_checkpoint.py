"""spmv_torch's checkpoints vs the spmv_tpu reference (mirrors of
``tests/test_checkpoint.py``, one-tier plans).

The port reads the reference's file format: an operator the reference
saves on its 8-device virtual CPU mesh loads in the port and applies
within 1e-14 of the reference's matvec (the double-single formats: the
same error-free chain in another order), and with the same bits as the
port's own assembly of the same matrix. A file the port writes loads in
the port with the same bits (and in the reference). Solver state resumes
CG as the reference's tests do. A two-tier file and a device count other
than the saved one raise.
"""
import json

import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.io.checkpoint import load_dist_matrix as ref_load
from spmv_tpu.io.checkpoint import save_dist_matrix as ref_save
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

from spmv_torch.corpus import powerlaw_laplacian
from spmv_torch.gen import create_laplace_2d, gaussian_bump, random_csr
from spmv_torch.io.checkpoint import (
    load_dist_matrix,
    load_solver_state,
    save_dist_matrix,
    save_solver_state,
)
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers.cg import cg

REF_TOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


CASES = {
    # name: (matrix, shards, symmetric, local_format, reference kwargs)
    "ell": (lambda: random_csr(600, 600, 5, seed=60), 4, False, "ell", {}),
    "ell_sym": (lambda: random_csr(600, 600, 3, seed=61, symmetric=True, spd_shift=1.0),
                4, True, "ell", {}),
    "dia": (lambda: create_laplace_2d(24, 20), 4, False, "dia", {}),
    "well_far": (lambda: random_csr(8000, 8000, 6, seed=77), 4, False, "well",
                 {"well_wseg_cap": 8}),
    "dia_ds": (lambda: create_laplace_2d(24, 20), 2, False, "dia_ds", {}),
    "well_ds": (lambda: random_csr(500, 500, 4, seed=70, symmetric=True, spd_shift=1.0),
                4, False, "well_ds", {}),
    "well_ds_sym": (lambda: random_csr(500, 500, 4, seed=70, symmetric=True,
                                       spd_shift=1.0), 4, True, "well_ds", {}),
    "ell_hubs": (lambda: powerlaw_laplacian(3000, seed=1, dtype=np.float64), 2, False, "ell",
                 {"hub_cap": 16}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_loads_the_references_checkpoint(case, tmp_path):
    make, nd, sym, fmt, kw = CASES[case]
    pt = make()
    R = ref_build(_ref(pt), n_devices=nd, symmetric=sym, local_format=fmt, **kw)
    path = str(tmp_path / case)
    ref_save(path, R)
    P = load_dist_matrix(path, device="cpu")
    assert (P.local_format, P.symmetric, P.n_devices) == (fmt, sym, nd)
    assert P.nnz_global == R.nnz_global and P.well_far_nnz == R.well_far_nnz
    if case == "well_far":
        assert P.well_far_nnz > 0
    x = np.random.default_rng(71).standard_normal(pt.nrows)
    got = P.from_dist(P.matvec(P.to_dist(x)))
    want = R.from_dist(jax.jit(lambda M, v: M.matvec(v))(R, R.to_dist(x)))
    assert _rel(got, want) <= REF_TOL
    assert _rel(got, pt.matvec(x)) <= 1e-13
    if case == "ell_hubs":
        assert P.hub_nnz == R.hub_nnz > 0
    own = build_dist_matrix(pt, n_devices=nd, symmetric=sym, local_format=fmt,
                            hub_cap=kw.get("hub_cap", "auto"), device="cpu")
    if fmt != "well":  # the port's own WELL split keeps its default window cap
        assert torch.equal(P.matvec(P.to_dist(x)), own.matvec(own.to_dist(x)))


@pytest.mark.parametrize("case", ["ell_sym", "dia", "well_far", "well_ds_sym", "hubs"])
def test_port_checkpoint_round_trip(case, tmp_path):
    """The port's save and load give the same bits on a matvec; the
    suffix-less path resolves to the same .npz and sidecar."""
    if case == "hubs":
        pt = powerlaw_laplacian(3000, seed=1, dtype=np.float64)
        A = build_dist_matrix(pt, n_devices=2, local_format="ell", hub_cap=16, device="cpu")
        assert A.hub_nnz > 0
    else:
        make, nd, sym, fmt, _kw = CASES[case]
        pt = make()
        A = build_dist_matrix(pt, n_devices=nd, symmetric=sym, local_format=fmt, device="cpu")
    path = str(tmp_path / "op")
    save_dist_matrix(path, A)
    B = load_dist_matrix(path + ".npz", device="cpu")
    assert (B.local_format, B.symmetric, B.nnz_global, B.hub_nnz) == (
        A.local_format, A.symmetric, A.nnz_global, A.hub_nnz)
    x = np.random.default_rng(72).standard_normal(pt.nrows)
    assert torch.equal(B.matvec(B.to_dist(x)), A.matvec(A.to_dist(x)))
    assert torch.equal(B.jacobi_diag, A.jacobi_diag)


@pytest.mark.parametrize("case", ["ell", "dia"])
def test_reference_loads_the_ports_checkpoint(case, tmp_path):
    make, nd, sym, fmt, _kw = CASES[case]
    pt = make()
    A = build_dist_matrix(pt, n_devices=nd, symmetric=sym, local_format=fmt, device="cpu")
    path = str(tmp_path / "op.npz")
    save_dist_matrix(path, A)
    R = ref_load(path)
    x = np.random.default_rng(73).standard_normal(pt.nrows)
    want = A.from_dist(A.matvec(A.to_dist(x)))
    assert _rel(R.from_dist(jax.jit(lambda M, v: M.matvec(v))(R, R.to_dist(x))), want) <= REF_TOL


def test_solver_resume_converges_to_same_solution(tmp_path):
    """20 CG iterations, checkpoint x, resume to convergence: the solution
    of an uninterrupted solve (the reference's test :31)."""
    a = create_laplace_2d(12, 12)
    A = build_dist_matrix(a, n_devices=2, device="cpu")
    b = A.to_dist(gaussian_bump(a.nrows))
    mv = A.as_linear_operator()
    full = cg(mv, b, kmax=500, rtol=1e-10)
    part = cg(mv, b, kmax=20, rtol=1e-10)
    path = str(tmp_path / "state.npz")
    save_solver_state(path, A, part.x, iteration=int(part.iterations))
    vecs, it = load_solver_state(path, A)
    assert it == 20
    resumed = cg(mv, b, x0=vecs["x"], kmax=500, rtol=1e-10)
    assert resumed.converged
    x_full, x_res = A.from_dist(full.x), A.from_dist(resumed.x)
    assert np.linalg.norm(x_full - x_res) / np.linalg.norm(x_full) < 1e-7


def test_warm_resume_continues_krylov_sequence(tmp_path):
    """Saved (x, r, p) and rnorm0 continue the exact Krylov sequence:
    30 + 30 resumed iterations give the bits of 60 uninterrupted ones (the
    reference's test :56)."""
    a = create_laplace_2d(16, 16)
    A = build_dist_matrix(a, n_devices=4, symmetric=True, device="cpu")
    b = A.to_dist(gaussian_bump(a.nrows))
    op = A.as_linear_operator()
    full = cg(op, b, kmax=60, rtol=1e-30)
    half = cg(op, b, kmax=30, rtol=1e-30)
    path = str(tmp_path / "state.npz")
    save_solver_state(path, A, half.x, iteration=int(half.iterations), r=half.r, p=half.p)
    vecs, it = load_solver_state(path, A)
    assert it == 30 and set(vecs) == {"x", "r", "p"}
    resumed = cg(op, b, x0=vecs["x"], kmax=30, rtol=1e-30,
                 resume=(vecs["r"], vecs["p"], half.rnorm0))
    assert torch.equal(resumed.x, full.x)
    assert float(resumed.rnorm) == float(full.rnorm)


def test_two_tier_file_and_other_device_count_raise(tmp_path):
    """The reference's (2, 4) two-tier save raises NotImplementedError; a
    shard count other than the saved one raises, as the reference's loader
    does for a mesh of another size."""
    from jax.sharding import Mesh

    a = create_laplace_2d(24, 24)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dcn", "ici"))
    path2 = str(tmp_path / "two_tier.npz")
    ref_save(path2, ref_build(_ref(a), mesh=mesh))
    with open(path2 + ".meta.json") as f:
        assert json.load(f)["plan"]["type"] == "two_tier"
    with pytest.raises(NotImplementedError, match="two-tier"):
        load_dist_matrix(path2, device="cpu")
    A = build_dist_matrix(a, n_devices=4, device="cpu")
    path = str(tmp_path / "op.npz")
    save_dist_matrix(path, A)
    with pytest.raises(ValueError, match="4 shards; asked for 2"):
        load_dist_matrix(path, n_devices=2, device="cpu")
    assert load_dist_matrix(path, n_devices=4, device="cpu").n_devices == 4
