"""spmv_torch's SPAI and FSAI preconditioners vs the spmv_tpu reference.

The numpy setups are the reference's carried across, so their CSR must be
bit for bit the reference's (structure and values) on the reference tests'
operators. The preconditioners are DistMatrix operators built on A's own
format settings (``_rebuild_kwargs``): on a DIA or WELL operator they run
the DIA or WELL apply, and they must cut iterations below Jacobi's, as the
reference's tests show, with the same counts as the reference's own
preconditioned solves on the mesh. The demo runs hold ``demo_cg --spai``
and ``--fsai`` against the reference demo's printed lines.
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.solvers.cg import cg as ref_cg
from spmv_tpu.solvers.fsai import fsai_preconditioner as ref_fsai_preconditioner
from spmv_tpu.solvers.fsai import fsai_setup as ref_fsai_setup
from spmv_tpu.solvers.gmres import gmres as ref_gmres
from spmv_tpu.solvers.spai import spai_preconditioner as ref_spai_preconditioner
from spmv_tpu.solvers.spai import spai_setup as ref_spai_setup

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch.corpus import fem_p1_2d
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.reorder import rcm_reorder
from spmv_torch.solvers.cg import cg
from spmv_torch.solvers.fsai import fsai_preconditioner, fsai_setup
from spmv_torch.solvers.gmres import gmres
from spmv_torch.solvers.spai import spai_preconditioner, spai_setup
from test_torch_krylov import run_both_demos
from test_torch_transpose import convection_diffusion_2d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(a):
    return ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)


def _same_csr(got, want):
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for name in ("rowptr", "colind", "values"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def _nonsym(n, seed, dom=1.2, k=5):
    """The reference SPAI tests' random non-symmetric operator."""
    dense = pt_gen.random_csr(n, n, k, seed=seed).to_dense()
    np.fill_diagonal(dense, np.abs(dense).sum(axis=1) * dom + 0.5)
    return pt_csr.CSRHost.from_dense(dense)


def _spd_general(n, seed, shift=None):
    """The reference FSAI tests' scrambled SPD operator B B^T + s I."""
    b = pt_gen.random_csr(n, n, nnz_per_row=4, seed=seed).to_dense()
    d = b @ b.T + (shift if shift is not None else 0.5 * n ** 0.5) * np.eye(n)
    d[np.abs(d) < 1e-13] = 0.0
    return pt_csr.CSRHost.from_dense(d)


def _singular_column():
    dense = np.diag(np.arange(1.0, 31.0))
    dense[:, 7] = 0.0
    dense[7, 8] = 1.0
    return pt_csr.CSRHost.from_dense(dense)


def _weak_scaled():
    dense = _nonsym(200, seed=29, dom=0.9).to_dense()
    w = np.logspace(-1.5, 1.5, 200)
    return pt_csr.CSRHost.from_dense(dense * w[:, None] * w[None, :])


SPAI_CASES = {
    "random": (lambda: _nonsym(150, seed=11), 1),
    "convection-diffusion": (lambda: convection_diffusion_2d(18), 1),
    "convection-diffusion float32": (
        lambda: (lambda a: pt_csr.CSRHost(a.rowptr, a.colind, a.values.astype(np.float32),
                                          a.ncols))(convection_diffusion_2d(12)), 1),
    "weak-scaled level 2": (_weak_scaled, 2),
    "singular column": (_singular_column, 1),
}


@pytest.mark.parametrize("case", list(SPAI_CASES))
def test_spai_setup_matches_reference(case):
    make, level = SPAI_CASES[case]
    a = make()
    m = spai_setup(a, pattern_level=level)
    _same_csr(m, ref_spai_setup(_ref(a), pattern_level=level))
    if case == "singular column":
        assert np.all(np.isfinite(m.values)) and not m.to_dense()[:, 7].any()


FSAI_CASES = {
    "laplace2d": lambda: pt_gen.create_laplace_2d(16, 16),
    "spd-general": lambda: _spd_general(96, seed=23, shift=12.0),
    "fem rcm float32": lambda: (lambda a: pt_csr.CSRHost(
        a.rowptr, a.colind, a.values.astype(np.float32), a.ncols))(
            rcm_reorder(fem_p1_2d(2000), keep_best=True)[0]),
    "missing diagonal": lambda: pt_csr.CSRHost.from_dense(
        np.diag(np.r_[np.arange(1.0, 11.0), 0.0, np.arange(12.0, 21.0)])
        + np.diag(np.full(19, 0.1), -1) + np.diag(np.full(19, 0.1), 1)),
}


@pytest.mark.parametrize("case", list(FSAI_CASES))
def test_fsai_setup_matches_reference(case):
    a = FSAI_CASES[case]()
    g = fsai_setup(a)
    _same_csr(g, ref_fsai_setup(_ref(a)))
    gd = g.to_dense()
    assert np.all(np.isfinite(gd)) and not np.triu(gd, 1).any()


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_spai_gmres_beats_jacobi(fmt, n_dev):
    """SPAI-GMRES on the convection-diffusion operator (constant diagonal:
    Jacobi is a rescale) takes fewer Arnoldi steps than Jacobi-GMRES and
    the reference's own SPAI solve's count; M is built in A's format."""
    a = convection_diffusion_2d(18)
    P = build_dist_matrix(a, n_devices=n_dev, dtype=np.float64, local_format=fmt,
                          device="cpu")
    R = ref_build(_ref(a), n_devices=n_dev, dtype=np.float64, local_format=fmt)
    b = np.random.default_rng(24).standard_normal(a.nrows)
    kw = dict(restart=40, max_cycles=30, rtol=1e-9)
    spai = gmres(P.as_linear_operator(), P.to_dist(b), preconditioner=spai_preconditioner(P),
                 **kw)
    jac = gmres(P.as_linear_operator(), P.to_dist(b),
                preconditioner=P.jacobi_preconditioner(), **kw)
    ref = jax.jit(lambda A_, bb: ref_gmres(A_.as_linear_operator(), bb,
                                           preconditioner=ref_spai_preconditioner(R),
                                           **kw))(R, R.to_dist(b))
    assert spai.converged and spai.iterations < jac.iterations
    assert spai.iterations == int(ref.iterations)
    x = P.from_dist(spai.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("fmt", ["dia", "well"])
def test_fsai_pcg_beats_jacobi(fmt, n_dev):
    """FSAI-PCG (G and its cached transpose in A's format) on a Laplacian
    with a varying diagonal takes fewer iterations than Jacobi-PCG, the
    same count as the reference's FSAI-PCG, and the apply is G^T (G r)."""
    a = pt_gen.create_laplace_2d(24, 24)
    rows = np.repeat(np.arange(a.nrows), a.row_nnz())
    a.values[a.colind == rows] *= 1.0 + rows[a.colind == rows] % 5
    P = build_dist_matrix(a, n_devices=n_dev, dtype=np.float64, local_format=fmt,
                          device="cpu")
    R = ref_build(_ref(a), n_devices=n_dev, dtype=np.float64, local_format=fmt)
    b = np.random.default_rng(13).standard_normal(a.nrows)
    prec = fsai_preconditioner(P)
    f = cg(P.as_linear_operator(), P.to_dist(b), kmax=600, rtol=1e-10, preconditioner=prec)
    j = cg(P.as_linear_operator(), P.to_dist(b), kmax=600, rtol=1e-10,
           preconditioner=P.jacobi_preconditioner())
    ref = jax.jit(lambda A_, bb: ref_cg(A_.as_linear_operator(), bb, kmax=600, rtol=1e-10,
                                        preconditioner=ref_fsai_preconditioner(R)))(
        R, R.to_dist(b))
    assert f.converged and f.iterations < j.iterations
    assert f.iterations == int(ref.iterations)
    g = fsai_setup(a).to_dense()
    r = np.random.default_rng(29).standard_normal(a.nrows)
    z = P.from_dist(prec(P.to_dist(r)))
    np.testing.assert_allclose(z, g.T @ (g @ r), rtol=1e-12, atol=1e-13)


def test_preconditioners_inherit_the_format():
    """M and G are built with A's rebuild arguments: a DIA operator's
    preconditioners are DIA operators, a WELL operator's WELL ones (G^T too),
    never symmetric storage; an operator without its host matrix refuses."""
    a = pt_gen.create_laplace_2d(20, 20)
    for fmt in ("dia", "well"):
        A = build_dist_matrix(a, n_devices=2, symmetric=True, dtype=np.float32,
                              local_format=fmt, device="cpu")
        for prec in (spai_preconditioner(A), fsai_preconditioner(A)):
            assert all(op.local_format == fmt and not op.symmetric
                       for op in prec.operators)
    del A._host_csr
    with pytest.raises(ValueError, match="host matrix"):
        spai_preconditioner(A)
    with pytest.raises(ValueError, match="host matrix"):
        fsai_preconditioner(A)


@pytest.mark.parametrize("flags", [["--spai", "--solver", "gmres"],
                                   ["--spai", "2", "--solver", "bicgstab"],
                                   ["--fsai", "--dia"], ["--fsai", "--solver", "minres"]])
def test_demo_cg_spai_fsai_match_reference_demo(flags, capsys, monkeypatch):
    """demo_cg --spai [L] and --fsai against the reference demo on the same
    operator: the same convergence and iterations, the printed residual
    within 1e-8 and the solution norm within 1e-10 relative."""
    common = ["--lap2d", "24", "--devices", "2", "--kmax", "600", *flags]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    assert port[0] and port[:2] == ref[:2]
    assert abs(port[2] - ref[2]) <= 1e-8 * port[3] and port[2] < 1e-6
    assert abs(port[3] - ref[3]) <= 1e-10 * ref[3]


def test_fsai_preconditioner_relayouts_between_well_geometries():
    """A symmetric dual-WELL FEM operator and the vanilla WELL G pad their
    shards to different group counts: the apply re-pads r into G's layout
    and z back into A's, and still equals G^T (G r) on the host; FSAI-PCG
    then beats Jacobi-PCG."""
    a, _ = rcm_reorder(fem_p1_2d(5000), keep_best=True)
    A = build_dist_matrix(a, n_devices=2, symmetric=True, dtype=np.float64,
                          local_format="well", device="cpu")
    prec = fsai_preconditioner(A)
    G, Gt = prec.operators
    assert {G.row_pad, Gt.row_pad, G.col_pad} != {A.row_pad}
    g = fsai_setup(a)
    r = np.random.default_rng(31).standard_normal(a.nrows)
    z = prec(A.to_dist(r))
    assert z.shape == A.to_dist(r).shape
    want = g.transpose().matvec(g.matvec(r))
    assert np.linalg.norm(A.from_dist(z) - want) <= 1e-12 * np.linalg.norm(want)
    b = A.to_dist(np.random.default_rng(32).standard_normal(a.nrows))
    f = cg(A.matvec, b, kmax=3000, rtol=1e-8, preconditioner=prec)
    j = cg(A.matvec, b, kmax=3000, rtol=1e-8, preconditioner=A.jacobi_preconditioner())
    assert f.converged and f.iterations < j.iterations
