"""spmv_torch's matrix-powers kernel vs the spmv_tpu reference (mirrors of
``tests/test_powers.py``, and of ``test_gmres_sstep.py``'s window
alignment test).

The same host CSR goes through both packages' ``build_dist_matrix`` and
``build_powers_plan`` (the reference on the 8-device virtual CPU mesh).
The plan's tables are the reference's arrays: the ghost lists' exchange
tables, the ELL extended operator bit for bit, the DIA window data bit for
bit up to the reference's 1024-row padding (the port pads windows to 128
rows, what its DIA kernels take), and the ghost positions with the
reference's out-of-bounds padding sent to the spare position. The basis
equals s naive halo-exchanged matvecs to 1e-13 (float64) at np 1, 4 and
8, ELL and DIA, and the reference's basis to 1e-13.

The reference's HLO collective counts become counts of
``comm_plan.halo_gather`` calls (patched where ``dist_matrix`` and
``powers`` import it): s per block without the MPK, exactly 1 with it.
The reference's two-tier (dcn, ici) tests wait for the two-tier plan,
which the port does not have (ROADMAP.md); the port refuses such a plan.
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.parallel.powers import build_powers_plan as ref_powers_plan
from spmv_tpu.parallel.powers import chebyshev_powers_basis as ref_cheb_powers
from spmv_tpu.parallel.powers import powers_ghost_stats as ref_ghost_stats
from spmv_tpu.solvers.cg_sstep import cg_sstep as ref_cg_sstep

import spmv_torch.parallel.dist_matrix as pt_dist
import spmv_torch.parallel.powers as pt_powers
from spmv_torch.formats.csr import csr_matmul
from spmv_torch.gen import create_laplace_2d, gaussian_bump, random_csr
from spmv_torch.parallel.comm_plan import OOB
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.parallel.powers import (
    build_powers_plan,
    chebyshev_powers_basis,
    powers_ghost_stats,
)
from spmv_torch.solvers.cg_sstep import chebyshev_basis, cg_sstep
from spmv_torch.solvers.fsai import fsai_setup

C, E = 4.0, 4.2  # the reference tests' basis interval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_csr(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


def _both(a, n_dev, **kw):
    return (build_dist_matrix(a, n_devices=n_dev, device="cpu", **kw),
            ref_build(_ref_csr(a), n_devices=n_dev, **kw))


def _naive(A, x, s, c=C, e=E):
    """s halo-exchanged matvecs of the Chebyshev recurrence."""
    return chebyshev_basis(A.matvec, x, s, c, e)


def _ref_basis(a, R, x, s, c=C, e=E, **kw):
    rp = ref_powers_plan(_ref_csr(a), R, s=s, **kw)
    V = jax.jit(lambda p_, x_: ref_cheb_powers(p_, x_, c, e))(rp, R.to_dist(x))
    return rp, np.stack([R.from_dist(V[j]) for j in range(s + 1)])


@pytest.fixture
def gathers(monkeypatch):
    """Counts halo_gather calls of the matvec and of the MPK."""
    count = [0]
    orig = pt_dist.halo_gather

    def counted(*args, **kw):
        count[0] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(pt_dist, "halo_gather", counted)
    monkeypatch.setattr(pt_powers, "halo_gather", counted)
    return count


@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("n_dev,s", [(1, 4), (4, 2), (8, 4), (8, 8)])
def test_powers_basis_matches_naive(n_dev, s, fmt):
    """The one-exchange basis equals s halo-exchanged matvecs and the
    reference's basis (1e-13), also where the depth-s ghosts span several
    neighbour shards (8 shards of 72 rows, depth 8 reaching 192 rows)."""
    a = create_laplace_2d(24, 24)
    A, R = _both(a, n_dev, local_format=fmt)
    pp = build_powers_plan(a, A, s=s)
    assert pp.local_format == fmt
    x0 = gaussian_bump(a.nrows)
    x = A.to_dist(x0)
    V = chebyshev_powers_basis(pp, x, C, E)
    assert V.shape == (s + 1,) + tuple(x.shape)
    np.testing.assert_allclose(V.numpy(), _naive(A, x, s).numpy(), atol=1e-13)
    _, Vr = _ref_basis(a, R, x0, s)
    np.testing.assert_allclose(np.stack([A.from_dist(v) for v in V]), Vr, atol=1e-13)


def test_powers_basis_general_sparsity():
    """Random sparsity with off-band couplings: the BFS follows the actual
    pattern and the basis is exact."""
    a = random_csr(192, 192, 4, seed=3, symmetric=True, spd_shift=1.0)
    A, R = _both(a, 4)
    pp = build_powers_plan(a, A, s=3)
    x0 = np.random.default_rng(0).standard_normal(a.nrows)
    V = chebyshev_powers_basis(pp, A.to_dist(x0), 2.0, 2.5)
    np.testing.assert_allclose(V.numpy(), _naive(A, A.to_dist(x0), 3, 2.0, 2.5).numpy(),
                               atol=1e-12)
    _, Vr = _ref_basis(a, R, x0, 3, 2.0, 2.5)
    np.testing.assert_allclose(np.stack([A.from_dist(v) for v in V]), Vr, atol=1e-12)


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_powers_tables_match_reference(fmt):
    """The plan is the reference's: exchange tables, extended ELL bit for
    bit, DIA window data bit for bit up to the reference's padding, ghost
    positions (OOB padding -> the spare position), and the ghost stats."""
    a = create_laplace_2d(40, 40)
    A, R = _both(a, 4, local_format=fmt)
    pp = build_powers_plan(a, A, s=3)
    rp = ref_powers_plan(_ref_csr(a), R, s=3)
    assert pp.local_format == rp.local_format == fmt
    for name in ("send_idx", "recv_pos", "nlocal", "nghosts"):
        assert np.array_equal(getattr(pp.plan, name).numpy(),
                              np.asarray(getattr(rp.plan, name))), name
    assert (pp.plan.rounds, pp.plan.nghost_pad, pp.next_pad) == (
        tuple(rp.plan.rounds), rp.plan.nghost_pad, rp.next_pad)
    assert powers_ghost_stats(pp, A) == {
        **ref_ghost_stats(rp, R),
        **({"ext_rows_pad": pp.dia_rows, "ext_nnz_slots": len(pp.dia_offsets) * pp.dia_rows}
           if fmt == "dia" else {})}
    if fmt == "ell":
        assert np.array_equal(pp.colind.numpy(), np.asarray(rp.colind))
        assert np.array_equal(pp.values.numpy(), np.asarray(rp.values))
        return
    assert pp.dia_offsets == rp.dia_offsets and pp.gl_pad == rp.gl_pad
    L, Lr, k = pp.dia_rows, rp.dia_rows, len(pp.dia_offsets)
    assert L % 128 == 0 and L <= Lr
    ref_data = np.asarray(rp.dia_data).reshape(4, Lr // 128, k, 128)
    assert not ref_data[:, L // 128:].any()
    assert np.array_equal(pp.dia_data.numpy().reshape(4, L // 128, k, 128),
                          ref_data[:, : L // 128])
    rpos = np.asarray(rp.ghost_pos).astype(np.int64)
    assert np.array_equal(pp.ghost_pos.numpy(), np.where(rpos == int(OOB), L, rpos))


def test_powers_ghost_growth_linear_for_banded():
    a = create_laplace_2d(64, 64)
    A, R = _both(a, 8)
    st = powers_ghost_stats(build_powers_plan(a, A, s=4), A)
    assert st["nghost_pad_depth_s"] <= 5 * max(st["nghost_pad_depth_1"], 128)
    assert st == ref_ghost_stats(ref_powers_plan(_ref_csr(a), R, s=4), R)


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_powers_cg_sstep_end_to_end(fmt):
    """cg_sstep with the MPK basis: the naive build's count and the
    reference's, converged."""
    a = create_laplace_2d(24, 24)
    A, R = _both(a, 8, local_format=fmt)
    pp = build_powers_plan(a, A, s=4)
    b = gaussian_bump(a.nrows)
    kw = dict(s=4, kmax=400, rtol=1e-10)
    r1 = cg_sstep(A.as_linear_operator(), A.to_dist(b),
                  basis_builder=lambda r, c, e: chebyshev_powers_basis(pp, r, c, e), **kw)
    r2 = cg_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    rp = ref_powers_plan(_ref_csr(a), R, s=4)
    rr = jax.jit(lambda A_, p_, bb: ref_cg_sstep(
        A_.as_linear_operator(), bb,
        basis_builder=lambda r, c, e: ref_cheb_powers(p_, r, c, e), **kw))(
        R, rp, R.to_dist(b))
    assert r1.converged and r1.iterations == r2.iterations == int(rr.iterations)
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_powers_one_halo_gather_per_block(fmt, gathers):
    """The reference counts collective-permutes in its loop body; here the
    halo gathers: a basis costs s of them without the MPK and exactly one
    with it, at D = 4, and a cg_sstep solve with given bounds one per block
    plus its first and final residuals (s per block without the MPK)."""
    s = 4
    a = create_laplace_2d(64, 64)
    A = build_dist_matrix(a, n_devices=4, local_format=fmt, device="cpu")
    pp = build_powers_plan(a, A, s=s)
    x = A.to_dist(gaussian_bump(a.nrows))
    gathers[0] = 0
    _naive(A, x, s)
    assert gathers[0] == s
    gathers[0] = 0
    chebyshev_powers_basis(pp, x, C, E)
    assert gathers[0] == 1
    for builder, per_block in ((lambda r, c, e: chebyshev_powers_basis(pp, r, c, e), 1),
                               (None, s)):
        gathers[0] = 0
        res = cg_sstep(A.as_linear_operator(), x, s=s, kmax=32, rtol=1e-30,
                       lambda_bounds=(0.0, 8.0), basis_builder=builder)
        assert res.iterations == 32 and gathers[0] == 8 * per_block + 2, gathers[0]


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_powers_refuses_a_two_tier_plan(fmt):
    """The reference's two-tier tests (``test_powers_basis_two_tier_mesh``,
    ``test_powers_basis_dia_two_tier``) wait for the port's two-tier plan:
    an operator whose plan is not a one-axis CommPlan is refused."""
    import dataclasses

    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=4, local_format=fmt, device="cpu")

    @dataclasses.dataclass
    class TwoTier:
        n_dcn: int = 2
        n_ici: int = 2

    with pytest.raises(NotImplementedError, match="two-tier"):
        build_powers_plan(a, dataclasses.replace(A, plan=TwoTier()), s=4)


def test_powers_split_preconditioned_cacg():
    """Fully communication-avoiding preconditioned CG: the FSAI split
    operator G A G^T formed on the host, its powers plan, fewer iterations
    than unpreconditioned s-step CG, the true solution."""
    a = create_laplace_2d(24, 24)
    g = fsai_setup(a)
    m = csr_matmul(csr_matmul(g, a), g.transpose())
    M = build_dist_matrix(m, n_devices=4, device="cpu")
    G = build_dist_matrix(g, n_devices=4, device="cpu")
    ppm = build_powers_plan(m, M, s=4)
    b = gaussian_bump(a.nrows)
    res = cg_sstep(M.as_linear_operator(), G.matvec(M.to_dist(b)), s=4, kmax=400, rtol=1e-10,
                   basis_builder=lambda r, c, e: chebyshev_powers_basis(ppm, r, c, e))
    x = M.from_dist(G.transposed().matvec(res.x))
    assert res.converged
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-8
    A = build_dist_matrix(a, n_devices=4, device="cpu")
    plain = cg_sstep(A.as_linear_operator(), A.to_dist(b), s=4, kmax=400, rtol=1e-10)
    assert res.iterations < plain.iterations


@pytest.mark.parametrize("n_dev,s", [(1, 4), (4, 3), (8, 4)])
def test_powers_basis_dia_matches_ell(n_dev, s):
    """The DIA window realization equals the ELL one and the naive
    recurrence."""
    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia", device="cpu")
    pp = build_powers_plan(a, A, s=s)
    ppe = build_powers_plan(a, A, s=s, local_format="ell")
    assert (pp.local_format, ppe.local_format) == ("dia", "ell")
    x = A.to_dist(gaussian_bump(a.nrows))
    V = chebyshev_powers_basis(pp, x, C, E)
    np.testing.assert_allclose(V.numpy(), chebyshev_powers_basis(ppe, x, C, E).numpy(),
                               atol=1e-13)
    np.testing.assert_allclose(V.numpy(), _naive(A, x, s).numpy(), atol=1e-13)


def test_powers_dia_window_alignment(monkeypatch):
    """The windows are padded to 128 rows (the port's DIA kernels take any
    multiple of 128 starting on 16 bytes, ``_check_aligned``) where the
    reference pads to 1024 for its Pallas gate; the owned results do not
    depend on it: a 1024-row window gives the same bits. Each basis step
    is one stacked DIA apply for all shards."""
    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=4, local_format="dia", device="cpu")
    pp = build_powers_plan(a, A, s=3)
    assert pp.local_format == "dia" and pp.dia_rows % 128 == 0
    assert pp.dia_data.shape == (4, pp.dia_rows // 128, len(pp.dia_offsets) * 128)
    x = A.to_dist(gaussian_bump(a.nrows))
    calls = []
    orig = pt_powers.spmv_dia_stacked

    def counted(data, x2, offsets, symmetric):
        calls.append((tuple(data.shape), tuple(x2.shape), symmetric))
        return orig(data, x2, offsets, symmetric)

    monkeypatch.setattr(pt_powers, "spmv_dia_stacked", counted)
    V = chebyshev_powers_basis(pp, x, C, E)
    assert calls == [(tuple(pp.dia_data.shape), (4 * pp.dia_rows // 128, 128), False)] * 3
    monkeypatch.setattr(pt_powers, "WINDOW_ALIGN", 1024)
    pp1024 = build_powers_plan(a, A, s=3)
    assert pp1024.dia_rows % 1024 == 0 and pp1024.dia_rows > pp.dia_rows
    assert torch.equal(chebyshev_powers_basis(pp1024, x, C, E), V)


def test_powers_apply_calls_no_scatter_add(monkeypatch):
    """The ghosts land by placement (padding on a spare position), never
    by a scatter-add, in both realizations."""
    def refuse(*args, **kwargs):
        raise AssertionError("the MPK called a scatter-add")

    a = create_laplace_2d(24, 24)
    plans = []
    for fmt in ("ell", "dia"):
        A = build_dist_matrix(a, n_devices=4, local_format=fmt, device="cpu")
        plans.append((A, build_powers_plan(a, A, s=4)))
    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                        (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)
    for A, pp in plans:
        V = chebyshev_powers_basis(pp, A.to_dist(gaussian_bump(a.nrows)), C, E)
        assert torch.isfinite(V).all()


def test_powers_dia_strict_and_auto_fallback():
    """Scrambled sparsity: strict "dia" raises, "auto" on an ELL operator
    is ELL, and its basis is exact."""
    n = 256
    a = random_csr(n, n, 6, seed=11, symmetric=True, spd_shift=1.0)
    A = build_dist_matrix(a, n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="distinct diagonals"):
        build_powers_plan(a, A, s=2, local_format="dia")
    pp = build_powers_plan(a, A, s=2)
    assert pp.local_format == "ell"
    x = A.to_dist(np.random.default_rng(7).standard_normal(n))
    np.testing.assert_allclose(chebyshev_powers_basis(pp, x, 2.0, 2.5).numpy(),
                               _naive(A, x, 2, 2.0, 2.5).numpy(), atol=1e-12)


def test_powers_dia_auto_falls_back_past_64_diagonals():
    """A DIA operator of 81 diagonals (assembled with dia_max_diags=128):
    its windows have more than 64, so "auto" falls back to ELL, as the
    reference's does, and the basis stays exact."""
    from spmv_torch.formats.csr import CSRHost

    n = 512
    offs = np.arange(-40, 41)
    rows = np.repeat(np.arange(n), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    vals = np.where(cols[keep] == rows[keep], 200.0, -1.0)
    a = CSRHost.from_coo(rows[keep], cols[keep], vals, n, n)
    A, R = _both(a, 4, local_format="dia", dia_max_diags=128)
    pp = build_powers_plan(a, A, s=2)
    assert pp.local_format == ref_powers_plan(_ref_csr(a), R, s=2).local_format == "ell"
    x = A.to_dist(np.random.default_rng(5).standard_normal(n))
    np.testing.assert_allclose(chebyshev_powers_basis(pp, x, 200.0, 150.0).numpy(),
                               _naive(A, x, 2, 200.0, 150.0).numpy(), atol=1e-12)


def test_powers_dia_cg_sstep_end_to_end():
    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=8, local_format="dia", device="cpu")
    pp = build_powers_plan(a, A, s=4)
    assert pp.local_format == "dia"
    b = gaussian_bump(a.nrows)
    r1 = cg_sstep(A.as_linear_operator(), A.to_dist(b), s=4, kmax=400, rtol=1e-10,
                  basis_builder=lambda r, c, e: chebyshev_powers_basis(pp, r, c, e))
    assert r1.converged
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9


def test_powers_symmetric_storage_and_float32():
    """A symmetric-storage DIA operator (its plan from the full host
    matrix, the windows vanilla DIA) and float32 windows: the basis
    matches the naive one (float32: 1e-5 relative)."""
    a = create_laplace_2d(32, 32)
    for kw, tol in ((dict(symmetric=True), 1e-13), (dict(dtype=np.float32), 1e-5)):
        A = build_dist_matrix(a, n_devices=4, local_format="dia", device="cpu", **kw)
        pp = build_powers_plan(a, A, s=4)
        assert pp.local_format == "dia" and pp.dia_data.dtype == A.dtype
        x = A.to_dist(gaussian_bump(a.nrows).astype(np.float32 if kw.get("dtype") else float))
        V, Vn = chebyshev_powers_basis(pp, x, C, E), _naive(A, x, 4)
        assert float(torch.linalg.norm(V - Vn) / torch.linalg.norm(Vn)) < tol


def test_powers_plan_validation():
    a = create_laplace_2d(8, 8)
    A = build_dist_matrix(a, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="s must be"):
        build_powers_plan(a, A, s=0)
    with pytest.raises(ValueError, match="local_format"):
        build_powers_plan(a, A, s=2, local_format="well")
    rect = random_csr(64, 32, 3, seed=1)
    Ar = build_dist_matrix(rect, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="square"):
        build_powers_plan(rect, Ar, s=2)



@pytest.mark.parametrize("extra", [
    ["--dia"], ["--format", "ell", "--symmetric"],
    ["--dia", "--solver", "gmres", "--newton", "16"], ["--solver", "gmres"]])
def test_demo_cg_mpk_matches_reference_demo(extra, capsys, monkeypatch):
    """demo_cg --sstep 4 --mpk --devices 4 (s-step CG, and CA-GMRES with
    the Chebyshev or the Newton basis) against the reference demo: the
    same convergence and iterations, the printed residuals within 1e-8 of
    the solution norm, the solution norms within 1e-10 relative."""
    from test_torch_krylov import run_both_demos

    common = ["--lap2d", "24", "--kmax", "600", "--rtol", "1e-8", "--sstep", "4", "--mpk",
              "--devices", "4", *extra]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    assert port[0] and ref[0] and port[1] == ref[1]
    assert abs(port[2] - ref[2]) <= 1e-8 * ref[3]
    assert abs(port[3] - ref[3]) <= 1e-10 * ref[3]
