"""spmv_torch's s-step solvers vs the spmv_tpu reference: arnoldi, cg_sstep,
newton_basis and gmres_sstep (mirrors of ``tests/test_arnoldi.py``,
``test_cg_sstep.py``, ``test_newton_basis.py`` and ``test_gmres_sstep.py``).

The same numpy-seeded inputs go through both packages: dense operators as
a torch and a jnp matvec, distributed ones through both
``build_dist_matrix`` (the reference on the 8-device virtual CPU mesh,
under jit). Tolerances: float64 s-step counts equal the reference's;
solutions agree to 1e-8 relative (float64), Ritz values to 1e-8; the numpy
Newton functions bit for bit. Ritz values are compared after
``modified_leja`` ordering, never in the raw order of ``eigvals``.

The reference's HLO-counting tests become counts here: ``host_sync`` (the
s-step solvers' only device-to-host read) is patched to count, one per
s-block of ``cg_sstep`` and of ``gmres_sstep``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.solvers.newton_basis as ref_nb
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build
from spmv_tpu.parallel.powers import build_powers_plan as ref_powers_plan
from spmv_tpu.parallel.powers import newton_powers_basis as ref_newton_powers
from spmv_tpu.solvers.arnoldi import arnoldi_factorization as ref_arnoldi_factorization
from spmv_tpu.solvers.arnoldi import arnoldi_ritz as ref_arnoldi_ritz
from spmv_tpu.solvers.cg_sstep import cg_sstep as ref_cg_sstep
from spmv_tpu.solvers.gmres_sstep import gmres_sstep as ref_gmres_sstep

import spmv_torch.formats.csr as pt_csr
import spmv_torch.solvers.cg_sstep as pt_cg_sstep
import spmv_torch.solvers.gmres_sstep as pt_gmres_sstep
import spmv_torch.solvers.newton_basis as pt_nb
from spmv_torch.gen import create_laplace_1d, create_laplace_2d, gaussian_bump
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.parallel.powers import build_powers_plan, newton_powers_basis
from spmv_torch.solvers.arnoldi import arnoldi_factorization, arnoldi_ritz
from spmv_torch.solvers.cg import cg, cg_residual_history
from spmv_torch.solvers.cg_sstep import cg_sstep
from spmv_torch.solvers.gmres import gmres
from spmv_torch.solvers.gmres_sstep import gmres_sstep
from test_torch_transpose import convection_diffusion_2d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _dense(dense, dtype=np.float64):
    """The same dense operator as a torch and a jnp matvec."""
    d = np.asarray(dense, dtype)
    dt, dj = torch.as_tensor(d), jnp.asarray(d)
    return (lambda v: dt @ v), (lambda v: dj @ v)


def _ref_csr(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


def _both(pt, n_dev, **kw):
    """The port's and the reference's DistMatrix of one host CSR."""
    return (build_dist_matrix(pt, n_devices=n_dev, device="cpu", **kw),
            ref_build(_ref_csr(pt), n_devices=n_dev, **kw))


def _skew_transport(n: int, gamma: float, rho: float):
    """gamma I + rho (central difference): the reference test's off-axis
    operator (spectrum gamma +- 2 rho i cos(k pi / (n+1))), vectorized."""
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([np.full(n, gamma), np.full(n - 1, rho), np.full(n - 1, -rho)])
    return pt_csr.CSRHost.from_coo(rows, cols, vals.astype(float), n, n)


def _leja(values):
    return pt_nb.modified_leja(values)


@pytest.fixture
def syncs(monkeypatch):
    """Counts ``host_sync`` calls of both s-step solvers."""
    count = [0]
    orig = pt_cg_sstep.host_sync

    def counted(t):
        count[0] += 1
        return orig(t)

    monkeypatch.setattr(pt_cg_sstep, "host_sync", counted)
    monkeypatch.setattr(pt_gmres_sstep, "host_sync", counted)
    return count


# ----------------------------------------------------------------- arnoldi

def test_arnoldi_extreme_ritz_match_known_spectrum():
    """Diagonal plus a small perturbation: the extreme Ritz values match
    the eigenvalues and the reference's to 1e-10, with small certificates."""
    rng = np.random.default_rng(11)
    n = 300
    dense = np.diag(np.linspace(1.0, 50.0, n)) + 0.01 * rng.standard_normal((n, n))
    true = np.linalg.eigvals(dense)
    v0 = rng.standard_normal(n)
    mv, mvj = _dense(dense)
    r = arnoldi_ritz(mv, torch.as_tensor(v0), m=60)
    rr = ref_arnoldi_ritz(mvj, jnp.asarray(v0), m=60)
    np.testing.assert_allclose(r.spectral_radius, np.abs(true).max(), rtol=1e-6)
    np.testing.assert_allclose(r.rightmost.real, true.real.max(), rtol=1e-6)
    assert r.residuals[0] < 1e-4 * r.spectral_radius
    np.testing.assert_allclose(r.spectral_radius, rr.spectral_radius, rtol=1e-10)
    np.testing.assert_allclose(r.rightmost, rr.rightmost, rtol=1e-10)
    assert r.steps == rr.steps


def test_arnoldi_complex_pair():
    """A rotation-dominated block: the dominant complex pair surfaces, as
    in the reference's run (its Leja-ordered values within 1e-8)."""
    rng = np.random.default_rng(13)
    n = 120
    dense = 0.05 * rng.standard_normal((n, n)) + 2.0 * np.eye(n)
    dense[0, 1], dense[1, 0] = -5.0, 5.0  # eigenpair ~ 2 +- 5i
    v0 = rng.standard_normal(n)
    mv, mvj = _dense(dense)
    r = arnoldi_ritz(mv, torch.as_tensor(v0), m=50)
    rr = ref_arnoldi_ritz(mvj, jnp.asarray(v0), m=50)
    top2 = r.values[:2]
    assert abs(top2[0].imag) > 4.5
    np.testing.assert_allclose(sorted(top2.imag), [-abs(top2[0].imag), abs(top2[0].imag)],
                               rtol=1e-6)
    np.testing.assert_allclose(r.spectral_radius, np.abs(np.linalg.eigvals(dense)).max(),
                               rtol=1e-5)
    np.testing.assert_allclose(_leja(r.values)[:8], _leja(rr.values)[:8], rtol=1e-8)


def test_arnoldi_lucky_breakdown_exact():
    """Minimal polynomial degree 4: the process breaks down at the
    reference's step, the certificates are zero and the Ritz values the
    restriction's (to the defective eigenvalue's eps^(1/4) sensitivity)."""
    n = 96
    nil = np.zeros((n, n))
    for i in range(0, n - 3, 4):
        nil[i, i + 1] = nil[i + 1, i + 2] = nil[i + 2, i + 3] = 1.0
    dense = 3.0 * np.eye(n) + nil
    v0 = np.random.default_rng(17).standard_normal(n)
    mv, mvj = _dense(dense)
    r = arnoldi_ritz(mv, torch.as_tensor(v0), m=40)
    rr = ref_arnoldi_ritz(mvj, jnp.asarray(v0), m=40)
    assert r.steps <= 5 and r.steps == rr.steps
    np.testing.assert_allclose(r.residuals, 0.0, atol=1e-10)
    np.testing.assert_allclose(r.values.real, 3.0, rtol=2e-4)
    np.testing.assert_allclose(r.values.imag, 0.0, atol=2e-4)


def test_arnoldi_factorization_relation():
    """The Hessenberg equals the reference's to 1e-10 and reproduces the
    moments v0^T A^k v0 = |v0|^2 (H^k)[0, 0]."""
    rng = np.random.default_rng(19)
    n, m = 80, 20
    dense = rng.standard_normal((n, n)) / np.sqrt(n) + np.eye(n)
    v0 = rng.standard_normal(n)
    mv, mvj = _dense(dense)
    h = arnoldi_factorization(mv, torch.as_tensor(v0), m).numpy()
    hr = np.asarray(jax.jit(lambda v: ref_arnoldi_factorization(mvj, v, m))(jnp.asarray(v0)))
    assert h.shape == hr.shape == (m + 1, m)
    np.testing.assert_allclose(h, hr, atol=1e-10)
    hk, nrm2, vk = h[:m, :m], float(v0 @ v0), v0.copy()
    for k in range(1, 6):
        vk = dense @ vk
        np.testing.assert_allclose(float(v0 @ vk), nrm2 * np.linalg.matrix_power(hk, k)[0, 0],
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_arnoldi_distributed(n_dev):
    """On the stacked convection-diffusion operator: the extremes match
    the host eig and the reference's run on the mesh."""
    a = convection_diffusion_2d(14)
    A, R = _both(a, n_dev)
    v0 = np.random.default_rng(23).standard_normal(a.nrows)
    r = arnoldi_ritz(A.as_linear_operator(), A.to_dist(v0), m=60)
    rr = ref_arnoldi_ritz(R.as_linear_operator(), R.to_dist(v0), m=60)
    want = np.linalg.eigvals(a.to_dense())
    np.testing.assert_allclose(r.spectral_radius, np.abs(want).max(), rtol=1e-4)
    np.testing.assert_allclose(r.rightmost.real, want.real.max(), rtol=1e-3)
    np.testing.assert_allclose(r.spectral_radius, rr.spectral_radius, rtol=1e-10)
    np.testing.assert_allclose(r.rightmost, rr.rightmost, rtol=1e-10)


# ---------------------------------------------------------------- cg_sstep

def _lap_dense(g, dtype=np.float64):
    a = create_laplace_2d(g, g)
    b = gaussian_bump(a.nrows).astype(dtype)
    return a, a.to_dense().astype(dtype), b


def _both_sstep(dense, b, **kw):
    """cg_sstep of both packages on one dense operator and b."""
    mv, mvj = _dense(dense, b.dtype)
    p = cg_sstep(mv, torch.as_tensor(b), **kw)
    r = jax.jit(lambda bb: ref_cg_sstep(mvj, bb, **kw))(jnp.asarray(b))
    return p, r


def _true_rel(dense, x, b, rnorm0=None):
    res = np.linalg.norm(dense @ np.asarray(x, np.float64) - b)
    return res / (float(rnorm0) if rnorm0 is not None else 1.0)


def test_sstep_s1_equals_cg():
    """s = 1 is CG: the same iterates to rounding, and the reference's
    count."""
    _a, dense, b = _lap_dense(16)
    mv, _ = _dense(dense)
    r1 = cg(mv, torch.as_tensor(b), kmax=400, rtol=1e-10)
    p, r = _both_sstep(dense, b, s=1, kmax=400, rtol=1e-10)
    assert p.converged and abs(p.iterations - r1.iterations) <= 1
    assert p.iterations == int(r.iterations)
    np.testing.assert_allclose(p.x.numpy(), r1.x.numpy(), atol=1e-10)


def test_sstep_block_matches_cg_prefix():
    """One s-block minimizes the A-norm error over s CG iterations' Krylov
    space: its true residual equals CG's |r_s| (1e-8), as the reference's."""
    _a, dense, b = _lap_dense(16)
    mv, _ = _dense(dense)
    _, hist = cg_residual_history(mv, torch.as_tensor(b), 8)
    for s in (2, 4, 8):
        p, r = _both_sstep(dense, b, s=s, kmax=s, rtol=1e-30)
        np.testing.assert_allclose(_true_rel(dense, p.x.numpy(), b), float(hist[s - 1]),
                                   rtol=1e-8)
        assert _rel(p.x.numpy(), np.asarray(r.x)) < 1e-8


@pytest.mark.parametrize("s", [2, 4, 8])
def test_sstep_converges_like_cg(s):
    """Within two blocks of CG's count and equal to the reference's; the
    reported rnorm is the true residual."""
    _a, dense, b = _lap_dense(24)
    mv, _ = _dense(dense)
    r1 = cg(mv, torch.as_tensor(b), kmax=600, rtol=1e-10)
    p, r = _both_sstep(dense, b, s=s, kmax=600, rtol=1e-10)
    assert p.converged and bool(r.converged)
    assert p.iterations <= r1.iterations + 2 * s
    assert p.iterations == int(r.iterations)
    assert _true_rel(dense, p.x.numpy(), b, p.rnorm0) < 1e-10
    # the reported rnorm is the true residual (the same matvec recomputed)
    np.testing.assert_allclose(float(p.rnorm), float(torch.linalg.norm(
        mv(p.x) - torch.as_tensor(b))), rtol=1e-6)
    assert _rel(p.x.numpy(), np.asarray(r.x)) < 1e-8


def test_sstep_explicit_bounds_and_x0():
    _a, dense, b = _lap_dense(16)
    x0 = np.full_like(b, 0.3)
    mv, mvj = _dense(dense)
    p = cg_sstep(mv, torch.as_tensor(b), x0=torch.as_tensor(x0), s=4, kmax=400, rtol=1e-10,
                 lambda_bounds=(0.0, 8.0))
    r = ref_cg_sstep(mvj, jnp.asarray(b), x0=jnp.asarray(x0), s=4, kmax=400, rtol=1e-10,
                     lambda_bounds=(0.0, 8.0))
    assert p.converged and p.iterations == int(r.iterations)
    assert _true_rel(dense, p.x.numpy(), b) < 1e-9


def test_sstep_fp32_reports_floor_honestly():
    """float32 floors above CG's residual: converged is the true-residual
    verdict, and rnorm the true float32 residual. Both packages stop on the
    floor (not converged); where each stops is rounding (148 and 164
    iterations here), so the floors agree within 10x."""
    _a, dense, b = _lap_dense(64, np.float32)
    p, r = _both_sstep(dense, b, s=4, kmax=600, rtol=1e-6)
    d32 = torch.as_tensor(dense)
    true = float(torch.linalg.norm(d32 @ p.x - torch.as_tensor(b)) / p.rnorm0)
    assert p.converged == (true < 1e-6) == bool(r.converged)
    np.testing.assert_allclose(float(p.rnorm) / float(p.rnorm0), true, rtol=1e-3)
    ref_floor = float(r.rnorm) / float(r.rnorm0)
    assert ref_floor / 10 < true < 10 * ref_floor


def test_sstep_fp32_high_kappa_divergence_safe():
    """Past the float32 envelope (kappa ~ 2.7e4, s = 8) the solver exits
    gracefully: finite x and rnorm, converged = the true verdict, never
    worse than 4 |r0|."""
    a = create_laplace_1d(512)
    dense = a.to_dense().astype(np.float32)
    b = gaussian_bump(a.nrows).astype(np.float32)
    p, r = _both_sstep(dense, b, s=8, kmax=400, rtol=1e-6)
    assert np.all(np.isfinite(p.x.numpy())) and np.isfinite(float(p.rnorm))
    true = float(torch.linalg.norm(torch.as_tensor(dense) @ p.x - torch.as_tensor(b))
                 / p.rnorm0)
    assert p.converged == (true < 1e-6) == bool(r.converged)
    assert float(p.rnorm) <= 4.0 * float(p.rnorm0) + 1e-6


def test_sstep_residual_replacement_lifts_fp32_floor():
    """replace_every=2 lifts the float32 floor (3x or more, as in the
    reference's run); float64 stays exact."""
    _a, dense, b = _lap_dense(48, np.float32)
    p0, _ = _both_sstep(dense, b, s=4, kmax=400, rtol=1e-7)
    p2, r2 = _both_sstep(dense, b, s=4, kmax=400, rtol=1e-7, replace_every=2)
    t0 = _true_rel(dense, p0.x.numpy(), b, p0.rnorm0)
    t2 = _true_rel(dense, p2.x.numpy(), b, p2.rnorm0)
    tr = _true_rel(dense, np.asarray(r2.x), b, r2.rnorm0)
    assert t2 < t0 / 3 and t2 < 3 * tr
    _a, d64, b64 = _lap_dense(16)
    pp, rr = _both_sstep(d64, b64, s=4, kmax=400, rtol=1e-10, replace_every=2)
    assert pp.converged and pp.iterations == int(rr.iterations)
    assert _true_rel(d64, pp.x.numpy(), b64) < 1e-9


def test_sstep_zero_rhs_no_nan():
    _a, dense, _b = _lap_dense(8)
    p, r = _both_sstep(dense, np.zeros(dense.shape[0]), s=4, kmax=40, rtol=1e-10)
    assert np.all(np.isfinite(p.x.numpy())) and p.x.numpy().max() == 0.0
    assert p.iterations == int(r.iterations)


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_sstep_distributed(n_dev):
    a = create_laplace_2d(16, 16)
    A, R = _both(a, n_dev)
    b = gaussian_bump(a.nrows)
    p = cg_sstep(A.as_linear_operator(), A.to_dist(b), s=4, kmax=400, rtol=1e-10)
    r = jax.jit(lambda A_, bb: ref_cg_sstep(A_.as_linear_operator(), bb, s=4, kmax=400,
                                            rtol=1e-10))(R, R.to_dist(b))
    x = A.from_dist(p.x)
    assert p.converged and p.iterations == int(r.iterations)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9
    assert _rel(x, R.from_dist(r.x)) < 1e-8


def test_sstep_fsai_split_preconditioned():
    """Split preconditioning (G A G^T) y = G b, x = G^T y with the FSAI
    factor: fewer iterations than unpreconditioned s-step CG, the true
    solution, and the reference's count."""
    from spmv_torch.solvers.fsai import fsai_setup

    a = create_laplace_2d(24, 24)
    g = fsai_setup(a)
    A, R = _both(a, 4)
    G, RG = _both(g, 4)
    Gt, RGt = G.transposed(), RG.transposed()
    b = gaussian_bump(a.nrows)
    res = cg_sstep(lambda v: G.matvec(A.matvec(Gt.matvec(v))), G.matvec(A.to_dist(b)), s=4,
                   kmax=400, rtol=1e-10)
    x = A.from_dist(Gt.matvec(res.x))
    assert res.converged
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-8
    plain = cg_sstep(A.as_linear_operator(), A.to_dist(b), s=4, kmax=400, rtol=1e-10)
    assert res.iterations < plain.iterations
    rres = jax.jit(lambda A_, G_, Gt_, bb: ref_cg_sstep(
        lambda v: G_.matvec(A_.matvec(Gt_.matvec(v))), G_.matvec(bb), s=4, kmax=400,
        rtol=1e-10))(R, RG, RGt, R.to_dist(b))
    assert res.iterations == int(rres.iterations)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_sstep_one_host_sync_per_block(n_dev, syncs):
    """The reference counts one all-reduce in its loop body (HLO); here:
    exactly one host sync per s-block (the Gram), plus the set-up reads
    (|r0|, the power-iteration lmax when no bounds are given) and the final
    residual. Plain CG syncs once per iteration."""
    a = create_laplace_2d(16, 16)
    A = build_dist_matrix(a, n_devices=n_dev, device="cpu")
    b = A.to_dist(gaussian_bump(a.nrows))
    for bounds, setup in (((0.0, 8.0), 1), (None, 2)):
        syncs[0] = 0
        res = cg_sstep(A.as_linear_operator(), b, s=4, kmax=48, rtol=1e-30,
                       lambda_bounds=bounds)
        blocks = res.iterations // 4
        assert blocks == 12 and syncs[0] == blocks + setup + 1, syncs[0]


# ------------------------------------------------------------- newton basis

def _newton_basis_dense(Ad, q, ops):
    vs = [q]
    for alpha, gamma, sigma in ops:
        w = Ad @ vs[-1] - alpha * vs[-1]
        if gamma:
            w = w + gamma * vs[-2]
        vs.append(w / sigma)
    return np.stack(vs, axis=1)


def test_modified_leja_properties():
    """The reference's invariants, and its output bit for bit."""
    rng = np.random.default_rng(0)
    re_, im = rng.standard_normal(6), np.abs(rng.standard_normal(6))
    pts = np.concatenate([re_ + 1j * im, re_ - 1j * im, rng.standard_normal(3) + 0j,
                          [re_[0] + 1j * im[0]]])
    out = pt_nb.modified_leja(pts)
    assert np.array_equal(out, ref_nb.modified_leja(pts))
    assert abs(abs(out[0]) - np.max(np.abs(pts))) < 1e-12
    j = 0
    while j < len(out):
        if abs(out[j].imag) > 1e-12:
            assert out[j + 1] == out[j].conjugate()
            j += 2
        else:
            j += 1
    assert len(out) == 15
    for p in out:
        assert np.min(np.abs(pts - p)) < 1e-9
    for cap in (1, 4, 7):
        assert np.array_equal(pt_nb.modified_leja(pts, cap), ref_nb.modified_leja(pts, cap))


def test_modified_leja_pairs_not_split_by_greedy():
    th = np.exp(1j * np.linspace(0.1, 1.4, 8)) * np.linspace(1, 3, 8)
    pts = np.concatenate([th, th.conj()])
    out = pt_nb.modified_leja(pts)
    assert np.array_equal(out, ref_nb.modified_leja(pts))
    ups = [p for p in out if p.imag > 1e-12]
    assert len(ups) == len(set(np.round(ups, 9).tolist())) and len(out) == 16


def test_newton_recurrence_matrix_exact():
    """Ops and B bit for bit; A V[:, :s] = V @ B to rounding."""
    n, s = 64, 6
    rng = np.random.default_rng(1)
    Ad = rng.standard_normal((n, n)) * 0.3 + np.diag(rng.standard_normal(n))
    ev = np.linalg.eigvals(Ad)
    assert np.max(np.abs(ev.imag)) > 0.1
    ops = pt_nb.newton_basis_ops(ev, s)
    assert ops == ref_nb.newton_basis_ops(ev, s)
    for dt in (np.float64, np.float32):
        B = pt_nb.newton_recurrence_matrix(ops, dt)
        assert np.array_equal(B, ref_nb.newton_recurrence_matrix(ops, dt)) and B.dtype == dt
    B = pt_nb.newton_recurrence_matrix(ops, np.float64)
    q = rng.standard_normal(n)
    V = _newton_basis_dense(Ad, q / np.linalg.norm(q), ops)
    assert np.linalg.norm(Ad @ V[:, :s] - V @ B) / np.linalg.norm(V @ B) < 1e-14
    assert np.linalg.cond(V) < 1e4


def test_newton_pair_cannot_straddle_block_end():
    shifts = np.array([1.0 + 2.0j, 1.0 - 2.0j, 3.0 + 1.0j, 3.0 - 1.0j])
    for s in (1, 2, 3, 5):
        ops = pt_nb.newton_basis_ops(shifts, s)
        assert ops == ref_nb.newton_basis_ops(shifts, s)
        assert len(ops) == s and ops[0][1] == 0.0
        assert pt_nb.newton_recurrence_matrix(ops, np.float64).shape == (s + 1, s)


def test_newton_vs_chebyshev_conditioning_off_axis():
    """On the spectrum 2 +- 10i the s = 8 Chebyshev basis is conditioned
    past 1e5, the Leja-Newton basis under 1e3 (the reference's claim)."""
    n, s = 256, 8
    Ad = _skew_transport(n, 2.0, 5.0).to_dense()
    ev = np.linalg.eigvals(Ad)
    q = np.random.default_rng(0).standard_normal(n)
    q /= np.linalg.norm(q)
    V = _newton_basis_dense(Ad, q, pt_nb.newton_basis_ops(ev, s))
    lam = float(np.max(np.abs(ev)))
    c = e = 1.1 * lam / 2
    ws = [q, (Ad @ q - c * q) / e]
    for _ in range(1, s):
        ws.append(2 * (Ad @ ws[-1] - c * ws[-1]) / e - ws[-2])
    assert np.linalg.cond(V) < 1e3 and np.linalg.cond(np.stack(ws, axis=1)) > 1e5


def _skew_system(n_dev=4, n=256):
    a = _skew_transport(n, 2.0, 5.0)
    A, R = _both(a, n_dev)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.nrows))
    return a, A, R, b


def test_gmres_sstep_newton_distributed():
    """Ritz shifts from a one-time Arnoldi harvest: converged, no more
    steps than the Chebyshev basis, the reference's Leja-ordered shifts and
    its count."""
    a, A, R, b = _skew_system()
    ritz = pt_nb.newton_shifts_from_operator(A.as_linear_operator(), A.to_dist(b), m=24)
    rritz = ref_nb.newton_shifts_from_operator(R.as_linear_operator(), R.to_dist(b), m=24)
    assert np.max(np.abs(ritz.imag)) > 1.0
    np.testing.assert_allclose(_leja(ritz), _leja(rritz), rtol=1e-8)
    kw = dict(s=8, restart=48, max_cycles=20, rtol=1e-8)
    rn = gmres_sstep(A.as_linear_operator(), A.to_dist(b), shifts=ritz, **kw)
    rc = gmres_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    ref = jax.jit(lambda A_, bb: ref_gmres_sstep(A_.as_linear_operator(), bb, shifts=rritz,
                                                 **kw))(R, R.to_dist(b))
    assert rn.converged and rn.iterations <= rc.iterations
    assert rn.iterations == int(ref.iterations)
    x = A.from_dist(rn.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("n_dev,s", [(1, 4), (8, 4)])
def test_newton_powers_basis_matches_naive(n_dev, s):
    """The one-exchange Newton MPK basis equals s halo-exchanged shifted
    matvecs and the reference's basis (1e-12), a conjugate pair included."""
    a = _skew_transport(192, 2.0, 5.0)
    A, R = _both(a, n_dev)
    pp = build_powers_plan(a, A, s=s)
    shifts = np.array([2.0 + 9.9j, 2.0 - 9.9j, 2.0 + 3.1j, 2.0 - 3.1j])
    ops = pt_nb.newton_basis_ops(shifts, s)
    assert any(g != 0.0 for _, g, _ in ops)
    x0 = np.random.default_rng(0).standard_normal(a.nrows)
    x = A.to_dist(x0)
    V = newton_powers_basis(pp, x, ops)
    vs = [x]
    for alpha, gamma, sigma in ops:
        w = A.matvec(vs[-1]) - alpha * vs[-1]
        if gamma:
            w = w + gamma * vs[-2]
        vs.append(w / sigma)
    assert V.shape == (s + 1,) + tuple(x.shape)
    np.testing.assert_allclose(V.numpy(), torch.stack(vs).numpy(), atol=1e-12)
    Vr = jax.jit(lambda p_, x_: ref_newton_powers(p_, x_, ops))(
        ref_powers_plan(_ref_csr(a), R, s=s), R.to_dist(x0))
    for j in range(s + 1):
        np.testing.assert_allclose(A.from_dist(V[j]), R.from_dist(Vr[j]), atol=1e-12)


def test_gmres_sstep_newton_mpk_end_to_end():
    """Ritz shifts plus the Newton MPK basis (one exchange a block):
    converged, true residual under rtol, the reference's count."""
    a, A, R, b = _skew_system()
    s = 4
    ritz = arnoldi_ritz(A.as_linear_operator(), A.to_dist(b), m=24).values
    ops = pt_nb.newton_basis_ops(ritz, s)
    pp = build_powers_plan(a, A, s=s)
    r = gmres_sstep(A.as_linear_operator(), A.to_dist(b), s=s, restart=48, max_cycles=20,
                    rtol=1e-8, shifts=ritz,
                    basis_builder=lambda q: newton_powers_basis(pp, q, ops))
    naive = gmres_sstep(A.as_linear_operator(), A.to_dist(b), s=s, restart=48, max_cycles=20,
                        rtol=1e-8, shifts=ritz)
    assert r.converged and r.iterations == naive.iterations
    x = A.from_dist(r.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-7
    rritz = ref_arnoldi_ritz(R.as_linear_operator(), R.to_dist(b), m=24).values
    rops = ref_nb.newton_basis_ops(rritz, s)
    rpp = ref_powers_plan(_ref_csr(a), R, s=s)
    rr = jax.jit(lambda p_, A_, bb: ref_gmres_sstep(
        A_.as_linear_operator(), bb, s=s, restart=48, max_cycles=20, rtol=1e-8,
        shifts=rritz, basis_builder=lambda q: ref_newton_powers(p_, q, rops)))(
        rpp, R, R.to_dist(b))
    assert r.iterations == int(rr.iterations)


def test_newton_basis_repeated_shifts_stay_conditioned():
    """Cyclic repetition keeps the capacity sigmas (the reference's ops bit
    for bit); column norms O(1), the basis conditioned."""
    ops = pt_nb.newton_basis_ops(np.array([1.0 + 0j]), 4)
    assert ops == ref_nb.newton_basis_ops(np.array([1.0 + 0j]), 4)
    assert all(abs(sig - 1.0) < 1e-12 for _, _, sig in ops)
    n = 64
    rng = np.random.default_rng(2)
    Ad = np.diag(np.linspace(0.5, 1.5, n)) + 0.05 * rng.standard_normal((n, n))
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    V = _newton_basis_dense(Ad, q, ops)
    norms = np.linalg.norm(V, axis=0)
    assert np.max(norms) < 1e2 and np.min(norms) > 1e-2 and np.linalg.cond(V) < 1e6
    pair = np.array([2.0 + 10.0j, 2.0 - 10.0j])
    ops6 = pt_nb.newton_basis_ops(pair, 6)
    assert ops6 == ref_nb.newton_basis_ops(pair, 6)
    assert np.min([sig for _, _, sig in ops6]) > 1.0
    V6 = _newton_basis_dense(_skew_transport(n, 2.0, 5.0).to_dense(), q, ops6)
    assert np.all(np.isfinite(V6)) and np.linalg.cond(V6) < 1e8


def test_newton_recurrence_matrix_rejects_leading_gamma():
    bad = ((1.0, 0.5, 1.0), (1.0, 0.0, 1.0))
    with pytest.raises(ValueError, match="gamma == 0"):
        pt_nb.newton_recurrence_matrix(bad, np.float64)
    a = _skew_transport(64, 2.0, 1.0)
    A = build_dist_matrix(a, n_devices=1, device="cpu")
    pp = build_powers_plan(a, A, s=2)
    with pytest.raises(ValueError, match="gamma == 0"):
        newton_powers_basis(pp, A.to_dist(np.ones(a.nrows)), bad)


def test_gmres_sstep_newton_ops_param():
    """Precomputed newton_ops with the MPK builder gives the shifts= path's
    bits; a wrong length raises."""
    a, A, _R, b = _skew_system()
    s = 4
    bb = A.to_dist(b)
    ritz = arnoldi_ritz(A.as_linear_operator(), bb, m=24).values
    ops = pt_nb.newton_basis_ops(ritz, s)
    pp = build_powers_plan(a, A, s=s)
    kw = dict(s=s, restart=48, max_cycles=20, rtol=1e-8,
              basis_builder=lambda q: newton_powers_basis(pp, q, ops))
    r_ops = gmres_sstep(A.as_linear_operator(), bb, newton_ops=ops, **kw)
    r_shifts = gmres_sstep(A.as_linear_operator(), bb, shifts=ritz, **kw)
    assert r_ops.converged and torch.equal(r_ops.x, r_shifts.x)
    x = A.from_dist(r_ops.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-7
    with pytest.raises(ValueError, match="newton_ops length"):
        gmres_sstep(A.as_linear_operator(), bb, s=3, newton_ops=ops)


def test_newton_basis_validation():
    with pytest.raises(ValueError, match="at least one finite"):
        pt_nb.modified_leja(np.array([np.nan + 0j]))
    with pytest.raises(ValueError, match="s must be"):
        pt_nb.newton_basis_ops(np.array([1.0 + 0j]), 0)
    a = _skew_transport(64, 2.0, 1.0)
    A = build_dist_matrix(a, n_devices=1, device="cpu")
    pp = build_powers_plan(a, A, s=3)
    ops = pt_nb.newton_basis_ops(np.array([1.0, 2.0, 3.0]), 2)
    with pytest.raises(ValueError, match="plan depth"):
        newton_powers_basis(pp, A.to_dist(np.ones(a.nrows)), ops)


# ------------------------------------------------------------- gmres_sstep

def _cd_system(g, n_dev, seed, fmt="ell"):
    a = convection_diffusion_2d(g)
    A, R = _both(a, n_dev, local_format=fmt)
    b = a.matvec(np.random.default_rng(seed).standard_normal(a.nrows))
    return a, A, R, b


def _ref_gmres_sstep(R, b, **kw):
    return jax.jit(lambda A_, bb: ref_gmres_sstep(A_.as_linear_operator(), bb, **kw))(
        R, R.to_dist(b))


def test_gmres_sstep_convection_diffusion_matches_gmres():
    """The same cycles as restarted GMRES, and the reference's steps."""
    a, A, R, b = _cd_system(20, 4, 0)
    kw = dict(restart=32, max_cycles=30, rtol=1e-10)
    r1 = gmres_sstep(A.as_linear_operator(), A.to_dist(b), s=4, **kw)
    r2 = gmres(A.as_linear_operator(), A.to_dist(b), **kw)
    ref = _ref_gmres_sstep(R, b, s=4, **kw)
    assert r1.converged and r2.converged and r1.cycles == r2.cycles
    assert (r1.iterations, r1.cycles) == (int(ref.iterations), int(ref.cycles))
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9
    assert _rel(x, R.from_dist(ref.x)) < 1e-8


@pytest.mark.parametrize("n_dev,s", [(1, 2), (8, 4)])
def test_gmres_sstep_spd_case(n_dev, s):
    a = create_laplace_2d(24, 24)
    A, R = _both(a, n_dev)
    b = gaussian_bump(a.nrows)
    kw = dict(s=s, restart=40, max_cycles=40, rtol=1e-8, lambda_bounds=(0.0, 8.0))
    r = gmres_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    ref = _ref_gmres_sstep(R, b, **kw)
    assert r.converged and r.iterations == int(ref.iterations)
    x = A.from_dist(r.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_gmres_sstep_mpk_basis(fmt):
    """The matrix-powers kernel supplies each block's basis (one exchange
    per s steps): the naive build's steps, converged."""
    from spmv_torch.parallel.powers import chebyshev_powers_basis

    a, A, R, b = _cd_system(20, 4, 1, fmt)
    pp = build_powers_plan(a, A, s=4)
    assert pp.local_format == fmt
    kw = dict(s=4, restart=32, max_cycles=30, rtol=1e-10)
    r1 = gmres_sstep(A.as_linear_operator(), A.to_dist(b),
                     basis_builder=lambda q, c, e: chebyshev_powers_basis(pp, q, c, e), **kw)
    r0 = gmres_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    assert r1.converged and r1.iterations == r0.iterations
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9


def test_gmres_sstep_one_host_sync_per_block(syncs):
    """The reference compares all-reduces per iteration in HLO (4 per s
    steps against 3 a step); here one host sync per block, plus |r0|, the
    power iteration, and one true residual per cycle, against standard
    GMRES's one sync per step."""
    a = create_laplace_2d(32, 32)
    A = build_dist_matrix(a, n_devices=8, device="cpu")
    b = A.to_dist(gaussian_bump(a.nrows))
    res = gmres_sstep(A.as_linear_operator(), b, s=4, restart=16, max_cycles=2, rtol=1e-30,
                      lambda_bounds=(0.0, 8.0))
    assert res.iterations == 32 and res.cycles == 2
    assert syncs[0] == res.iterations // 4 + 1 + res.cycles, syncs[0]


def test_gmres_sstep_restart_and_warm_resume():
    """Restarts make progress, and a saved x resumes the solve."""
    a, A, R, b = _cd_system(16, 2, 2)
    bb = A.to_dist(b)
    half = gmres_sstep(A.as_linear_operator(), bb, s=2, restart=8, max_cycles=2, rtol=1e-10)
    assert float(half.rnorm) < float(half.rnorm0)
    rest = gmres_sstep(A.as_linear_operator(), bb, x0=half.x, s=2, restart=8, max_cycles=40,
                       rtol=1e-10)
    assert rest.converged
    x = A.from_dist(rest.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9
    ref = _ref_gmres_sstep(R, b, s=2, restart=8, max_cycles=2, rtol=1e-10)
    assert half.iterations == int(ref.iterations)
    np.testing.assert_allclose(float(half.rnorm), float(ref.rnorm), rtol=1e-8)


def test_gmres_sstep_spai_right_preconditioned():
    """A M u = b with SPAI's M, x = M u: converged in fewer steps than
    unpreconditioned, the reference's count."""
    from spmv_tpu.solvers.spai import spai_setup as ref_spai_setup

    from spmv_torch.solvers.spai import spai_setup

    a, A, R, b = _cd_system(20, 4, 3)
    Mp = build_dist_matrix(spai_setup(a), n_devices=4, device="cpu")
    Mr = ref_build(ref_spai_setup(_ref_csr(a)), n_devices=4)
    kw = dict(s=4, restart=32, max_cycles=30, rtol=1e-10)
    r1 = gmres_sstep(lambda v: A.matvec(Mp.matvec(v)), A.to_dist(b), **kw)
    x = A.from_dist(Mp.matvec(r1.x))
    assert r1.converged
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-9
    r0 = gmres_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    assert r1.iterations < r0.iterations
    ref = jax.jit(lambda A_, M_, bb: ref_gmres_sstep(lambda v: A_.matvec(M_.matvec(v)), bb,
                                                     **kw))(R, Mr, R.to_dist(b))
    assert r1.iterations == int(ref.iterations)


def test_gmres_sstep_ill_conditioned_basis():
    """A bad basis interval (0, 0.5) on a spectrum reaching 8 (~1e7 block
    condition at s = 4): CholQR2 survives, as in the reference."""
    a = create_laplace_2d(24, 24)
    A, R = _both(a, 4)
    b = gaussian_bump(a.nrows)
    kw = dict(s=4, restart=40, max_cycles=40, rtol=1e-8, lambda_bounds=(0.0, 0.5))
    r = gmres_sstep(A.as_linear_operator(), A.to_dist(b), **kw)
    ref = _ref_gmres_sstep(R, b, **kw)
    assert r.converged and bool(ref.converged)
    x = A.from_dist(r.x)
    assert np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b) < 1e-7
    assert abs(r.iterations - int(ref.iterations)) <= 4


def test_gmres_sstep_validation():
    b = torch.ones(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="s must be"):
        gmres_sstep(lambda v: v, b, s=0)
    with pytest.raises(ValueError, match="complex"):
        gmres_sstep(lambda v: v, torch.ones(8, dtype=torch.complex64), s=2)
    with pytest.raises(ValueError, match="s must be"):
        cg_sstep(lambda v: v, b, s=0)


@pytest.mark.parametrize("extra", [
    ["--sstep", "4"], ["--sstep", "8", "--symmetric", "--dia", "--devices", "2"],
    ["--sstep", "4", "--solver", "gmres"],
    ["--sstep", "4", "--solver", "gmres", "--newton", "16", "--devices", "2"]])
def test_demo_cg_sstep_matches_reference_demo(extra, capsys, monkeypatch):
    """demo_cg --sstep (s-step CG, and CA-GMRES with the Chebyshev or the
    Newton basis) against the reference demo: the same convergence and
    iterations, the printed residuals within 1e-8 of the solution norm, the
    solution norms within 1e-10 relative."""
    from test_torch_krylov import run_both_demos

    common = ["--lap2d", "24", "--kmax", "600", "--rtol", "1e-8", *extra]
    port, ref = run_both_demos(common, capsys, monkeypatch)
    assert port[0] and ref[0] and port[1] == ref[1]
    assert abs(port[2] - ref[2]) <= 1e-8 * ref[3]
    assert abs(port[3] - ref[3]) <= 1e-10 * ref[3]
