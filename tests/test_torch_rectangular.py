"""spmv_torch rectangular ELL operators and hub rows vs the spmv_tpu
reference (mirrors the forward cases of ``tests/test_rectangular.py`` and
``tests/test_hub.py``).

Rectangular operators partition columns by ``owner_ranges(ncols, D)``; the
port's halo plan, padding and stacked arrays must equal the reference's,
and matvec agree to 1e-12 relative (float64, sums in another order). Hub
rows (rows past the hub cap) leave the row-uniform format: the port splits
the same rows (the same ``hub_nnz``) and applies them as a gather over the
whole input vector, with no scatter-add, to float32 rounding of the host
oracle (5e-6, the reference's own bound).
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

import spmv_torch.formats.csr as pt_csr
from spmv_torch.corpus import powerlaw_laplacian
from spmv_torch.parallel.dist_matrix import _hub_split, build_dist_matrix
from spmv_torch.reorder import rcm_reorder

N_DEVICES = [1, 2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _restriction_triplets(nf: int):
    """1-D full weighting, nf fine rows -> nf//2 coarse rows."""
    rows, cols, vals = [], [], []
    for i in range(nf // 2):
        f = 2 * i + 1
        for df, w in ((-1, 0.25), (0, 0.5), (1, 0.25)):
            if 0 <= f + df < nf:
                rows.append(i)
                cols.append(f + df)
                vals.append(w)
    return np.array(rows), np.array(cols), np.array(vals), nf // 2, nf


def _pair_from(rows, cols, vals, nr, nc):
    return (ref_csr.CSRHost.from_coo(rows, cols, vals, nr, nc),
            pt_csr.CSRHost.from_coo(rows, cols, vals, nr, nc))


def _random_pair(nr, nc, seed):
    a = ref_gen.random_csr(nr, nc, 5, seed=seed)
    return a, pt_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)


def _same_assembly(P, R):
    assert (P.row_pad, P.col_pad) == (R.row_pad, R.col_pad)
    assert P.plan.rounds == R.plan.rounds
    for name in ("send_idx", "recv_pos", "nlocal", "nghosts"):
        assert np.array_equal(getattr(P.plan, name).numpy(),
                              np.asarray(getattr(R.plan, name))), name
    for name in ("local_colind", "local_values", "remote_colind", "remote_values"):
        assert np.array_equal(getattr(P, name).numpy(),
                              np.asarray(getattr(R, name))), name


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("shape", ["restriction", "tall", "wide"])
def test_rectangular_matvec(shape, n_dev):
    """R @ x for a restriction operator and random tall and wide matrices:
    the reference's stacked arrays and plan, and its product."""
    if shape == "restriction":
        ref, pt = _pair_from(*_restriction_triplets(240))
    else:
        ref, pt = _random_pair(*((150, 70, 7) if shape == "tall" else (60, 200, 8)))
    R = ref_build(ref, n_devices=n_dev)
    P = build_dist_matrix(pt, n_devices=n_dev, device="cpu")
    _same_assembly(P, R)
    x = np.random.default_rng(5).standard_normal(pt.ncols)
    xd = P.to_dist(x)
    assert tuple(xd.shape) == (n_dev * P.col_pad // 128, 128)
    y = P.matvec(xd)
    assert tuple(y.shape) == (n_dev * P.row_pad // 128, 128)
    got = P.from_dist(y)
    assert _rel(got, pt.matvec(x)) <= 1e-12
    assert _rel(got, R.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(R, R.to_dist(x)))) <= 1e-12
    # the column side round-trips through to_dist/from_dist
    assert np.array_equal(P.from_dist(xd, side="col"), x)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_rectangular_matmat(n_dev):
    ref, pt = _random_pair(150, 70, 7)
    P = build_dist_matrix(pt, n_devices=n_dev, device="cpu")
    X = np.random.default_rng(9).standard_normal((pt.ncols, 3))
    Y = P.from_dist_block(P.matmat(P.to_dist_block(X)))
    assert _rel(Y, np.stack([pt.matvec(c) for c in X.T], axis=1)) <= 1e-12


def test_rectangular_formats_and_symmetry_refused():
    """DIA and symmetric storage are square-only in both packages; the
    reference's rectangular WELL is not ported, and the port refuses it
    with a ValueError (so AMG's per-level ELL fallback fires)."""
    ref, pt = _random_pair(60, 200, 8)
    for kw in (dict(local_format="dia"), dict(symmetric=True)):
        with pytest.raises(ValueError):
            build_dist_matrix(pt, device="cpu", **kw)
        with pytest.raises(ValueError):
            ref_build(ref, **kw)
    with pytest.raises(ValueError, match="rectangular"):
        build_dist_matrix(pt, local_format="well", device="cpu")


def _skewed(n=2000, seed=0, hub_rows=3, hub_deg=700):
    """Uniform sparse matrix plus a few dense hub rows (the reference's)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, n, 4 * n)
    vals = rng.standard_normal(4 * n)
    for h in rng.choice(n, hub_rows, replace=False):
        c = rng.choice(n, hub_deg, replace=False)
        rows = np.concatenate([rows, np.full(hub_deg, h)])
        cols = np.concatenate([cols, c])
        vals = np.concatenate([vals, rng.standard_normal(hub_deg)])
    return _pair_from(rows, cols, vals.astype(np.float32), n, n)


def _refuse_scatter_add(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an apply called a scatter-add")

    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                        (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("fmt", ["ell", "well"])
def test_hub_split_oracle_parity(fmt, n_dev, monkeypatch):
    ref, pt = _skewed()
    kw = dict(n_devices=n_dev, local_format=fmt, dtype=np.float32, hub_cap=64)
    R = ref_build(ref, **kw)
    P = build_dist_matrix(pt, device="cpu", **kw)
    assert P.hub_nnz == R.hub_nnz > 0
    assert P.nnz_global == R.nnz_global
    assert np.array_equal(P.jacobi_diag.numpy(), np.asarray(R.jacobi_diag))
    if fmt == "ell":
        assert P.local_values.shape[-1] <= 64
    x = np.random.default_rng(1).standard_normal(pt.ncols).astype(np.float32)
    _refuse_scatter_add(monkeypatch)
    y = P.from_dist(P.matvec(P.to_dist(x)))
    assert _rel(y, pt.matvec(x.astype(np.float64))) < 5e-6


@pytest.mark.parametrize("n_dev", [1, 4])
def test_hub_matmat_parity(n_dev, monkeypatch):
    _, pt = _skewed(seed=5)
    P = build_dist_matrix(pt, n_devices=n_dev, local_format="ell",
                          dtype=np.float32, hub_cap=64, device="cpu")
    X = np.random.default_rng(4).standard_normal((pt.ncols, 3)).astype(np.float32)
    _refuse_scatter_add(monkeypatch)
    Y = P.from_dist_block(P.matmat(P.to_dist_block(X)))
    want = np.stack([pt.matvec(c.astype(np.float64)) for c in X.T], axis=1)
    assert _rel(Y, want) < 5e-6


def test_hub_split_matches_reference():
    """The auto cap and an explicit one split the same rows as the
    reference's ``_hub_split``; a near-uniform matrix never splits."""
    from spmv_tpu.parallel.dist_matrix import _hub_split as ref_hub_split

    ref, pt = _skewed(seed=7)
    for cap in ("auto", 64, 5000):
        body, hubs = _hub_split(pt, cap)
        body_r, hubs_r = ref_hub_split(ref, cap)
        assert (hubs is None) == (hubs_r is None)
        assert np.array_equal(body.rowptr, body_r.rowptr)
        if hubs is not None:
            for h, h_r in zip(hubs, hubs_r):
                assert np.array_equal(h, h_r)
    lap = pt_csr.CSRHost(*(lambda a: (a.rowptr, a.colind, a.values, a.ncols))(
        ref_gen.create_laplace_2d(20, 20)))
    assert _hub_split(lap, "auto")[1] is None


def test_hub_auto_cap_powerlaw():
    """A power-law graph through local_format="auto": the split keeps the
    build small and matches the oracle, with the reference's hub_nnz."""
    from spmv_tpu.corpus import powerlaw_laplacian as ref_powerlaw

    a, _ = rcm_reorder(powerlaw_laplacian(8000, seed=2))
    ra = ref_powerlaw(8000, seed=2)
    assert np.array_equal(ra.colind, powerlaw_laplacian(8000, seed=2).colind)
    A = build_dist_matrix(a, n_devices=4, local_format="auto", dtype=np.float32,
                          device="cpu")
    kmax = int(a.row_nnz().max())
    assert A.hub_nnz > 0, kmax
    ref_a = ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    assert A.hub_nnz == ref_build(ref_a, n_devices=4, local_format="auto",
                                  dtype=np.float32).hub_nnz
    assert A.format_size_bytes() < 0.5 * a.nrows * kmax * 8
    x = np.random.default_rng(3).standard_normal(a.ncols).astype(np.float32)
    y = A.from_dist(A.matvec(A.to_dist(x)))
    assert _rel(y, a.matvec(x.astype(np.float64))) < 5e-6
