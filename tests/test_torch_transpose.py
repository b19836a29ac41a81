"""spmv_torch's transpose operator vs the spmv_tpu reference.

``dia_transpose`` must give the reference's shifted data bit for bit.
``DistMatrix.matvec_transpose`` and ``transposed()`` are held against the
reference's ``matvec_transpose`` on the 8-device virtual CPU mesh and
against the host A^T x, at np 1/2/4, for ell, dia and well, vanilla and
rectangular ELL, with hub rows and with a WELL far remainder; always on a
non-symmetric operator (a symmetric one would hide a shift in the wrong
direction): the upwind convection-diffusion of the reference's SPAI tests,
a row-scaled power-law Laplacian, a row-scaled long-range tridiagonal.
float64 applies agree to 1e-12 relative (the sums run in another order on
each side).
"""
import jax
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.formats.dia import csr_to_dia as ref_csr_to_dia
from spmv_tpu.formats.dia import dia_transpose as ref_dia_transpose
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

import spmv_torch.formats.csr as pt_csr
from spmv_torch.corpus import powerlaw_laplacian
from spmv_torch.formats.dia import csr_to_dia, dia_transpose
from spmv_torch.parallel.dist_matrix import build_dist_matrix

N_DEVICES = [1, 2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def convection_diffusion_2d(g: int, cx=12.0, cy=8.0, csr=pt_csr.CSRHost):
    """Upwind convection-diffusion on a g x g grid (``tests/test_spai.py``'s
    operator, vectorized): constant diagonal 4 + (cx + cy) h, the upwind
    west and south neighbours -1 - c h, the east and north -1."""
    n = g * g
    h = 1.0 / (g + 1)
    i = np.arange(n, dtype=np.int64)
    ix, iy = i % g, i // g
    parts = [(i, i, np.full(n, 4.0 + (cx + cy) * h))]
    for ok, j, v in ((ix > 0, i - 1, -1.0 - cx * h), (ix < g - 1, i + 1, -1.0),
                     (iy > 0, i - g, -1.0 - cy * h), (iy < g - 1, i + g, -1.0)):
        parts.append((i[ok], j[ok], np.full(int(ok.sum()), v)))
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    return csr.from_coo(rows, cols, vals, n, n)


def _loop_convection_diffusion(g, cx=12.0, cy=8.0):
    """The reference test's own loop form of the same operator."""
    n, h = g * g, 1.0 / (g + 1)
    rows, cols, vals = [], [], []
    for iy in range(g):
        for ix in range(g):
            i = iy * g + ix
            rows.append(i), cols.append(i), vals.append(4.0 + (cx + cy) * h)
            for ok, j, v in ((ix > 0, i - 1, -1.0 - cx * h), (ix < g - 1, i + 1, -1.0),
                             (iy > 0, i - g, -1.0 - cy * h), (iy < g - 1, i + g, -1.0)):
                if ok:
                    rows.append(i), cols.append(j), vals.append(v)
    return pt_csr.CSRHost.from_coo(np.array(rows), np.array(cols), np.array(vals), n, n)


def _pair(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols), pt


def _row_scaled(a, seed):
    """a with each row scaled by a factor in [0.5, 1.5): the same pattern
    (and hub rows), non-symmetric values."""
    s = np.random.default_rng(seed).uniform(0.5, 1.5, a.nrows)
    return pt_csr.CSRHost(a.rowptr, a.colind,
                          (a.values * np.repeat(s, a.row_nnz())).astype(a.values.dtype),
                          a.ncols)


def _long_range(n=80_000, pairs=300, seed=3):
    """A tridiagonal operator plus entries joining the first and last
    rows, row-scaled: a single shard's window split leaves a far
    remainder."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pi, pj = rng.integers(0, 5000, pairs), rng.integers(n - 5000, n, pairs)
    rows = np.concatenate([i, i[1:], i[:-1], pi, pj])
    cols = np.concatenate([i, i[:-1], i[1:], pj, pi])
    vals = np.concatenate([np.full(n, 4.0), np.full(2 * (n - 1), -1.0),
                           np.full(2 * pairs, -0.5)])
    return _row_scaled(pt_csr.CSRHost.from_coo(rows, cols, vals, n, n), seed)


def _restriction(nf=240):
    rows, cols, vals = [], [], []
    for i in range(nf // 2):
        for df, w in ((-1, 0.25), (0, 0.5), (1, 0.25)):
            if 0 <= 2 * i + df < nf:
                rows.append(i), cols.append(2 * i + df), vals.append(w)
    return pt_csr.CSRHost.from_coo(np.array(rows), np.array(cols), np.array(vals),
                                   nf // 2, nf)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _check_transpose(pt, n_dev, fmt, dtype=np.float64, tol=1e-12, ref=True, **kw):
    """matvec_transpose and transposed().matvec vs the host A^T x and (when
    ``ref``) the reference's matvec_transpose on the mesh."""
    P = build_dist_matrix(pt, n_devices=n_dev, dtype=dtype, local_format=fmt,
                          device="cpu", **kw)
    q = np.random.default_rng(n_dev).standard_normal(pt.nrows).astype(dtype)
    want = pt.transpose().matvec(q.astype(np.float64))
    got = P.from_dist(P.matvec_transpose(P.to_dist(q, side="row")), side="col")
    assert _rel(got, want) <= tol
    At = P.transposed()
    assert At is P.transposed() and At.transposed() is P
    got_t = At.from_dist(At.matvec(At.to_dist(q)))
    assert _rel(got_t, want) <= tol
    if ref:
        ra = _pair(pt)[0]
        R = ref_build(ra, n_devices=n_dev, dtype=dtype, local_format=fmt, **kw)
        yr = jax.jit(lambda A_, v: A_.matvec_transpose(v))(R, R.to_dist(q, side="row"))
        assert _rel(got, R.from_dist(yr, side="col")) <= tol
    return P, got, got_t


def test_convection_diffusion_helper_is_the_reference_operator():
    v, loop = convection_diffusion_2d(9), _loop_convection_diffusion(9)
    for name in ("rowptr", "colind", "values"):
        assert np.array_equal(getattr(v, name), getattr(loop, name)), name
    assert not np.array_equal(v.to_dense(), v.to_dense().T)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["convection-diffusion", "random-band"])
def test_dia_transpose_matches_reference(case, dtype):
    """The shifted data, offsets and shape equal the reference's bit for
    bit, and the result applied is A^T."""
    if case == "convection-diffusion":
        pt = convection_diffusion_2d(20)
    else:
        rng = np.random.default_rng(7)
        n = 300
        offs = np.array([-40, -3, 0, 1, 17])
        rows = np.repeat(np.arange(n), len(offs))
        cols = rows + np.tile(offs, n)
        ok = (cols >= 0) & (cols < n)
        pt = pt_csr.CSRHost.from_coo(rows[ok], cols[ok], rng.standard_normal(ok.sum()),
                                     n, n)
    ra = _pair(pt)[0]
    got = dia_transpose(csr_to_dia(pt, dtype=dtype, device="cpu"))
    want = ref_dia_transpose(ref_csr_to_dia(ra, dtype=dtype))
    assert got.offsets == want.offsets
    assert (got.nrows, got.ncols, got.nnz_stored) == (want.nrows, want.ncols, want._nnz)
    assert got.data.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    # its data are A^T's own DIA packing
    assert np.array_equal(got.data.numpy(),
                          csr_to_dia(pt.transpose(), dtype=dtype, device="cpu").data.numpy())


def test_dia_transpose_symmetric_and_rectangular():
    pt = convection_diffusion_2d(8)
    sym = csr_to_dia(pt_csr.CSRHost.from_dense(pt.to_dense() + pt.to_dense().T),
                     symmetric=True, device="cpu")
    assert dia_transpose(sym) is sym
    i = np.arange(50)
    rect = csr_to_dia(pt_csr.CSRHost.from_coo(np.r_[i, i], np.r_[i, i + 2],
                                              np.ones(100), 50, 52), device="cpu")
    with pytest.raises(ValueError, match="square"):
        dia_transpose(rect)


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("fmt", ["ell", "dia", "well"])
def test_matvec_transpose_matches_reference(fmt, n_dev):
    """The convection-diffusion operator (its ghosts cross every shard
    boundary): vs the host A^T x and the reference on the mesh."""
    _check_transpose(convection_diffusion_2d(24), n_dev, fmt)


@pytest.mark.parametrize("n_dev", N_DEVICES)
def test_matvec_transpose_rectangular_ell(n_dev):
    """The 1-D restriction (its transpose is the prolongation) and a random
    wide matrix: x on the row side, y on the column side."""
    for pt in (_restriction(), pt_csr.CSRHost.from_dense(
            np.random.default_rng(9).standard_normal((60, 200))
            * (np.random.default_rng(10).random((60, 200)) < 0.05))):
        P, got, _ = _check_transpose(pt, n_dev, "ell")
        assert (P.row_pad, P.col_pad) != (0, 0) and len(got) == pt.ncols


@pytest.mark.parametrize("n_dev", N_DEVICES)
@pytest.mark.parametrize("fmt", ["ell", "well"])
def test_matvec_transpose_hub_rows(fmt, n_dev):
    """A row-scaled power-law Laplacian whose hub rows leave the row-uniform
    format: the hub term's transpose is a gather over host-built tables
    (outputs on the column side); transposed() rebuilds the whole matrix,
    hub rows stitched back in."""
    pt = _row_scaled(powerlaw_laplacian(3000, seed=1, dtype=np.float64), 5)
    P, _, _ = _check_transpose(pt, n_dev, fmt, hub_cap=16)
    assert P.hub_nnz > 0
    assert P._rebuild_kwargs["local_format"] == "auto"


def test_matvec_transpose_well_far_remainder():
    """A vanilla WELL operator whose window split leaves a far remainder
    (one shard: at more, the long-range entries are ghosts): the
    transpose's own window split leaves one too (an ELL gather)."""
    pt = _long_range()
    P, _, _ = _check_transpose(pt, 1, "well")
    assert P.well_far_nnz > 0
    assert P._transpose_cache["far_colind"] is not None


@pytest.mark.parametrize("fmt", ["dia", "well"])
def test_matvec_transpose_float32(fmt):
    """fp32 operators: within fp32 rounding of the host A^T x."""
    _check_transpose(convection_diffusion_2d(24), 4, fmt, dtype=np.float32, tol=2e-6,
                     ref=False)


def test_dia_transpose_forms_give_the_same_bits():
    """At one shard the DIA transpose (shifted data, negated offsets) and
    transposed() (A^T packed from the host) store the same data and offsets
    in the same order, so their applies give the same bits; a second apply
    repeats them."""
    pt = convection_diffusion_2d(30)
    P = build_dist_matrix(pt, dtype=np.float32, local_format="dia", device="cpu")
    At = P.transposed()
    q = P.to_dist(np.random.default_rng(3).standard_normal(pt.nrows).astype(np.float32),
                  side="row")
    y = P.matvec_transpose(q)
    t = P._transpose_cache
    assert t["dia_offsets"] == At.dia_offsets
    assert torch.equal(t["dia_data"], At.local_dia_data)
    assert torch.equal(y, At.matvec(q)) and torch.equal(y, P.matvec_transpose(q))


def test_transpose_cache_and_refusals():
    """transposed() is cached both ways; a symmetric operator is its own
    transpose; the double-single formats refuse matvec_transpose (the
    reference's has no branch for them) and rebuild A^T in their own
    format through transposed(); an operator without its host matrix
    refuses transposed()."""
    pt = convection_diffusion_2d(16)
    sym_host = pt_csr.CSRHost.from_dense(pt.to_dense() + pt.to_dense().T)
    S = build_dist_matrix(sym_host, symmetric=True, local_format="dia", device="cpu")
    assert S.transposed() is S
    q = S.to_dist(np.ones(sym_host.nrows))
    assert torch.equal(S.matvec_transpose(q), S.matvec(q))
    assert "symmetric" not in S._rebuild_kwargs and S._host_csr is sym_host
    for fmt in ("dia_ds", "well_ds"):
        D = build_dist_matrix(pt, dtype=np.float64, local_format=fmt, device="cpu")
        with pytest.raises(NotImplementedError, match="transposed"):
            D.matvec_transpose(D.to_dist(np.ones(pt.nrows), side="row"))
        Dt = D.transposed()
        assert Dt.local_format == fmt and Dt.transposed() is D
        x = np.random.default_rng(4).standard_normal(pt.nrows)
        got = Dt.from_dist(Dt.matvec(Dt.to_dist(x)))
        assert _rel(got, pt.transpose().matvec(x)) <= 1e-13
    P = build_dist_matrix(pt, device="cpu")
    del P._host_csr
    with pytest.raises(ValueError, match="host matrix"):
        P.transposed()


@pytest.mark.parametrize("n_dev", [1, 4])
def test_demo_restrict_matches_reference_demo(n_dev, capsys, monkeypatch):
    """demo_restrict --devices 1 and 4: restriction by the rectangular ELL
    operator, prolongation by matvec_transpose and by the cached
    transposed(), the Galerkin product and the 8-step loop, each checked
    against the host CSR inside the demo; the printed norms equal the
    reference demo's to 1e-12 relative."""
    import os
    import sys

    from spmv_tpu.demos import demo_restrict as ref_demo

    from spmv_torch.demos import demo_restrict as pt_demo

    jax.devices()  # the backend starts with 8 devices, before the demo's XLA_FLAGS
    assert pt_demo.main(["--n", "1024", "--devices", str(n_dev), "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["demo_restrict", "--n", "1024", "--cpu",
                                      "--devices", str(n_dev)])
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert ref_demo.main() == 0
    ref = capsys.readouterr().out
    assert "verified against the host CSR" in port
    for key in ("|R f|    = ", "|R^T R f|= "):
        got, want = (float(out.split(key)[1].split()[0]) for out in (port, ref))
        assert abs(got - want) <= 1e-12 * want
