"""spmv_torch corpus generators, RCM reordering and Matrix Market I/O vs the
spmv_tpu reference.

All three are host numpy code carried across: the same seeds and inputs
must give the reference's matrices, orders and files bit for bit (RCM
against the reference's numpy tier, ``native=False``).
"""
import numpy as np
import pytest

import spmv_tpu.corpus as ref_corpus
import spmv_tpu.reorder as ref_reorder
from spmv_tpu.io.matrix_market import read_matrix_market as ref_read_mm
from spmv_tpu.io.matrix_market import write_matrix_market as ref_write_mm

import spmv_torch.corpus as pt_corpus
import spmv_torch.formats.csr as pt_csr
import spmv_torch.reorder as pt_reorder
from spmv_torch.io.matrix_market import read_matrix_market, write_matrix_market

GENERATORS = [
    ("fem_p1_2d", {"n_nodes": 1500, "seed": 2}),
    ("fem_p1_3d", {"n_nodes": 600, "seed": 1}),
    ("powerlaw_laplacian", {"n": 1200, "m": 4, "seed": 3}),
    ("circuit_network", {"nx": 30, "seed": 4}),
    ("aniso_laplace_2d", {"nx": 25}),
    ("stencil27_3d", {"nx": 7}),
]


def _same_csr(got, want):
    assert (got.nrows, got.ncols, got.nnz) == (want.nrows, want.ncols, want.nnz)
    for name in ("rowptr", "colind", "values"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_corpus_matches_reference(name, kw):
    _same_csr(getattr(pt_corpus, name)(**kw), getattr(ref_corpus, name)(**kw))


def test_scramble_matches_reference():
    _same_csr(pt_corpus.scramble(pt_corpus.aniso_laplace_2d(20), seed=5),
              ref_corpus.scramble(ref_corpus.aniso_laplace_2d(20), seed=5))


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
@pytest.mark.parametrize("keep_best", [False, True])
def test_rcm_matches_reference(name, kw, keep_best):
    a_pt = getattr(pt_corpus, name)(**kw)
    a_ref = getattr(ref_corpus, name)(**kw)
    b_pt, order_pt = pt_reorder.rcm_reorder(a_pt, keep_best=keep_best)
    b_ref, order_ref = ref_reorder.rcm_reorder(a_ref, native=False,
                                               keep_best=keep_best)
    assert order_pt.dtype == order_ref.dtype
    assert np.array_equal(order_pt, order_ref)
    _same_csr(b_pt, b_ref)
    assert pt_reorder.bandwidth(b_pt) == ref_reorder.bandwidth(b_ref)
    assert (pt_reorder.bandwidth_quantile(b_pt)
            == ref_reorder.bandwidth_quantile(b_ref))


def test_rcm_of_scrambled_fem_restores_locality():
    """The reorder pipeline's regression: RCM rediscovers the locality a
    random symmetric permutation destroyed, and permute_symmetric keeps
    the operator (same spectrum: P A P^T x_perm = (A x)_perm)."""
    a = pt_corpus.scramble(pt_corpus.fem_p1_2d(1200, seed=1), seed=2)
    b, order = pt_reorder.rcm_reorder(a)
    assert pt_reorder.bandwidth(b) < pt_reorder.bandwidth(a) / 5
    assert np.array_equal(pt_reorder.reverse_cuthill_mckee(a),
                          ref_reorder.reverse_cuthill_mckee(
                              ref_corpus.scramble(ref_corpus.fem_p1_2d(1200, seed=1),
                                                  seed=2), native=False))
    x = np.random.default_rng(0).standard_normal(a.nrows)
    assert np.allclose(b.matvec(x[order]), a.matvec(x)[order], rtol=1e-12,
                       atol=1e-12)


def test_keep_best_keeps_a_structured_ordering():
    """A grid with a few long-range edges: RCM would widen the bulk band,
    so keep_best returns the identity, as the reference does."""
    a = pt_corpus.circuit_network(40, extra_frac=0.05, seed=1)
    b, order = pt_reorder.rcm_reorder(a, keep_best=True)
    _, ref_order = ref_reorder.rcm_reorder(
        ref_corpus.circuit_network(40, extra_frac=0.05, seed=1), native=False,
        keep_best=True)
    assert np.array_equal(order, ref_order)
    if np.array_equal(order, np.arange(a.nrows)):
        _same_csr(b, a)


def test_rcm_rejects_rectangular():
    a = pt_csr.CSRHost.from_dense(np.ones((3, 4)))
    with pytest.raises(ValueError):
        pt_reorder.rcm_reorder(a)


@pytest.mark.parametrize("gz", [False, True])
def test_matrix_market_roundtrip_matches_reference(tmp_path, gz):
    a = pt_corpus.fem_p1_2d(400, seed=3, dtype=np.float64)
    path = str(tmp_path / ("a.mtx.gz" if gz else "a.mtx"))
    write_matrix_market(path, a, comment="fem_p1_2d(400)\nseed 3")
    ref_path = str(tmp_path / ("r.mtx.gz" if gz else "r.mtx"))
    ref_write_mm(ref_path, ref_corpus.fem_p1_2d(400, seed=3, dtype=np.float64),
                 comment="fem_p1_2d(400)\nseed 3")
    if not gz:
        assert open(path).read() == open(ref_path).read()
    got = read_matrix_market(path)
    _same_csr(got, ref_read_mm(path))
    _same_csr(got, a)


@pytest.mark.parametrize("symmetry,field", [
    ("symmetric", "real"), ("skew-symmetric", "integer"), ("general", "pattern")])
def test_matrix_market_storage_kinds(tmp_path, symmetry, field):
    path = tmp_path / "k.mtx"
    entries = [(1, 1, 4), (2, 1, -1), (3, 2, 2), (3, 3, 5)]
    if symmetry == "skew-symmetric":
        entries = [e for e in entries if e[0] != e[1]]
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}",
             "% a comment", f"3 3 {len(entries)}"]
    lines += [f"{i} {j}" if field == "pattern" else f"{i} {j} {v}"
              for i, j, v in entries]
    path.write_text("\n".join(lines) + "\n")
    _same_csr(read_matrix_market(str(path)), ref_read_mm(str(path)))


def test_matrix_market_rejects_bad_header(tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="coordinate"):
        read_matrix_market(str(path))
