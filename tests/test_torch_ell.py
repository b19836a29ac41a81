"""spmv_torch's standalone ELL format and its applies vs the spmv_tpu
reference (``formats/ell.py``, ``ops/spmv_ell.py``).

``csr_to_ell`` must give the reference's arrays bit for bit (colind,
values, diagonal, the padding and K) at every row and K alignment,
vanilla and symmetric. ``spmv_ell`` (vanilla, symmetric, with alpha, beta
and y) and ``spmv_ell_transpose`` are held against the reference's on the
same inputs: float64 within 1e-14 of the reference's (the transpose terms
are gathers here and XLA scatter-adds there, so sums run in another
order), and against the host CSR oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.formats.ell import csr_to_ell as ref_csr_to_ell
from spmv_tpu.ops.spmv_ell import spmv_ell as ref_spmv_ell
from spmv_tpu.ops.spmv_ell import spmv_ell_transpose as ref_spmv_ell_transpose

from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.ell import csr_to_ell
from spmv_torch.gen import create_laplace_2d, random_csr
from spmv_torch.ops.spmv_ell import spmv_ell, spmv_ell_transpose

TOL = 1e-14


def _ref(pt):
    return ref_csr.CSRHost(pt.rowptr, pt.colind, pt.values, pt.ncols)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _rect(nr=300, nc=170, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nr, 1500)
    cols = rng.integers(0, nc, 1500)
    return CSRHost.from_coo(rows, cols, rng.standard_normal(1500), nr, nc)


MATRICES = {
    "random_sym": lambda: random_csr(257, 257, 6, seed=3, symmetric=True, spd_shift=1.0),
    "laplace": lambda: create_laplace_2d(19, 17),
    "rect": _rect,
}


@pytest.mark.parametrize("name,symmetric", [("random_sym", False), ("random_sym", True),
                                            ("laplace", False), ("laplace", True),
                                            ("rect", False)])
@pytest.mark.parametrize("row_align,k_align", [(8, 1), (128, 8), (1, 4)])
def test_csr_to_ell_bit_equal_to_reference(name, symmetric, row_align, k_align):
    pt = MATRICES[name]()
    e = csr_to_ell(pt, row_align=row_align, k_align=k_align, symmetric=symmetric,
                   device="cpu")
    r = ref_csr_to_ell(_ref(pt), row_align=row_align, k_align=k_align, symmetric=symmetric)
    assert (e.nrows_pad, e.k, e.nrows, e.ncols) == (r.nrows_pad, r.k, r.nrows, r.ncols)
    assert e.nnz_stored == r.nnz_stored and e.symmetric == r.symmetric
    np.testing.assert_array_equal(e.colind.numpy(), np.asarray(r.colind))
    np.testing.assert_array_equal(e.values.numpy(), np.asarray(r.values))
    assert e.values.dtype == torch.float64
    if symmetric:
        np.testing.assert_array_equal(e.diagonal.numpy(), np.asarray(r.diagonal))
    else:
        assert e.diagonal is None and r.diagonal is None


def test_csr_to_ell_dtype_and_sizes():
    pt = create_laplace_2d(9, 9)
    e = csr_to_ell(pt, dtype=np.float32, symmetric=True, device="cpu")
    r = ref_csr_to_ell(_ref(pt), dtype=np.float32, symmetric=True)
    assert e.dtype == torch.float32
    np.testing.assert_array_equal(e.values.numpy(), np.asarray(r.values))
    # the port also holds the host-built L^T rectangle
    assert e.format_size_bytes() > (e.colind.numel() * 8 + e.values.numel() * 4)


@pytest.mark.parametrize("name", ["random_sym", "laplace"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_spmv_ell_matches_reference(name, symmetric):
    pt = MATRICES[name]()
    e = csr_to_ell(pt, symmetric=symmetric, device="cpu")
    r = ref_csr_to_ell(_ref(pt), symmetric=symmetric)
    x = np.random.default_rng(11).standard_normal(pt.ncols)
    got = spmv_ell(e, torch.from_numpy(x)).numpy()
    want = np.asarray(ref_spmv_ell(r, jnp.asarray(x)))
    assert got.shape == want.shape == (e.nrows_pad,)
    assert _rel(got, want) < TOL
    assert _rel(got[: pt.nrows], pt.matvec(x)) < TOL
    assert not got[pt.nrows:].any()


@pytest.mark.parametrize("symmetric", [False, True])
def test_spmv_ell_alpha_beta_y(symmetric):
    """y <- alpha A x + beta y, with a y shorter than nrows_pad (padded)
    and a padded x tail past ncols (ignored)."""
    pt = MATRICES["random_sym"]()
    e = csr_to_ell(pt, row_align=128, symmetric=symmetric, device="cpu")
    r = ref_csr_to_ell(_ref(pt), row_align=128, symmetric=symmetric)
    rng = np.random.default_rng(12)
    x = np.concatenate([rng.standard_normal(pt.ncols), np.zeros(e.nrows_pad - pt.ncols)])
    y = rng.standard_normal(pt.nrows)
    got = spmv_ell(e, torch.from_numpy(x), alpha=-0.5, beta=2.0, y=torch.from_numpy(y))
    want = ref_spmv_ell(r, jnp.asarray(x), alpha=-0.5, beta=2.0, y=jnp.asarray(y))
    assert _rel(got.numpy(), np.asarray(want)) < TOL
    assert _rel(got.numpy()[: pt.nrows], -0.5 * pt.matvec(x[: pt.ncols]) + 2.0 * y) < TOL


@pytest.mark.parametrize("name", ["random_sym", "laplace", "rect"])
@pytest.mark.parametrize("out_size", [None, "ncols", "long"])
def test_spmv_ell_transpose_matches_reference(name, out_size):
    pt = MATRICES[name]()
    e = csr_to_ell(pt, device="cpu")
    r = ref_csr_to_ell(_ref(pt))
    n = {None: None, "ncols": pt.ncols, "long": pt.ncols + 13}[out_size]
    q = np.random.default_rng(13).standard_normal(pt.nrows)
    got = spmv_ell_transpose(e, torch.from_numpy(q), out_size=n).numpy()
    want = np.asarray(ref_spmv_ell_transpose(r, jnp.asarray(q), out_size=n))
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    assert _rel(got[: pt.ncols], pt.transpose().matvec(q)) < TOL
    assert not got[pt.ncols:].any()


def test_spmv_ell_transpose_refuses_symmetric_storage():
    pt = create_laplace_2d(6, 6)
    with pytest.raises(ValueError, match="self-transpose"):
        spmv_ell_transpose(csr_to_ell(pt, symmetric=True, device="cpu"),
                           torch.ones(36, dtype=torch.float64))
    with pytest.raises(ValueError, match="self-transpose"):
        ref_spmv_ell_transpose(ref_csr_to_ell(_ref(pt), symmetric=True), jnp.ones(36))


def test_spmv_ell_same_bits_twice():
    """Gathers only: two applies of the symmetric and transpose terms give
    the same bits."""
    pt = MATRICES["random_sym"]()
    e = csr_to_ell(pt, symmetric=True, device="cpu")
    v = csr_to_ell(pt, device="cpu")
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(pt.nrows))
    assert torch.equal(spmv_ell(e, x), spmv_ell(e, x))
    assert torch.equal(spmv_ell_transpose(v, x), spmv_ell_transpose(v, x))
