"""spmv_torch DIA packing and apply vs the spmv_tpu reference.

The same host inputs (made with numpy from a seed) go through both
packages; jax runs on the CPU, the reference's Pallas kernel in interpret
mode. Tolerances are relative max-abs errors:
  - 1e-13 in float64 and 2e-6 in float32 (the sums run in the reference's
    order; the last bits may still differ with the backend's FMA use);
  - against the reference's vanilla Pallas kernel, 2e-6 in float64 too:
    that kernel accumulates in float32 whatever the storage type
    (spmv_tpu/ops/spmv_dia_pallas.py:242).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.formats.dia import DiaMatrix as RefDia
from spmv_tpu.formats.dia import csr_to_dia as ref_csr_to_dia
from spmv_tpu.ops.spmv_dia import spmv_dia as ref_spmv_dia
from spmv_tpu.ops.spmv_dia_pallas import spmv_dia_pallas

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch.convert import dia_from_numpy
from spmv_torch.formats.dia import DiaMatrix, csr_to_dia
from spmv_torch.ops.spmv_dia import spmv_dia, spmv_dia_stacked_plain

TOL = {np.float32: 2e-6, np.float64: 1e-13}
ROW_ALIGN = 4096  # lets the reference Pallas kernels find a tile
BANDED_OFFSETS = (0, 1, 5, 37, 131)  # mirrored below the diagonal too


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded_dense(n=900, seed=3):
    """Symmetric banded matrix with non-constant diagonals and odd offsets."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n))
    for off in BANDED_OFFSETS:
        v = rng.standard_normal(n - off)
        dense += np.diag(v, off)
        if off:
            dense += np.diag(v, -off)
    return dense


def _pair(name):
    """(reference CSRHost, port CSRHost) for one test matrix."""
    if name == "lap2d_70x16":  # row offsets with odd lane remainders
        return ref_gen.create_laplace_2d(70, 16), pt_gen.create_laplace_2d(70, 16)
    if name == "lap2d_128x16":  # lane-aligned row offsets
        return ref_gen.create_laplace_2d(128, 16), pt_gen.create_laplace_2d(128, 16)
    if name == "lap1d_300":
        return (ref_gen.create_laplace_1d(300, 0.3),
                pt_gen.create_laplace_1d(300, 0.3))
    dense = _banded_dense()
    return ref_csr.CSRHost.from_dense(dense), pt_csr.CSRHost.from_dense(dense)


MATRICES = ["lap2d_70x16", "lap2d_128x16", "lap1d_300", "banded_odd"]
DTYPES = [np.float32, np.float64]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _x(n, dtype, seed=11):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("name", MATRICES)
def test_host_csr_matches_reference(name):
    ref, pt = _pair(name)
    assert np.array_equal(ref.rowptr, pt.rowptr)
    assert np.array_equal(ref.colind, pt.colind)
    assert np.array_equal(ref.values, pt.values)
    assert ref.values.dtype == pt.values.dtype
    x = _x(ref.ncols, np.float64)
    assert np.array_equal(ref.matvec(x), pt.matvec(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("name", MATRICES)
def test_csr_to_dia_bitwise(name, symmetric, dtype):
    ref, pt = _pair(name)
    d_ref = ref_csr_to_dia(ref, row_align=ROW_ALIGN, dtype=dtype,
                           symmetric=symmetric)
    d = csr_to_dia(pt, row_align=ROW_ALIGN, dtype=dtype, symmetric=symmetric,
                   device="cpu")
    want = np.asarray(d_ref.data)
    assert d.offsets == d_ref.offsets
    assert d.nnz_stored == d_ref.nnz_stored
    assert d.nrows_pad == d_ref.nrows_pad
    assert d.data.numpy().dtype == want.dtype == np.dtype(dtype)
    assert np.array_equal(d.data.numpy(), want)
    assert np.array_equal(d.data_flat.numpy(), np.asarray(d_ref.data_flat))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("name", MATRICES)
def test_spmv_dia_matches_reference(name, symmetric, dtype):
    """The port's plain apply vs the reference's XLA formulation and its
    Pallas kernel (interpret mode)."""
    ref, pt = _pair(name)
    d_ref = ref_csr_to_dia(ref, row_align=ROW_ALIGN, dtype=dtype,
                           symmetric=symmetric)
    d = csr_to_dia(pt, row_align=ROW_ALIGN, dtype=dtype, symmetric=symmetric,
                   device="cpu")
    x = np.zeros(d.nrows_pad, dtype)
    x[: ref.ncols] = _x(ref.ncols, dtype)
    got = spmv_dia(d, torch.from_numpy(x)).numpy()
    assert got.dtype == np.dtype(dtype)
    want_xla = np.asarray(ref_spmv_dia(d_ref, jnp.asarray(x), method="xla"))
    assert _rel(got, want_xla) <= TOL[dtype]
    want_pallas = np.asarray(spmv_dia_pallas(d_ref, jnp.asarray(x),
                                             interpret=True))
    tol = TOL[dtype] if symmetric else TOL[np.float32]
    assert _rel(got, want_pallas) <= tol
    # and both against the host f64 oracle
    want = ref.matvec(x[: ref.ncols].astype(np.float64))
    assert _rel(got[: ref.nrows], want) <= 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("name", MATRICES)
def test_dia_from_numpy_matches(name, symmetric, dtype):
    """A DiaMatrix carried across from the reference's arrays applies like
    the port's own pack."""
    ref, pt = _pair(name)
    d_ref = ref_csr_to_dia(ref, row_align=ROW_ALIGN, dtype=dtype,
                           symmetric=symmetric)
    d_conv = dia_from_numpy(np.asarray(d_ref.data), d_ref.offsets, d_ref.nrows,
                            d_ref.ncols, d_ref.symmetric, device="cpu")
    d_own = csr_to_dia(pt, row_align=ROW_ALIGN, dtype=dtype,
                       symmetric=symmetric, device="cpu")
    x = torch.from_numpy(_x(d_own.nrows_pad, dtype))
    assert np.array_equal(spmv_dia(d_conv, x).numpy(), spmv_dia(d_own, x).numpy())
    want = np.asarray(ref_spmv_dia(d_ref, jnp.asarray(x.numpy()), method="xla"))
    assert _rel(spmv_dia(d_conv, x).numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmv_dia_alpha_beta(dtype):
    ref, pt = _pair("lap2d_70x16")
    d_ref = ref_csr_to_dia(ref, dtype=dtype)
    d = csr_to_dia(pt, dtype=dtype, device="cpu")
    x = _x(ref.ncols, dtype)
    y = _x(d.nrows_pad, dtype, seed=12)
    got = spmv_dia(d, torch.from_numpy(x), alpha=2.5, beta=-0.5,
                   y=torch.from_numpy(y)).numpy()
    want = np.asarray(ref_spmv_dia(d_ref, jnp.asarray(x), alpha=2.5, beta=-0.5,
                                   y=jnp.asarray(y), method="xla"))
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("symmetric", [False, True])
def test_stacked_plain_is_per_shard_reference(symmetric, dtype):
    """D=3 stacked shards with random data and x everywhere: each shard's
    result is the reference's apply on that shard alone (x is zero outside
    the shard, so no value of a neighbouring shard leaks in)."""
    rng = np.random.default_rng(21)
    offsets = (-301, -37, -5, -1, 0) if symmetric else (-301, -37, -1, 0, 1, 37, 301)
    nd, nr = 3, 24
    data = rng.standard_normal((nd, nr, len(offsets) * 128)).astype(dtype)
    x2 = rng.standard_normal((nd * nr, 128)).astype(dtype)
    got = spmv_dia_stacked_plain(torch.from_numpy(data), torch.from_numpy(x2),
                                 offsets, symmetric).numpy().reshape(nd, -1)
    for s in range(nd):
        d_ref = RefDia(data=jnp.asarray(data[s]), offsets=offsets,
                       nrows=nr * 128, ncols=nr * 128, symmetric=symmetric)
        want = np.asarray(ref_spmv_dia(d_ref, jnp.asarray(x2.reshape(nd, -1)[s]),
                                       method="xla"))
        assert _rel(got[s], want) <= TOL[dtype]


def test_dia_matrix_accessors():
    _, pt = _pair("lap2d_70x16")
    d = csr_to_dia(pt, dtype=np.float32, symmetric=True, device="cpu")
    assert isinstance(d, DiaMatrix)
    assert d.dtype == torch.float32 and d.device.type == "cpu"
    assert d.ndiags == 3 and all(o <= 0 for o in d.offsets)
    assert d.format_size_bytes() == d.nrows_pad * d.ndiags * 4
    with pytest.raises(ValueError, match="max_diags"):
        csr_to_dia(_pair("banded_odd")[1], max_diags=4, device="cpu")
