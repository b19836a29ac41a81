"""spmv_torch WELL packing and apply vs the spmv_tpu reference.

The same host triplets (made with numpy from a seed) go through both
packages. Packed ``values``/``pos``/``w0`` and the window split must be
bit for bit the reference's; the plain torch apply must match the
reference's Pallas kernel run in interpret mode (relative L2 1e-13 in
float64, 1e-6 in float32: the same products, summed over the slots in the
same order; the last bits may differ with the backend's FMA use).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.formats.well import csr_to_well as ref_csr_to_well
from spmv_tpu.formats.well import csr_to_well_sym as ref_csr_to_well_sym
from spmv_tpu.formats.well import split_window as ref_split_window
from spmv_tpu.formats.well import well_occupancy as ref_well_occupancy
from spmv_tpu.ops.spmv_well_pallas import spmv_well_pallas
from spmv_tpu.ops.spmv_well_pallas import spmv_well_sym as ref_spmv_well_sym

import spmv_torch.formats.csr as pt_csr
from spmv_torch import _build
from spmv_torch.formats.well import (
    csr_to_well,
    csr_to_well_sym,
    split_window,
    well_occupancy,
)
from spmv_torch.ops import spmv_well_cuda
from spmv_torch.ops.spmv_well import (
    spmv_well,
    spmv_well_rows_plain,
    spmv_well_sym,
    spmv_well_sym_2d,
    well_to_2d,
)

TOL = {np.float32: 1e-6, np.float64: 1e-13}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counters():
    _build.launches.clear()
    yield
    _build.launches.clear()


def _pair(rows, cols, vals, nrows, ncols):
    return (ref_csr.CSRHost.from_coo(rows, cols, vals, nrows, ncols),
            pt_csr.CSRHost.from_coo(rows, cols, vals, nrows, ncols))


def _banded(n=3000, seed=5, offsets=(-900, -130, -1, 0, 2, 128, 1100),
            ncols=None, dtype=np.float64):
    """Banded random with holes (the bench's WELL generator at test size);
    windows reach past the last column for end-of-matrix tiles."""
    rng = np.random.default_rng(seed)
    m = ncols or n
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, m - off))
        i = i[rng.random(len(i)) < 0.8]
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return _pair(rows, cols, rng.standard_normal(len(rows)).astype(dtype), n, m)


def _scattered(n=1500, seed=6):
    """Every row also holds a few columns anywhere: some fall outside the
    tiles' best windows (a non-empty far remainder)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], np.repeat(i, 2)])
    cols = np.concatenate([i, i[:-1], rng.integers(0, n, 2 * n)])
    a_ref, a_pt = _pair(rows, cols, rng.standard_normal(len(rows)), n, n)
    # symmetrize: A + A^T
    sym = a_pt.to_dense() + a_pt.to_dense().T
    return (ref_csr.CSRHost.from_dense(sym), pt_csr.CSRHost.from_dense(sym))


def _same_well(w_pt, w_ref):
    for name in ("values", "pos", "w0"):
        got = getattr(w_pt, name).numpy()
        want = np.asarray(getattr(w_ref, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert (w_pt.nrows, w_pt.ncols, w_pt.wseg, w_pt.tile_groups, w_pt.nseg,
            w_pt.nnz_stored, w_pt.paired) == (
        w_ref.nrows, w_ref.ncols, w_ref.wseg, w_ref.tile_groups, w_ref.nseg,
        w_ref.nnz_stored, w_ref.paired)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tile_groups", [16, 4])
@pytest.mark.parametrize("shape", ["square", "wide", "tall"])
def test_packing_matches_reference(shape, tile_groups, pair):
    """Unpaired and paired slots; int16 pos (tile_groups 16) and int32 pos
    (tile_groups 4); square (equalized pads) and rectangular."""
    ncols = {"square": None, "wide": 4000, "tall": 2000}[shape]
    ref, pt = _banded(ncols=ncols)
    w_ref = ref_csr_to_well(ref, tile_groups=tile_groups, pair=pair)
    w_pt = csr_to_well(pt, tile_groups=tile_groups, pair=pair, device="cpu")
    _same_well(w_pt, w_ref)
    assert w_pt.pos.dtype == (torch.int16 if tile_groups == 16 else torch.int32)
    assert w_pt.paired == pair
    assert w_pt.occupancy == w_ref.occupancy
    assert w_pt.format_size_bytes() == w_ref.format_size_bytes()


def test_occupancy_and_split_match_reference():
    ref, pt = _scattered()
    assert well_occupancy(pt, 8) == ref_well_occupancy(ref, 8)
    for got, want in zip(split_window(pt, 4, 3), ref_split_window(ref, 4, 3)):
        assert got.nnz > 0
        for name in ("rowptr", "colind", "values"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_packing_casts_like_reference():
    ref, pt = _banded(n=700)
    _same_well(csr_to_well(pt, 8, dtype=torch.float32, device="cpu"),
               ref_csr_to_well(ref, 8, dtype=np.float32))


def test_too_many_slots_raises():
    _, pt = _banded(n=700)
    with pytest.raises(ValueError, match="max_k"):
        csr_to_well(pt, 8, max_k=2, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pair,tile_groups", [(False, 16), (True, 16), (False, 4)])
def test_apply_matches_reference_kernel(pair, tile_groups, dtype):
    ref, pt = _banded(n=2000, seed=7)
    w_ref = ref_csr_to_well(ref, tile_groups=tile_groups, pair=pair, dtype=dtype)
    w_pt = csr_to_well(pt, tile_groups=tile_groups, pair=pair, dtype=dtype,
                       device="cpu")
    x = np.random.default_rng(3).standard_normal(pt.ncols).astype(dtype)
    want = np.asarray(spmv_well_pallas(w_ref, jnp.asarray(x), interpret=True))
    got = spmv_well(w_pt, torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.linalg.norm(got - want) <= TOL[dtype] * np.linalg.norm(want)
    oracle = pt.matvec(x.astype(np.float64))
    assert np.linalg.norm(got[: pt.nrows] - oracle) <= 10 * TOL[dtype] * np.linalg.norm(oracle)
    assert not got[pt.nrows:].any()  # padding rows stay zero
    assert _build.launches["well"] == 0  # the plain path launches nothing


@pytest.mark.parametrize("shape", ["square", "wide"])
def test_lane_layout(shape):
    """A short x is zero-padded to ncols_pad; a padded x is a view."""
    _, pt = _banded(n=900, ncols=None if shape == "square" else 1500)
    w = csr_to_well(pt, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(pt.ncols))
    x2 = well_to_2d(w, x)
    assert x2.shape == (w.ncols_pad // 128, 128)
    assert torch.equal(x2.reshape(-1)[: pt.ncols], x) and not x2.reshape(-1)[pt.ncols:].any()
    xp = x2.reshape(-1).clone()
    assert well_to_2d(w, xp).data_ptr() == xp.data_ptr()
    assert torch.equal(spmv_well(w, x), spmv_well(w, xp))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wseg_cap", [512, 3])
def test_sym_matches_reference(wseg_cap, dtype):
    """Dual-WELL symmetric form; wseg_cap=3 leaves far remainders on both
    triangles."""
    ref, pt = _scattered()
    s_ref = ref_csr_to_well_sym(ref, tile_groups=4, dtype=dtype, wseg_cap=wseg_cap)
    s_pt = csr_to_well_sym(pt, tile_groups=4, dtype=dtype, wseg_cap=wseg_cap,
                           device="cpu")
    _same_well(s_pt.lower, s_ref.lower)
    _same_well(s_pt.upper, s_ref.upper)
    assert np.array_equal(s_pt.diag.numpy(), np.asarray(s_ref.diag))
    for got, want in ((s_pt.farl, s_ref.farl), (s_pt.faru, s_ref.faru)):
        assert (got is None) == (want is None) == (wseg_cap == 512)
        if got is not None:
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w))
    assert s_pt.nnz_stored == s_ref.nnz_stored
    x = np.random.default_rng(8).standard_normal(pt.nrows).astype(dtype)
    want = np.asarray(ref_spmv_well_sym(s_ref, jnp.asarray(x), interpret=True))
    got = spmv_well_sym(s_pt, torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - want) <= TOL[dtype] * np.linalg.norm(want)
    y2 = spmv_well_sym_2d(s_pt, torch.from_numpy(
        np.pad(x, (0, s_pt.nrows_pad - pt.nrows))).view(-1, 128))
    assert torch.equal(y2.reshape(-1), torch.from_numpy(got))


def test_stacked_plain_reads_each_shard_window():
    """D=3 stacked row lists of random widths (some 0) and entry counts,
    tile_groups 2: row r of shard s sums values * x[s*col_pad + w0*128 +
    pos] over its slice's entries, and reads nothing of its neighbours."""
    rng = np.random.default_rng(9)
    nd, g, tg, col_pad = 3, 6, 2, 8 * 128
    ns = g * 128 // 32
    width = rng.integers(0, 4, (nd, ns))
    ptr = np.zeros((nd, ns + 1), dtype=np.int64)
    ptr[:, 1:] = np.cumsum(width * 32, axis=1)
    e = int(ptr[:, -1].max())
    values = torch.from_numpy(rng.standard_normal((nd, e)))
    pos = torch.from_numpy(rng.integers(0, 4 * 128, (nd, e)).astype(np.int16))
    w0 = torch.from_numpy(rng.integers(0, 5, (nd, g // tg)).astype(np.int32))
    x2 = torch.from_numpy(rng.standard_normal((nd * col_pad // 128, 128)))
    got = spmv_well_cuda.spmv_well_stacked(values, pos, torch.from_numpy(ptr), w0,
                                           x2, tg)
    xs = x2.reshape(nd, col_pad).numpy()
    want = np.zeros((nd, g * 128))
    for s in range(nd):
        for r in range(g * 128):
            base = int(w0[s, r // 128 // tg]) * 128
            for j in range(width[s, r // 32]):
                at = ptr[s, r // 32] + 32 * j + r % 32
                want[s, r] += values[s, at].item() * xs[s, base + int(pos[s, at])]
    assert np.allclose(got.numpy().reshape(nd, -1), want, rtol=1e-13, atol=1e-13)
    assert torch.equal(got, spmv_well_rows_plain(values, pos, torch.from_numpy(ptr),
                                                 w0, x2, tg))
    assert _build.launches["well"] == 0


def _wrapper_inputs(dtype=torch.float32):
    """Row-list operands: D=2, G=4 groups (16 slices), E=64 entries."""
    values = torch.zeros((2, 64), dtype=dtype)
    pos = torch.zeros((2, 64), dtype=torch.int16)
    ptr = torch.zeros((2, 17), dtype=torch.int64)
    w0 = torch.zeros((2, 2), dtype=torch.int32)
    x2 = torch.zeros((2 * 4, 128), dtype=dtype)
    return values, pos, ptr, w0, x2


@pytest.mark.parametrize("case,exc", [
    ("bf16", TypeError),
    ("mixed", TypeError),
    ("pos_int64", TypeError),
    ("w0_int64", TypeError),
    ("values_shape", ValueError),
    ("pos_shape", ValueError),
    ("tile_groups", ValueError),
    ("w0_shape", ValueError),
    ("x_shape", ValueError),
    ("noncontiguous", ValueError),
    ("ptr_int32", TypeError),
    ("ptr_length", ValueError),
])
def test_wrapper_rejects_bad_input(case, exc):
    values, pos, ptr, w0, x2 = _wrapper_inputs()
    tg = 2
    if case == "bf16":
        values, x2 = values.bfloat16(), x2.bfloat16()
    elif case == "mixed":
        x2 = x2.double()
    elif case == "pos_int64":
        pos = pos.long()
    elif case == "w0_int64":
        w0 = w0.long()
    elif case == "values_shape":
        values = values[None]
    elif case == "pos_shape":
        pos = pos[:, :32]
    elif case == "tile_groups":
        tg = 3
    elif case == "w0_shape":
        w0 = w0[:, :1]
    elif case == "x_shape":
        x2 = x2[:-1]
    elif case == "noncontiguous":
        x2 = torch.zeros((128, 8), dtype=values.dtype).t()
    elif case == "ptr_int32":
        ptr = ptr.int()
    elif case == "ptr_length":
        ptr = ptr[:, :-1]
    with pytest.raises(exc):
        spmv_well_cuda.spmv_well_stacked(values, pos, ptr, w0, x2, tg)
    assert _build.launches["well"] == 0


def test_conversions_default_to_the_card():
    from spmv_torch.formats.dia import csr_to_dia
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    for fn in (csr_to_well, csr_to_well_sym, csr_to_dia, build_dist_matrix):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
