"""spmv_torch's warp-sliced row lists of a WELL stack (``pack_rows``) and
the single-RHS applies that read them.

The layout is derived from the packed WELL arrays, so the tests hold it
against them:
- the packer: every occupied WELL slot appears once, at its row's next
  row-list entry in ascending slot order; each slice is as wide as its
  longest row (0 when it has no entry); the rest of a slice is value 0 at
  a position inside the window; ``pos`` is int16 exactly when
  wseg*128 <= 32767;
- the row-list plain applies (fp32, fp64 and double-single) equal the WELL
  plain applies bit for bit: each row sums the same terms in the same
  order, and every padded term, in either layout, adds an exact zero; so
  do the block (SpMM) plain applies, column by column, at nrhs 1/3/8/11;
- a group of K = 140 slots (more than 127: the ranks must not wrap);
- against the reference's Pallas kernels in interpret mode, at the
  tolerances of ``test_torch_well.py`` (relative L2 1e-6 fp32, 1e-13 fp64)
  and ``test_torch_ds.py`` (hi planes equal, hi + lo within 4e-15);
- ``DistMatrix.matvec`` / ``matvec_ds`` and ``matmat`` / ``matmat_ds`` at
  np 1/2/4 and a converted operator apply through the row lists, bit for
  bit as through the WELL formula.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.ds as ref_ds
import spmv_tpu.formats.csr as ref_csr
from spmv_tpu.formats.well import csr_to_well as ref_csr_to_well
from spmv_tpu.ops import spmv_well_pallas as ref_well
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

import spmv_torch.corpus as pt_corpus
import spmv_torch.ds as pt_ds
import spmv_torch.formats.csr as pt_csr
import spmv_torch.parallel.dist_matrix as dm
import spmv_torch.reorder as pt_reorder
from spmv_torch import _build
from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.formats.well import (
    LANES,
    SLICE,
    csr_to_well,
    csr_to_well_sym,
    pack_rows,
)
from spmv_torch.ops import spmm_well_cuda, spmv_well_cuda, spmv_well_ds_cuda
from spmv_torch.ops.spmm_dia import columns, from_columns
from spmv_torch.ops.spmm_well import spmm_well_ds_stacked_plain, spmm_well_stacked_plain
from spmv_torch.ops.spmv_well import (
    spmv_well,
    spmv_well_rows_plain,
    spmv_well_stacked_plain,
)
from spmv_torch.ops.spmv_well_ds import (
    csr_to_well_ds,
    spmv_well_ds_2d,
    spmv_well_ds_rows_plain,
    spmv_well_ds_stacked_plain,
)

TOL = {np.float32: 1e-6, np.float64: 1e-13}
CONTRACTION_TOL = 4e-15  # test_torch_ds.py's module docstring
NRHS = (1, 3, 8, 11)  # 11: a chunk of 8 columns and one of 3 on the card


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fem(n=3000, seed=0, dtype=np.float32):
    a, _ = pt_reorder.rcm_reorder(pt_corpus.fem_p1_2d(n, seed=seed, dtype=dtype),
                                  keep_best=True)
    return a


def _banded(n=3000, seed=5, offsets=(-1500, -130, -1, 0, 1, 128, 1400)):
    """The bench's banded-random WELL matrix (85% of each band kept) at
    test size."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.85]
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return pt_csr.CSRHost.from_coo(rows, cols, rng.standard_normal(len(rows)), n, n)


def _stack(w):
    """A WellMatrix's WELL arrays as one stacked (D=1) numpy stack."""
    return w.values.numpy()[None], w.pos.numpy()[None], w.w0.numpy()[None], w.wseg


def _case(name):
    """(values, pos, w0, tile_groups, wseg, rows) of one stacked WELL case
    and the row lists its producer holds (pack_rows output for the bare
    stacks)."""
    if name in ("fem_L", "fem_LT"):
        low, _ = _fem().split_lower_diag()
        w = csr_to_well(low if name == "fem_L" else low.transpose(), 16, device="cpu")
    elif name == "banded":
        w = csr_to_well(_banded(), 16, device="cpu")
    elif name == "paired":
        w = csr_to_well(_banded(), 16, pair=True, device="cpu")
        assert w.paired
    elif name == "tg4":  # int32 WELL pos (tiles not 16-aligned), int16 rows
        w = csr_to_well(_banded(), 4, device="cpu")
    elif name == "wide_int32":  # a 330-segment window: wseg*128 > 32767
        w = csr_to_well(_banded(45000, offsets=(-20000, 0, 20000)), 16, device="cpu")
    elif name == "sym_padded":  # L padded to L^T's groups by _pad_well_to
        s = csr_to_well_sym(_banded(1500, offsets=(-900, -1, 0, 1, 900)), 4,
                            device="cpu")
        w = s.lower
        assert w.ngroups == 24  # 16 of its own, 8 appended
    else:  # "D1" / "D3" / "D3_T": stacked shards of a symmetric DistMatrix
        nd = 1 if name == "D1" else 3
        # 2900 nodes: each shard's last slice lies past its rows
        A = dm.build_dist_matrix(_fem(2900), n_devices=nd, symmetric=True,
                                 local_format="well", device="cpu")
        tag = "T" if name.endswith("_T") else ""
        meta = getattr(A, f"well{tag}_meta")
        well = tuple(getattr(A, f"local_well{tag}_{f}").numpy()
                     for f in ("values", "pos", "w0"))
        rows = tuple(getattr(A, f"local_rows{tag}_{f}").numpy()
                     for f in ("values", "pos", "ptr"))
        return well, meta[2], meta[1], rows
    v, p, w0, wseg = _stack(w)
    rows = (w.rows_values.numpy()[None], w.rows_pos.numpy()[None],
            w.slice_ptr.numpy()[None])
    return (v, p, w0), w.tile_groups, wseg, rows


CASES = ["fem_L", "fem_LT", "banded", "paired", "tg4", "wide_int32", "sym_padded",
         "D1", "D3", "D3_T"]


def _check_layout(values, pos, wseg, rows, values_lo=None):
    """The packer's promises (module docstring) on stacked numpy arrays."""
    r_values, r_pos, ptr = rows
    nd, k, g, _ = values.shape
    nrows = g * LANES
    v, p = values.reshape(nd, k, nrows), pos.reshape(nd, k, nrows)
    occ = v != 0
    if values_lo is not None:
        occ |= values_lo.reshape(nd, k, nrows) != 0
    count = occ.sum(axis=1)
    width = np.diff(ptr, axis=1) // SLICE
    assert ptr.dtype == np.int64 and ptr.shape == (nd, nrows // SLICE + 1)
    assert not (ptr % SLICE).any() and not ptr[:, 0].any()
    assert np.array_equal(width, count.reshape(nd, -1, SLICE).max(axis=2))
    assert r_pos.dtype == (np.int16 if wseg * LANES <= 32767 else np.int32)
    assert r_values.shape == r_pos.shape == (nd, max(int(ptr[:, -1].max()), 1))
    for d in range(nd):
        # the WELL side in (row, slot) order
        k_i, r_i = np.nonzero(occ[d])
        order = np.lexsort((k_i, r_i))
        k_i, r_i = k_i[order], r_i[order]
        # the row-list side: row r's j-th entry
        rr = np.repeat(np.arange(nrows), count[d])
        jj = np.arange(len(rr)) - np.repeat(np.cumsum(count[d]) - count[d], count[d])
        e = ptr[d, rr // SLICE] + SLICE * jj + rr % SLICE
        assert np.array_equal(rr, r_i)
        assert np.array_equal(r_values[d, e], v[d, k_i, r_i])
        assert np.array_equal(r_pos[d, e], p[d, k_i, r_i])
        # every other entry of the shard is padding inside the window
        pad = np.ones(int(ptr[d, -1]), dtype=bool)
        pad[e] = False
        assert pad.sum() + len(e) == ptr[d, -1]
        assert not r_values[d, : ptr[d, -1]][pad].any()
        pp = r_pos[d, : ptr[d, -1]][pad].astype(np.int64)
        assert ((pp >= 0) & (pp < wseg * LANES)).all()
    return width


@pytest.mark.parametrize("name", CASES)
def test_pack_rows_layout(name):
    (values, pos, w0), tg, wseg, rows = _case(name)
    width = _check_layout(values, pos, wseg, rows)
    # the producer's row lists are pack_rows of its WELL arrays
    again = pack_rows(values, pos, wseg)
    for got, want in zip(rows, again[:3]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    occ = (values != 0).sum() / max(rows[0].shape[0] * rows[0].shape[1], 1)
    assert occ <= 1
    if name == "wide_int32":
        assert rows[1].dtype == np.int32 and wseg * LANES > 32767
    if name == "tg4":
        assert pos.dtype == np.int32 and rows[1].dtype == np.int16
    if name in ("sym_padded", "D3", "D3_T"):
        assert (width == 0).any()  # empty slices (padding groups and rows)
    if name.startswith("D3"):
        # shards of unequal entry counts share one padded entry axis
        ends = rows[2][:, -1]
        assert len(set(ends.tolist())) > 1 and rows[0].shape[1] == ends.max()
    if name in ("fem_L", "fem_LT"):
        # far fewer stored slots than WELL on the RCM'd FEM's triangles
        assert values.size >= 3 * rows[0].size


def test_pack_rows_double_single_planes():
    """A slot counts as occupied where either plane is nonzero; both planes
    are carried through one placement."""
    low, _ = _fem(2000).split_lower_diag()
    w = csr_to_well_ds(low, 16, device="cpu")
    hi, lo = w.values_hi.numpy()[None], w.values_lo.numpy()[None]
    lo = lo.copy()
    hi = hi.copy()
    # a slot whose hi plane is zero and lo is not still counts
    k, g, j = np.argwhere(hi[0] == 0)[0]
    lo[0, k, g, j] = 1e-30
    rows = pack_rows(hi, w.pos.numpy()[None], w.wseg, values_lo=lo)
    _check_layout(hi, w.pos.numpy()[None], w.wseg, rows[:3], values_lo=lo)
    assert np.count_nonzero(rows.values_lo == np.float32(1e-30)) == 1
    again = pack_rows(w.values_hi.numpy()[None], w.pos.numpy()[None], w.wseg,
                      values_lo=w.values_lo.numpy()[None])
    for got, want in zip((w.rows_values_hi, w.rows_values_lo, w.rows_pos, w.slice_ptr),
                         (again.values, again.values_lo, again.pos, again.slice_ptr)):
        assert np.array_equal(got.numpy()[None], want)


def _torch_case(name, dtype):
    (values, pos, w0), tg, wseg, rows = _case(name)
    t = torch.from_numpy
    return ((t(values.astype(dtype)), t(pos), t(w0)),
            (t(rows[0].astype(dtype)), t(rows[1]), t(rows[2]), t(w0)), tg, wseg, values)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", CASES)
def test_rows_plain_equals_well_plain(name, dtype):
    """Bit for bit: the same terms per row in the same order; padding adds
    an exact zero."""
    well, rows, tg, _, values = _torch_case(name, dtype)
    nd = values.shape[0]
    cols = well[0].shape[2] * LANES
    x2 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (nd * cols // LANES, LANES)).astype(dtype))
    want = spmv_well_stacked_plain(*well, x2, tg)
    got = spmv_well_rows_plain(*rows, x2, tg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    # the wrapper on CPU tensors takes the row-list plain version
    assert torch.equal(spmv_well_cuda.spmv_well_stacked(*rows, x2, tg), want)
    assert _build.launches["well"] == 0


@pytest.mark.parametrize("name", CASES)
def test_ds_rows_plain_equals_well_plain(name):
    well, rows, tg, wseg, values = _torch_case(name, np.float32)
    rng = np.random.default_rng(2)
    lo_v = (values * 1e-8 * rng.standard_normal(values.shape)).astype(np.float32)
    lo = torch.from_numpy(lo_v)
    # the lo plane is nonzero exactly where the values are: the same lists
    r_lo = pack_rows(values, well[1].numpy(), wseg, values_lo=lo_v).values_lo
    nd = values.shape[0]
    shape = (nd * well[0].shape[2], LANES)
    xh = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xl = xh * 1e-8
    want = spmv_well_ds_stacked_plain(well[0], lo, well[1], well[2], xh, xl, tg)
    args = (rows[0], torch.from_numpy(r_lo), *rows[1:], xh, xl, tg)
    got = spmv_well_ds_rows_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w)
               for g, w in zip(spmv_well_ds_cuda.spmv_well_ds_stacked(*args), want))
    assert _build.launches["well_ds"] == 0


def _well_block(well, xs, tg):
    """The WELL formula's block apply, column by column: the bit-equality
    witness of the row-list block applies. ``well`` is (values, pos, w0) or
    (values_hi, values_lo, pos, w0); ``xs`` one x block, or the DS pair."""
    if len(xs) == 1:
        return (from_columns([spmv_well_stacked_plain(*well, c, tg)
                              for c in columns(xs[0])]),)
    outs = [spmv_well_ds_stacked_plain(*well, h, lo, tg)
            for h, lo in zip(columns(xs[0]), columns(xs[1]))]
    return tuple(from_columns([o[i] for o in outs]) for i in range(2))


def _assert_block_rows(well, rows, xs, tg):
    """The row-list block plain apply (and its wrapper on CPU tensors)
    equals the WELL formula's block apply and, column by column, the
    single-RHS row-list plain apply, bit for bit."""
    if len(xs) == 1:
        got = (spmm_well_stacked_plain(*rows, *xs, tg),)
        wrapped = (spmm_well_cuda.spmm_well_stacked(*rows, *xs, tg),)
        singles = [(spmv_well_rows_plain(*rows, c, tg),) for c in columns(xs[0])]
    else:
        got = spmm_well_ds_stacked_plain(*rows, *xs, tg)
        wrapped = spmm_well_cuda.spmm_well_ds_stacked(*rows, *xs, tg)
        singles = [spmv_well_ds_rows_plain(*rows, h, lo, tg)
                   for h, lo in zip(columns(xs[0]), columns(xs[1]))]
    want = _well_block(well, xs, tg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(wrapped, want))
    for c, one in enumerate(singles):
        assert all(torch.equal(columns(g)[c], o) for g, o in zip(got, one))
    assert _build.launches["well_spmm"] == _build.launches["well_ds_spmm"] == 0


@pytest.mark.parametrize("kind", ["float32", "float64", "ds"])
@pytest.mark.parametrize("name", CASES)
def test_block_rows_plain_equals_well_plain(name, kind):
    """The block (SpMM) plain applies on the row lists, nrhs 1/3/8/11: the
    same terms per row in the same order as the WELL formula, column by
    column, so the same bits; and each column the single-RHS row-list
    plain apply of that column."""
    dtype = np.float64 if kind == "float64" else np.float32
    well, rows, tg, wseg, values = _torch_case(name, dtype)
    rng = np.random.default_rng(3)
    nd, xrows = values.shape[0], well[0].shape[2]
    if kind == "ds":
        lo_v = (values * 1e-8 * rng.standard_normal(values.shape)).astype(np.float32)
        r_lo = pack_rows(values, well[1].numpy(), wseg, values_lo=lo_v).values_lo
        well = (well[0], torch.from_numpy(lo_v), *well[1:])
        rows = (rows[0], torch.from_numpy(r_lo), *rows[1:])
    for nrhs in NRHS:
        x = torch.from_numpy(rng.standard_normal((nd * xrows, nrhs * LANES)).astype(dtype))
        _assert_block_rows(well, rows, (x, x * 1e-8) if kind == "ds" else (x,), tg)


def _wide_group(n_slots=140, seed=11):
    """A matrix whose first row group needs K = n_slots WELL slots (each
    of its rows has one entry in each of n_slots segments); every other row
    holds its diagonal."""
    rng = np.random.default_rng(seed)
    n = n_slots * LANES
    r = np.repeat(np.arange(LANES), n_slots)
    c = r + LANES * np.tile(np.arange(n_slots), LANES)
    rows = np.concatenate([r, np.arange(LANES, n)])
    cols = np.concatenate([c, np.arange(LANES, n)])
    return pt_csr.CSRHost.from_coo(rows, cols, rng.standard_normal(len(rows)), n, n)


@pytest.mark.parametrize("kind", ["float32", "ds"])
def test_pack_rows_past_127_slots(kind):
    """K = 140 slots (max_k=256): a row's rank counts past 127, so every
    slot lands where the layout says, and the row-list applies, single-RHS
    and block, equal the WELL formula's bit for bit."""
    a = _wide_group()
    if kind == "ds":
        w = csr_to_well_ds(a, tile_groups=1, max_k=256, device="cpu")
        well = (w.values_hi, w.values_lo, w.pos, w.w0)
        rows = (w.rows_values_hi, w.rows_values_lo, w.rows_pos, w.slice_ptr, w.w0)
    else:
        w = csr_to_well(a, tile_groups=1, max_k=256, dtype=np.float32, device="cpu")
        well = (w.values, w.pos, w.w0)
        rows = (w.rows_values, w.rows_pos, w.slice_ptr, w.w0)
    well, rows = (tuple(t.unsqueeze(0) for t in ts) for ts in (well, rows))
    assert w.k_slots == 140 and w.k_slots * w.ngroups * LANES > w.rows_pos.numel()
    lists = tuple(t.numpy() for t in (rows[0], *rows[-3:-1]))  # values, pos, ptr
    width = _check_layout(well[0].numpy(), well[-2].numpy(), w.wseg, lists,
                          values_lo=well[1].numpy() if kind == "ds" else None)
    assert width.max() == 140
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((w.ncols_pad // LANES, 3 * LANES))
                         .astype(np.float32))
    xs = (x, x * 1e-8) if kind == "ds" else (x,)
    for c in range(3):
        cx = tuple(columns(t)[c] for t in xs)
        if kind == "ds":
            got, want = (spmv_well_ds_rows_plain(*rows, *cx, 1),
                         spmv_well_ds_stacked_plain(*well, *cx, 1))
        else:
            got, want = ((spmv_well_rows_plain(*rows, *cx, 1),),
                         (spmv_well_stacked_plain(*well, *cx, 1),))
        assert all(torch.equal(g, v) for g, v in zip(got, want))
    _assert_block_rows(well, rows, xs, 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pair,tile_groups", [(False, 16), (True, 16), (False, 4)])
def test_rows_apply_matches_reference_kernel(pair, tile_groups, dtype):
    rng = np.random.default_rng(7)
    a = _banded(2000, seed=7)
    ref = ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    w_ref = ref_csr_to_well(ref, tile_groups=tile_groups, pair=pair, dtype=dtype)
    w_pt = csr_to_well(a, tile_groups=tile_groups, pair=pair, dtype=dtype, device="cpu")
    x = rng.standard_normal(a.ncols).astype(dtype)
    want = np.asarray(ref_well.spmv_well_pallas(w_ref, jnp.asarray(x), interpret=True))
    got = spmv_well(w_pt, torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.linalg.norm(got - want) <= TOL[dtype] * np.linalg.norm(want)


@pytest.mark.parametrize("tg,pair", [(2, False), (16, False), (16, True)])
def test_ds_rows_apply_matches_reference_kernel(tg, pair):
    a = _fem(2000, seed=3)
    a.values[:] = a.values * (1 + 1e-9 * np.random.default_rng(0).standard_normal(a.nnz))
    ref = ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    r = ref_well.csr_to_well_ds(ref, tile_groups=tg, pair=pair)
    p = csr_to_well_ds(a, tile_groups=tg, pair=pair, device="cpu")
    x = np.zeros(p.ncols_pad)
    x[: a.ncols] = np.random.default_rng(4).standard_normal(a.ncols) * 1e2
    xh, xl = (v.reshape(-1, LANES) for v in pt_ds.ds_from_f64(x))
    want = ref_well.spmv_well_ds_pallas_2d(r, jnp.asarray(xh), jnp.asarray(xl),
                                           interpret=True)
    got = spmv_well_ds_2d(p, torch.from_numpy(xh), torch.from_numpy(xl))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    g = pt_ds.ds_to_f64(got[0].numpy(), got[1].numpy())
    w = ref_ds.ds_to_f64(np.asarray(want[0]), np.asarray(want[1]))
    assert np.linalg.norm(g - w) <= CONTRACTION_TOL * np.linalg.norm(w)


def _through_well_formula(monkeypatch, A):
    """Route DistMatrix's single-RHS WELL applies through the WELL formula
    on the operator's own WELL arrays (the row-list operands identify the
    stack)."""
    def stack(values):
        return "" if values is A.local_rows_values else "T"

    def well(values, pos, ptr, w0, x2, tg):
        tag = stack(values)
        return spmv_well_stacked_plain(getattr(A, f"local_well{tag}_values"),
                                       getattr(A, f"local_well{tag}_pos"), w0, x2, tg)

    def well_ds(vh, vl, pos, ptr, w0, xh2, xl2, tg):
        tag = stack(vh)
        return spmv_well_ds_stacked_plain(
            getattr(A, f"local_well{tag}_values"), getattr(A, f"local_well{tag}_values_lo"),
            getattr(A, f"local_well{tag}_pos"), w0, xh2, xl2, tg)

    def block(*args):
        tag, lo = stack(args[0]), len(args) == 8
        well = (getattr(A, f"local_well{tag}_values"),
                *([getattr(A, f"local_well{tag}_values_lo")] if lo else []),
                getattr(A, f"local_well{tag}_pos"), args[-4 if lo else -3])
        out = _well_block(well, args[-3:-1] if lo else args[-2:-1], args[-1])
        return out if lo else out[0]

    monkeypatch.setattr(dm, "spmv_well_stacked", well)
    monkeypatch.setattr(dm, "spmv_well_ds_stacked", well_ds)
    monkeypatch.setattr(dm, "spmm_well_stacked", block)
    monkeypatch.setattr(dm, "spmm_well_ds_stacked", block)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("fmt", ["well", "well_ds"])
def test_dist_matvec_runs_through_rows(fmt, n_dev, symmetric, monkeypatch):
    """matvec / matvec_ds read the row lists (a spy sees them), agree with
    the host oracle, and equal the same apply through the WELL formula bit
    for bit."""
    a = _fem(3000, seed=1)
    A = dm.build_dist_matrix(a, n_devices=n_dev, symmetric=symmetric, local_format=fmt,
                             dtype=np.float64 if fmt == "well" else None, device="cpu")
    x = np.random.default_rng(5).standard_normal(a.nrows)
    seen = []
    wrapper = {"well": dm.spmv_well_stacked, "well_ds": dm.spmv_well_ds_stacked}[fmt]

    def spy(*args):
        seen.append(args[0])
        return wrapper(*args)

    with monkeypatch.context() as m:
        m.setattr(dm, "spmv_well_stacked" if fmt == "well" else "spmv_well_ds_stacked", spy)
        if fmt == "well":
            y = A.matvec(A.to_dist(x))
        else:
            xs = [A.to_dist(p) for p in pt_ds.ds_from_f64(x)]
            y = A.matvec_ds(*xs)
    stacks = [A.local_rows_values] + ([A.local_rowsT_values] if symmetric else [])
    assert len(seen) == len(stacks) and all(s is t for s, t in zip(seen, stacks))
    want = a.matvec(x)
    got = (A.from_dist(y) if fmt == "well"
           else pt_ds.ds_to_f64(A.from_dist(y[0]), A.from_dist(y[1])))
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)
    _through_well_formula(monkeypatch, A)
    if fmt == "well":
        assert torch.equal(A.matvec(A.to_dist(x)), y)
    else:
        assert all(torch.equal(g, w) for g, w in zip(A.matvec_ds(*xs), y))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("fmt", ["well", "well_ds"])
def test_dist_matmat_runs_through_rows(fmt, n_dev, monkeypatch):
    """matmat (symmetric, both stacks) and matmat_ds (vanilla, as the
    block refinement builds it) hand the block kernels the row lists (a spy
    sees them), agree with the host oracle, and equal the same apply
    through the WELL formula bit for bit."""
    a = _fem(3000, seed=6)
    symmetric = fmt == "well"
    A = dm.build_dist_matrix(a, n_devices=n_dev, symmetric=symmetric, local_format=fmt,
                             dtype=np.float64 if fmt == "well" else None, device="cpu")
    X = np.random.default_rng(8).standard_normal((a.nrows, 3))
    name = "spmm_well_stacked" if fmt == "well" else "spmm_well_ds_stacked"
    wrapper, seen = getattr(dm, name), []

    def spy(*args):
        seen.append(args[0])
        return wrapper(*args)

    def apply():
        if fmt == "well":
            return (A.matmat(A.to_dist_block(X)),)
        return A.matmat_ds(*[A.to_dist_block(p) for p in pt_ds.ds_from_f64(X)])

    with monkeypatch.context() as m:
        m.setattr(dm, name, spy)
        y = apply()
    stacks = [A.local_rows_values] + ([A.local_rowsT_values] if symmetric else [])
    assert len(seen) == len(stacks) and all(s is t for s, t in zip(seen, stacks))
    got = (A.from_dist_block(y[0]) if fmt == "well"
           else pt_ds.ds_to_f64(*(A.from_dist_block(t) for t in y)))
    want = np.stack([a.matvec(c) for c in X.T], axis=1)
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)
    _through_well_formula(monkeypatch, A)
    assert all(torch.equal(g, w) for g, w in zip(apply(), y))


@pytest.mark.parametrize("fmt", ["well", "well_ds"])
def test_converted_operator_derives_rows(fmt):
    """convert.dist_matrix_from_numpy derives the row lists from the
    reference's WELL arrays: the same lists, the same matvec bits."""
    a = _fem(3000, seed=2, dtype=np.float64)
    ref = ref_csr.CSRHost(a.rowptr, a.colind, a.values, a.ncols)
    R = ref_build(ref, n_devices=2, symmetric=True, local_format=fmt)
    P = dm.build_dist_matrix(a, n_devices=2, symmetric=True, local_format=fmt,
                             device="cpu")
    names = ["remote_colind", "remote_values", "jacobi_diag", "diagonal"]
    for tag in ("", "T"):
        names += [f"local_well{tag}_{f}" for f in ("values", "pos", "w0")]
        names += [f"far{tag}_{f}" for f in ("rows", "cols", "vals")]
    if fmt == "well_ds":
        names += ["local_colind", "local_values", "local_values_lo", "diagonal_lo",
                  "remote_values_lo", "local_well_values_lo", "local_wellT_values_lo",
                  "farT_cols", "farT_vals", "farT_vals_lo", "remoteT_colind",
                  "remoteT_vals", "remoteT_vals_lo"]
    arrays = {k: np.asarray(getattr(R, k)) for k in names
              if getattr(R, k, None) is not None}
    arrays.update({k: np.asarray(getattr(R.plan, k))
                   for k in ("send_idx", "recv_pos", "nlocal", "nghosts")})
    meta = dict(nrows_global=R.nrows_global, ncols_global=R.ncols_global,
                row_pad=R.row_pad, symmetric=R.symmetric, nnz_global=R.nnz_global,
                local_format=R.local_format, rounds=R.plan.rounds,
                n_devices=R.n_devices, nlocal_pad=R.plan.nlocal_pad,
                nghost_pad=R.plan.nghost_pad, well_meta=R.well_meta,
                well_far_nnz=R.well_far_nnz, wellT_meta=R.wellT_meta,
                well_farT_nnz=R.well_farT_nnz)
    C = dist_matrix_from_numpy(arrays, meta, device="cpu")
    fields = [f"local_rows{tag}_{f}" for tag in ("", "T") for f in ("values", "pos", "ptr")]
    if fmt == "well_ds":
        fields += ["local_rows_values_lo", "local_rowsT_values_lo"]
    for name in fields:
        assert torch.equal(getattr(C, name), getattr(P, name)), name
    x = np.random.default_rng(9).standard_normal(a.nrows)
    if fmt == "well":
        assert torch.equal(C.matvec(P.to_dist(x)), P.matvec(P.to_dist(x)))
    else:
        xs = [P.to_dist(p) for p in pt_ds.ds_from_f64(x)]
        assert all(torch.equal(g, w) for g, w in zip(C.matvec_ds(*xs), P.matvec_ds(*xs)))
