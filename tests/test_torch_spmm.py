"""spmv_torch block (multi-RHS) apply vs the spmv_tpu reference.

The same numpy-seeded blocks go through both packages. The SpMM lane
layout must be the reference's bit for bit. The plain block applies (the
CPU path of the five block kernels) are held against the reference's
Pallas kernels in interpret mode at nrhs 1, 3 and 5, with the single-RHS
files' tolerances: relative L2 1e-6 in float32 and 1e-13 in float64 (the
same products, summed in the same order; the last bits may differ with
the backend's FMA use); double-single against ``spmm_dia_ds_xla`` run op
by op bit for bit, and against XLA-compiled reference code with hi planes
equal and hi + lo within 4e-15 (XLA:CPU contracts ``ds_mul_f32``'s cross
term; ``test_torch_ds.py``). ``DistMatrix.matmat`` / ``matmat_ds`` are held
against the reference's on the 8-device virtual CPU mesh at np 1, 2 and 4
(float64, relative L2 1e-12 per column, the single-RHS distributed
tolerance), and each block column against the port's own single-RHS
apply of that column.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_tpu.formats.csr as ref_csr
import spmv_tpu.gen as ref_gen
from spmv_tpu.formats.dia import csr_to_dia as ref_csr_to_dia
from spmv_tpu.formats.well import csr_to_well as ref_csr_to_well
from spmv_tpu.ops import spmm_dia_pallas as ref_spmm_dia
from spmv_tpu.ops import spmm_well_pallas as ref_spmm_well
from spmv_tpu.ops import spmv_dia_ds_pallas as ref_dia_ds
from spmv_tpu.ops import spmv_well_pallas as ref_well
from spmv_tpu.parallel.dist_matrix import build_dist_matrix as ref_build

import spmv_torch.formats.csr as pt_csr
import spmv_torch.gen as pt_gen
from spmv_torch import _build
from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.ds import ds_from_f64, ds_to_f64
from spmv_torch.formats.dia import csr_to_dia
from spmv_torch.formats.well import csr_to_well
from spmv_torch.ops import spmm_dia_cuda, spmv_dia_cuda, spmv_dia_ds_cuda
from spmv_torch.ops.spmm_dia import (
    columns,
    spmm_dia,
    spmm_dia_stacked_plain,
    spmm_from_layout,
    spmm_to_layout,
)
from spmv_torch.ops.spmm_well import spmm_well_2d, spmm_well_ds_2d
from spmv_torch.ops.spmv_dia_ds import (
    csr_to_dia_ds,
    spmm_dia_ds_2d,
    spmv_dia_ds_stacked_plain,
)
from spmv_torch.ops.spmv_well_ds import csr_to_well_ds
from spmv_torch.parallel import comm_plan
from spmv_torch.parallel.dist_matrix import build_dist_matrix

TOL = {np.float32: 1e-6, np.float64: 1e-13}
NRHS = (1, 3, 5)
DIST_TOL = 1e-12
CONTRACTION_TOL = 4e-15


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
    assert _build.launches["dia_spmm"] == _build.launches["dia_sym_spmm"] == 0
    assert _build.launches["well_spmm"] == _build.launches["well_ds_spmm"] == 0
    assert _build.launches["dia_ds_spmm"] == 0


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _pair(rows, cols, vals, n):
    return (ref_csr.CSRHost.from_coo(rows, cols, vals, n, n),
            pt_csr.CSRHost.from_coo(rows, cols, vals, n, n))


def _banded_random_spd(n=2000, seed=0, diag=3.0):
    """Unique-columns banded-random symmetric SPD host matrix, as the
    reference's ``tests/test_spmm.py:251`` builds it (both packages)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-170, -1, 1, 130):
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.8]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)) * 0.1)
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    i = np.concatenate([rows, cols, np.arange(n)])
    j = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, diag)])
    return _pair(i, j, v, n)


def _banded(n=3000, seed=5, offsets=(-900, -130, -1, 0, 2, 128, 1100)):
    """The bench's banded random WELL generator at test size."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.8]
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return _pair(rows, cols, rng.standard_normal(len(rows)), n)


def _block(n, nrhs, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, nrhs)).astype(dtype)


# ----------------------------------------------------------------- layout


def test_layout_roundtrip_matches_reference():
    a = pt_gen.create_laplace_2d(32, 32)
    d = csr_to_dia(a, dtype=np.float32, row_align=1024, device="cpu")
    r = ref_csr_to_dia(ref_gen.create_laplace_2d(32, 32), dtype=np.float32,
                       row_align=1024)
    X = _block(a.nrows, 4, 3, np.float32)
    lay = spmm_to_layout(d, X)
    want = ref_spmm_dia.spmm_to_layout(r, jnp.asarray(X))
    assert lay.shape == (d.nrows_pad // 128, 4 * 128)
    assert np.array_equal(lay.numpy(), np.asarray(want))
    back = spmm_from_layout(lay, 4)
    assert np.array_equal(back.numpy(), np.asarray(ref_spmm_dia.spmm_from_layout(want, 4)))
    assert np.array_equal(back[: a.nrows].numpy(), X)
    # column r of the layout is lane slice r: a single-RHS apply reads it as is
    assert np.array_equal(columns(lay)[2].numpy().ravel()[: a.nrows], X[:, 2])


# ------------------------------------------------------------ block kernels


def _dia_pair(kind):
    if kind == "lap2d":
        return ref_gen.create_laplace_2d(64, 64), pt_gen.create_laplace_2d(64, 64)
    return ref_gen.create_laplace_3d(16), pt_gen.create_laplace_3d(16)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("kind,dtype", [("lap2d", np.float32), ("lap3d", np.float32),
                                        ("lap2d", np.float64)])
def test_plain_spmm_dia_matches_reference_kernel(kind, dtype, symmetric):
    """Vanilla storage against ``_spmm_dia_pallas_2d``, symmetric against
    ``_spmv_dia_sym_pallas_2d(nrhs=...)`` (both reached through the
    reference's ``spmm_dia``); the 3-D stencil has a 256-row halo."""
    ref, pt = _dia_pair(kind)
    r = ref_csr_to_dia(ref, dtype=dtype, row_align=4096, symmetric=symmetric)
    p = csr_to_dia(pt, dtype=dtype, row_align=4096, symmetric=symmetric, device="cpu")
    X = _block(pt.nrows, 5, 5, dtype)
    want = np.asarray(ref_spmm_dia.spmm_dia(r, jnp.asarray(X), interpret=True))
    oracle = np.stack([pt.matvec(c.astype(np.float64)) for c in X.T], axis=1)
    for nrhs in NRHS:
        got = spmm_dia(p, X[:, :nrhs]).numpy()
        assert got.dtype == dtype and got.shape == (p.nrows_pad, nrhs)
        assert _rel(got, want[:, :nrhs]) <= TOL[dtype]
        assert _rel(got[: pt.nrows], oracle[:, :nrhs]) <= 10 * TOL[dtype]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_plain_bf16_dia_matches_reference_kernels(nrhs, symmetric):
    """bf16 DIA storage (the reference's ``test_bf16_storage_ell_and_dia``
    and ``test_dia_sym_pallas_bf16_interpret`` cases): the plain applies
    accumulate in float32 and round y once to bf16, as the reference's
    ``_dia_kernel``, ``_dia_sym_kernel`` and ``_dia_mrhs_kernel`` do in
    interpret mode (nrhs 1 through ``spmv_dia_pallas_2d``, nrhs 3 through
    ``spmm_dia``). The same bf16 inputs on both sides; the float32 sums
    run in another order, which can move a bf16 rounding by one ulp
    (2^-8): relative L2 <= 4e-3; both within the reference's 4e-2 of the
    float64 oracle."""
    from spmv_tpu.ops.spmv_dia_pallas import dia_to_2d, spmv_dia_pallas_2d

    ref, pt = _dia_pair("lap2d")
    r = ref_csr_to_dia(ref, dtype=jnp.bfloat16, row_align=4096, symmetric=symmetric)
    p = csr_to_dia(pt, dtype=torch.bfloat16, row_align=4096, symmetric=symmetric,
                   device="cpu")
    assert np.array_equal(p.data.float().numpy(), np.asarray(r.data, np.float32))
    X = _block(pt.nrows, nrhs, 6, np.float32)
    Xb = np.asarray(jnp.asarray(X, jnp.bfloat16), np.float32)  # the bf16 inputs
    if nrhs == 1:
        x = np.pad(X[:, 0], (0, r.nrows_pad - pt.nrows))
        want = np.asarray(spmv_dia_pallas_2d(
            r, dia_to_2d(r, jnp.asarray(x)).astype(jnp.bfloat16), interpret=True),
            np.float32).reshape(-1, 1)
        got = spmv_dia_cuda.spmv_dia_2d(
            p, torch.as_tensor(x).to(torch.bfloat16).view(-1, 128)).reshape(-1, 1)
    else:
        want = np.asarray(ref_spmm_dia.spmm_dia(r, jnp.asarray(X, jnp.bfloat16),
                                                interpret=True), np.float32)
        got = spmm_dia(p, torch.as_tensor(X).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _rel(got, want) <= 4e-3
    oracle = np.stack([pt.matvec(c.astype(np.float64)) for c in Xb.T], axis=1)
    for y in (got, want):
        assert _rel(y[: pt.nrows], oracle) <= 4e-2


def test_plain_spmm_dia_columns_equal_single_rhs():
    """Column r of the plain block apply is the single-RHS plain apply of
    column r, bit for bit, on D=3 stacked shards with odd offsets."""
    rng = np.random.default_rng(4)
    for symmetric, offs in ((False, (-301, -37, -1, 0, 1, 37, 301)),
                            (True, (-301, -37, -5, -1, 0))):
        data = torch.from_numpy(rng.standard_normal((3, 24, len(offs) * 128)))
        x2 = torch.from_numpy(rng.standard_normal((72, 5 * 128)))
        y = spmm_dia_cuda.spmm_dia_stacked(data, x2, offs, symmetric)
        for c, yc in zip(columns(x2), columns(y)):
            one = spmm_dia_stacked_plain(data, c, offs, symmetric)
            assert torch.equal(yc, one)


def _well_case(case):
    if case == "banded":
        ref, pt = _banded()
        return ref, pt, dict(tile_groups=16)
    if case == "paired":
        ref, pt = _banded(seed=7)
        return ref, pt, dict(tile_groups=16, pair=True)
    if case == "int32":
        ref, pt = _banded(seed=8)
        return ref, pt, dict(tile_groups=2)
    ref, pt = _banded_random_spd()
    return ref, pt, dict(tile_groups=8)


@pytest.mark.parametrize("case,dtype", [("banded", np.float32), ("paired", np.float64),
                                        ("int32", np.float64), ("spd", np.float32)])
def test_plain_spmm_well_matches_reference_kernel(case, dtype):
    ref, pt, kw = _well_case(case)
    r = ref_csr_to_well(ref, dtype=dtype, **kw)
    p = csr_to_well(pt, dtype=dtype, device="cpu", **kw)
    assert p.paired == kw.get("pair", False)
    assert p.pos.dtype == (torch.int32 if kw["tile_groups"] < 16 else torch.int16)
    X = np.zeros((p.ncols_pad, 5), dtype)
    X[: pt.ncols] = _block(pt.ncols, 5, 15, dtype)
    want = np.asarray(ref_spmm_well.spmm_well_pallas_2d(
        r, jnp.asarray(spmm_to_layout(p, X).numpy()), 5, interpret=True))
    for nrhs in NRHS:
        got = spmm_well_2d(p, spmm_to_layout(p, X[:, :nrhs])).numpy()
        assert got.dtype == dtype
        assert _rel(got, want.reshape(-1, 5, 128)[:, :nrhs].reshape(-1, nrhs * 128)) <= TOL[dtype]


def _ds_lanes(X):
    """(hi, lo) float32 SpMM lane-layout blocks of a float64 (npad, nrhs)."""
    npad, nrhs = X.shape
    return [torch.from_numpy(p.reshape(npad // 128, 128, nrhs).transpose(0, 2, 1)
                             .reshape(npad // 128, nrhs * 128).copy())
            for p in ds_from_f64(X)]


def _perturbed(ref, pt, seed):
    rng = np.random.default_rng(seed)
    ref.values[:] = ref.values * (1 + 1e-9 * rng.standard_normal(ref.nnz))
    pt.values[:] = ref.values
    return ref, pt


def _assert_matches_compiled(got, want, hi_equal=True):
    """(hi, lo) against XLA-compiled reference code. Within one kernel the
    contracted cross term moves only the lo plane; where a compiled chain
    adds such terms (the distributed remote chain), it can carry into the
    hi plane's last bit, so those compare hi + lo alone."""
    if hi_equal:
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    g = ds_to_f64(got[0].numpy(), got[1].numpy())
    w = ds_to_f64(np.asarray(want[0]), np.asarray(want[1]))
    assert np.linalg.norm(g - w) <= CONTRACTION_TOL * np.linalg.norm(w)


def _lane_cols(t, nrhs):
    """The first nrhs columns of a lane-layout block (numpy or jax)."""
    t = np.asarray(t)
    return t.reshape(t.shape[0], -1, 128)[:, :nrhs].reshape(t.shape[0], nrhs * 128)


def test_plain_spmm_dia_ds_matches_reference():
    """The port's DS block apply against ``spmm_dia_ds_xla`` op by op (bit
    for bit) and the Pallas DS block kernel in interpret mode."""
    ref, pt = _perturbed(ref_gen.create_laplace_2d(40, 33),
                         pt_gen.create_laplace_2d(40, 33), 2)
    r = ref_dia_ds.csr_to_dia_ds(ref, row_align=1024)
    p = csr_to_dia_ds(pt, row_align=1024, device="cpu")
    X = np.zeros((p.nrows_pad, 5))
    X[: pt.nrows] = _block(pt.nrows, 5, 25) * 1e3
    xs = [jnp.asarray(t.numpy()) for t in _ds_lanes(X)]
    op_by_op = ref_dia_ds.spmm_dia_ds_xla(r, *xs, 5)
    kernel = ref_dia_ds.spmm_dia_ds_pallas_2d(r, *xs, 5, interpret=True)
    oracle = np.stack([pt.matvec(c) for c in X[: pt.nrows].T], axis=1)
    for nrhs in NRHS:
        got = spmm_dia_ds_2d(p, *_ds_lanes(X[:, :nrhs]))
        for g, w in zip(got, op_by_op):
            assert np.array_equal(g.numpy(), _lane_cols(w, nrhs))
        _assert_matches_compiled(got, [_lane_cols(w, nrhs) for w in kernel])
        y = ds_to_f64(*(spmm_from_layout(t, nrhs).numpy() for t in got))[: pt.nrows]
        assert _rel(y, oracle[:, :nrhs]) < 1e-13


@pytest.mark.parametrize("tg,pair", [(16, False), (8, True)])
def test_plain_spmm_well_ds_matches_reference(tg, pair):
    from spmv_torch.ops.spmv_well_ds import spmv_well_ds_2d

    ref, pt = _perturbed(ref_gen.random_csr(600, 600, 6, seed=1),
                         pt_gen.random_csr(600, 600, 6, seed=1), 3)
    r = ref_well.csr_to_well_ds(ref, tile_groups=tg, pair=pair)
    p = csr_to_well_ds(pt, tile_groups=tg, pair=pair, device="cpu")
    X = np.zeros((p.ncols_pad, 5))
    X[:600] = _block(600, 5, 35) * 1e2
    kernel = ref_spmm_well.spmm_well_ds_pallas_2d(
        r, *[jnp.asarray(t.numpy()) for t in _ds_lanes(X)], 5, interpret=True)
    for nrhs in NRHS:
        xh2, xl2 = _ds_lanes(X[:, :nrhs])
        got = spmm_well_ds_2d(p, xh2, xl2)
        _assert_matches_compiled(got, [_lane_cols(w, nrhs) for w in kernel])
        # column c is the single-RHS plain DS apply of column c, bit for bit
        for c, (h, lo) in enumerate(zip(columns(xh2), columns(xl2))):
            one = spmv_well_ds_2d(p, h, lo)
            assert all(torch.equal(columns(g)[c], o) for g, o in zip(got, one))


def test_plain_spmm_dia_ds_reads_only_its_own_shard():
    """D=3 stacked shards: each shard's block equals the reference's
    op-by-op block apply of its own data, x zero outside the shard."""
    rng = np.random.default_rng(3)
    offs = (-301, -37, -5, -1, 0, 1, 5, 37, 301)
    nd, nr, nrhs = 3, 16, 2
    dh = rng.standard_normal((nd, nr, len(offs) * 128)).astype(np.float32)
    dl = (dh * 1e-8 * rng.standard_normal(dh.shape)).astype(np.float32)
    xh = rng.standard_normal((nd * nr, nrhs * 128)).astype(np.float32)
    xl = (xh * 1e-8 * rng.standard_normal(xh.shape)).astype(np.float32)
    yh, yl = spmv_dia_ds_cuda.spmm_dia_ds_stacked(
        *map(torch.from_numpy, (dh, dl, xh, xl)), offs)
    for s in range(nd):
        m = ref_dia_ds.DiaDsMatrix(data_hi=jnp.asarray(dh[s]), data_lo=jnp.asarray(dl[s]),
                                   offsets=offs, nrows=nr * 128, ncols=nr * 128)
        rows = slice(s * nr, (s + 1) * nr)
        wh, wl = ref_dia_ds.spmm_dia_ds_xla(m, jnp.asarray(xh[rows]),
                                            jnp.asarray(xl[rows]), nrhs)
        assert np.array_equal(yh[rows].numpy(), np.asarray(wh))
        assert np.array_equal(yl[rows].numpy(), np.asarray(wl))
    # and column by column equal to the single-RHS plain apply
    for c, (h, lo) in enumerate(zip(columns(torch.from_numpy(xh)),
                                    columns(torch.from_numpy(xl)))):
        one = spmv_dia_ds_stacked_plain(torch.from_numpy(dh), torch.from_numpy(dl),
                                        h, lo, offs)
        assert torch.equal(columns(yh)[c], one[0]) and torch.equal(columns(yl)[c], one[1])


# -------------------------------------------------------------- block halo


def test_block_halo_moves_every_column():
    """halo_gather / halo_scatter_add on a (D, n, nrhs) block equal the
    single-column exchanges column by column, padding slots included."""
    _, pt = _random_sym()
    P = build_dist_matrix(pt, n_devices=4, symmetric=True, local_format="ell",
                          device="cpu")
    plan = P.plan
    assert (plan.recv_pos == int(comm_plan.OOB)).any() and len(plan.rounds) > 1
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, plan.nlocal_pad, 3)))
    g = comm_plan.halo_gather(x, plan.send_idx, plan.recv_pos, plan.rounds,
                              plan.nghost_pad)
    assert g.shape == (4, plan.nghost_pad, 3)
    gz = torch.from_numpy(rng.standard_normal((4, plan.nghost_pad, 3)))
    y = comm_plan.halo_scatter_add(gz, x, plan.send_idx, plan.recv_pos, plan.rounds)
    for c in range(3):
        gc = comm_plan.halo_gather(x[:, :, c].contiguous(), plan.send_idx,
                                   plan.recv_pos, plan.rounds, plan.nghost_pad)
        assert torch.equal(g[:, :, c], gc)
        yc = comm_plan.halo_scatter_add(gz[:, :, c].contiguous(),
                                        x[:, :, c].contiguous(), plan.send_idx,
                                        plan.recv_pos, plan.rounds)
        assert torch.equal(y[:, :, c], yc)


# ------------------------------------------------------ DistMatrix.matmat


def _lap():
    return ref_gen.create_laplace_2d(16, 24), pt_gen.create_laplace_2d(16, 24)


def _random_sym():
    return (ref_gen.random_csr(700, 700, 5, seed=65, symmetric=True, spd_shift=2.0),
            pt_gen.random_csr(700, 700, 5, seed=65, symmetric=True, spd_shift=2.0))


ROUTES = [("dia", False, _lap), ("dia", True, _lap), ("ell", False, _lap),
          ("ell", True, _random_sym), ("well", False, _random_sym),
          ("well", True, _random_sym)]
ROUTE_IDS = [f"{f}-{'sym' if s else 'van'}" for f, s, _ in ROUTES]


def _carried_across(R):
    """The port operator ``convert.dist_matrix_from_numpy`` makes from a
    reference DistMatrix's fields."""
    arrays = {k: np.asarray(v) for k, v in vars(R).items() if isinstance(v, jax.Array)}
    arrays.update({k: np.asarray(getattr(R.plan, k))
                   for k in ("send_idx", "recv_pos", "nlocal", "nghosts")})
    meta = dict(nrows_global=R.nrows_global, ncols_global=R.ncols_global,
                row_pad=R.row_pad, symmetric=R.symmetric, nnz_global=R.nnz_global,
                local_format=R.local_format, dia_offsets=R.dia_offsets,
                rounds=R.plan.rounds, n_devices=R.n_devices,
                nlocal_pad=R.plan.nlocal_pad, nghost_pad=R.plan.nghost_pad,
                well_meta=R.well_meta, well_far_nnz=R.well_far_nnz,
                wellT_meta=R.wellT_meta, well_farT_nnz=R.well_farT_nnz)
    return dist_matrix_from_numpy(arrays, meta, device="cpu")


@pytest.mark.parametrize("fmt,symmetric,mat", ROUTES, ids=ROUTE_IDS)
def test_matmat_matches_reference(fmt, symmetric, mat):
    """At np 1, 2 and 4 every column of the port's block apply agrees with
    the host oracle and with the port's own matvec of that column; at
    np = 4 the reference's matmat on the virtual mesh gives the same
    numbers, and an operator carried across from the reference's fields
    (``convert``) gives the port's own bits."""
    ref, pt = mat()
    X = _block(pt.nrows, 3, 40)
    oracle = np.stack([pt.matvec(c) for c in X.T], axis=1)
    for n_dev in (1, 2, 4):
        P = build_dist_matrix(pt, n_devices=n_dev, symmetric=symmetric,
                              local_format=fmt, dtype=np.float64, device="cpu")
        xb = P.to_dist_block(X)
        y = P.matmat(xb)
        assert y.shape == xb.shape and y.dtype == torch.float64
        got = P.from_dist_block(y)
        for c in range(3):
            assert _rel(got[:, c], oracle[:, c]) <= DIST_TOL
            one = P.from_dist(P.matvec(P.to_dist(X[:, c].copy())))
            assert _rel(got[:, c], one) <= DIST_TOL
    R = ref_build(ref, n_devices=4, symmetric=symmetric, local_format=fmt,
                  dtype=np.float64)
    assert np.array_equal(xb.numpy(), np.asarray(R.to_dist_block(X)))
    want = R.from_dist_block(jax.jit(lambda M, v: M.matmat(v))(R, R.to_dist_block(X)))
    for c in range(3):
        assert _rel(got[:, c], want[:, c]) <= DIST_TOL
    assert torch.equal(_carried_across(R).matmat(xb), y)


def _ds_block(P, X):
    return [P.to_dist_block(p) for p in ds_from_f64(X)]


@pytest.mark.parametrize("fmt", ["dia_ds", "well_ds"])
def test_matmat_ds_matches_reference(fmt):
    """At np 1, 2 and 4 every column is bit-equal to the port's own
    ``matvec_ds`` of that column and < 1e-13 from the host f64 oracle; at
    np = 4 hi + lo is within the contraction tolerance of the reference's
    (XLA-compiled) block apply, and an operator carried across from the
    reference's fields gives the port's own bits."""
    ref, pt = (_perturbed(*_lap(), 6) if fmt == "dia_ds" else
               (ref_gen.random_csr(700, 700, 5, seed=95),
                pt_gen.random_csr(700, 700, 5, seed=95)))
    X = _block(pt.nrows, 3, 50) * 1e3
    oracle = np.stack([pt.matvec(c) for c in X.T], axis=1)
    for n_dev in (1, 2, 4):
        P = build_dist_matrix(pt, n_devices=n_dev, local_format=fmt, device="cpu")
        xs = _ds_block(P, X)
        yh, yl = P.matmat_ds(*xs)
        assert yh.dtype == yl.dtype == torch.float32
        Yh, Yl = P.from_dist_block(yh), P.from_dist_block(yl)
        for c in range(3):
            h, lo = ds_from_f64(X[:, c].copy())
            vh, vl = P.matvec_ds(P.to_dist(h), P.to_dist(lo))
            assert np.array_equal(Yh[:, c], P.from_dist(vh))
            assert np.array_equal(Yl[:, c], P.from_dist(vl))
        assert _rel(ds_to_f64(Yh, Yl), oracle) < 1e-13
    R = ref_build(ref, n_devices=4, local_format=fmt)
    wh, wl = jax.jit(lambda M, h, lo: M.matmat_ds(h, lo))(
        R, *[R.to_dist_block(p) for p in ds_from_f64(X)])
    _assert_matches_compiled((torch.from_numpy(Yh), torch.from_numpy(Yl)),
                             (R.from_dist_block(wh), R.from_dist_block(wl)),
                             hi_equal=False)
    for got, want in zip(_carried_across(R).matmat_ds(*xs), (yh, yl)):
        assert torch.equal(got, want)


def test_matmat_ds_far_chain():
    """A window split with a far remainder: the per-column DS far chain
    keeps every column bit-equal to matvec_ds and f64-class."""
    pt = _long_range_sym()
    n = pt.nrows
    P = build_dist_matrix(pt, local_format="well_ds", device="cpu")
    assert P.well_far_nnz > 0
    X = _block(n, 2, 7)
    yh, yl = P.matmat_ds(*_ds_block(P, X))
    for c in range(2):
        h, lo = ds_from_f64(X[:, c].copy())
        vh, vl = P.matvec_ds(P.to_dist(h), P.to_dist(lo))
        assert torch.equal(columns(yh)[c], vh) and torch.equal(columns(yl)[c], vl)
    got = ds_to_f64(P.from_dist_block(yh), P.from_dist_block(yl))
    assert _rel(got, np.stack([pt.matvec(c) for c in X.T], axis=1)) < 1e-13


def _long_range_sym(n=80_000, pairs=300, seed=3):
    """Tridiagonal plus entries joining the first and the last rows
    (``test_matmat_ds_far_chain``'s matrix): every shard's window split
    leaves a far remainder in both triangles."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pi, pj = rng.integers(0, 5000, pairs), rng.integers(n - 5000, n, pairs)
    rows = np.concatenate([i, i[1:], i[:-1], pi, pj])
    cols = np.concatenate([i, i[:-1], i[1:], pj, pi])
    vals = np.concatenate([np.full(n, 4.0), np.full(2 * (n - 1), -1.0),
                           np.full(2 * pairs, -0.5)])
    return pt_csr.CSRHost.from_coo(rows, cols, vals, n, n)


@pytest.mark.parametrize("case", ["well-far", "ell-ghosts", "well_sym-far",
                                  "transpose-well-far", "transpose-dia-ghosts",
                                  "transpose-ell-hubs", "standalone-ell-sym",
                                  "standalone-ell-transpose"])
def test_applies_call_no_scatter_add(case, monkeypatch):
    """matvec and matmat of a symmetric fp32 "well" operator with far
    remainders in both triangles, and of a symmetric "ell" operator with
    ghosts at np 4 (and the format-level spmv_well_sym with far
    remainders) call no index_add / scatter_add, which sum with atomics on
    the card; they still agree with the host oracle. So does
    matvec_transpose of non-symmetric fp32 operators: "well" with far
    remainders, "dia" with ghosts at np 4, "ell" with hub rows and ghosts
    at np 2 (its tables built before the patch, at the first apply). So do
    the standalone ELL format's symmetric ``spmv_ell`` and
    ``spmv_ell_transpose``, whose transpose terms the reference sums by
    scatter-add."""
    from spmv_torch.formats.well import csr_to_well_sym
    from spmv_torch.ops.spmv_well import spmv_well_sym

    def refuse(*args, **kwargs):
        raise AssertionError("an apply called a scatter-add")

    if case.startswith("transpose"):
        _transpose_no_scatter_add(case, refuse, monkeypatch)
        return
    if case.startswith("standalone"):
        _standalone_ell_no_scatter_add(case, refuse, monkeypatch)
        return
    pt = _random_sym()[1] if case == "ell-ghosts" else _long_range_sym()
    rng = np.random.default_rng(12)
    X = rng.standard_normal((pt.nrows, 3)).astype(np.float32)
    want = np.stack([pt.matvec(c.astype(np.float64)) for c in X.T], axis=1)
    if case == "well_sym-far":
        S = csr_to_well_sym(pt, tile_groups=16, dtype=np.float32, device="cpu")
        assert S.farl_ell is not None and S.faru_ell is not None
    else:
        fmt, n_dev = ("ell", 4) if case == "ell-ghosts" else ("well", 1)
        P = build_dist_matrix(pt, n_devices=n_dev, symmetric=True, dtype=np.float32,
                              local_format=fmt, device="cpu")
        if fmt == "well":
            assert P.far_ell_colind is not None and P.farT_ell_colind is not None
        else:
            assert P.plan.nghost_pad > 0 and P.remoteT_colind is not None
    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                        (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)
    if case == "well_sym-far":
        got = spmv_well_sym(S, torch.from_numpy(X[:, 0].copy())).numpy()[: pt.nrows]
        assert _rel(got, want[:, 0]) <= 2e-6
        return
    y = P.from_dist(P.matvec(P.to_dist(X[:, 0].copy())))
    Y = P.from_dist_block(P.matmat(P.to_dist_block(X)))
    assert _rel(y, want[:, 0]) <= 2e-6 and _rel(Y, want) <= 2e-6


def _standalone_ell_no_scatter_add(case, refuse, monkeypatch):
    from spmv_torch.formats.ell import csr_to_ell
    from spmv_torch.ops.spmv_ell import spmv_ell, spmv_ell_transpose

    pt = _long_range_sym(n=20_000, pairs=100)
    if case == "standalone-ell-transpose":
        # row scaling makes the operator non-symmetric
        s = np.random.default_rng(16).uniform(0.5, 1.5, pt.nrows)
        pt = pt_csr.CSRHost(pt.rowptr, pt.colind, pt.values * np.repeat(s, pt.row_nnz()),
                            pt.ncols)
    e = csr_to_ell(pt, symmetric=case == "standalone-ell-sym", dtype=np.float32,
                   device="cpu")
    x = np.random.default_rng(15).standard_normal(pt.nrows).astype(np.float32)
    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                        (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)
    if case == "standalone-ell-sym":
        y = spmv_ell(e, torch.from_numpy(x)).numpy()[: pt.nrows]
        want = pt.matvec(x.astype(np.float64))
    else:
        y = spmv_ell_transpose(e, torch.from_numpy(x)).numpy()[: pt.ncols]
        want = pt.transpose().matvec(x.astype(np.float64))
    assert _rel(y, want) <= 2e-6


def _transpose_no_scatter_add(case, refuse, monkeypatch):
    from spmv_torch.corpus import powerlaw_laplacian

    fmt, n_dev = {"transpose-well-far": ("well", 1), "transpose-dia-ghosts": ("dia", 4),
                  "transpose-ell-hubs": ("ell", 2)}[case]
    if fmt == "well":
        pt = _long_range_sym()
    elif fmt == "dia":
        pt = pt_gen.create_laplace_2d(40, 40)
    else:
        pt = powerlaw_laplacian(3000, seed=1, dtype=np.float64)
    # row scaling makes each operator non-symmetric
    s = np.random.default_rng(13).uniform(0.5, 1.5, pt.nrows)
    pt = pt_csr.CSRHost(pt.rowptr, pt.colind, pt.values * np.repeat(s, pt.row_nnz()),
                        pt.ncols)
    P = build_dist_matrix(pt, n_devices=n_dev, dtype=np.float32, local_format=fmt,
                          hub_cap=16 if fmt == "ell" else "auto", device="cpu")
    assert (P.well_far_nnz > 0 if fmt == "well" else P.plan.nghost_pad > 0)
    assert fmt != "ell" or P.hub_nnz > 0
    q = np.random.default_rng(14).standard_normal(pt.nrows).astype(np.float32)
    qd = P.to_dist(q, side="row")
    first = P.matvec_transpose(qd)
    for owner, name in ((torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                        (torch.Tensor, "scatter_add_"), (torch.Tensor, "scatter_add"),
                        (torch, "index_add"), (torch, "scatter_add")):
        monkeypatch.setattr(owner, name, refuse)
    y = P.matvec_transpose(qd)
    assert torch.equal(y, first)
    assert _rel(P.from_dist(y, side="col"), pt.transpose().matvec(q.astype(np.float64))) <= 2e-6


def test_matmat_refusals_match_reference():
    ref, pt = _random_sym()
    R = ref_build(ref, n_devices=2, symmetric=True, local_format="well_ds")
    P = build_dist_matrix(pt, n_devices=2, symmetric=True, local_format="well_ds",
                          device="cpu")
    xs = _ds_block(P, _block(700, 2, 1))
    with pytest.raises(ValueError) as port:
        P.matmat_ds(*xs)
    with pytest.raises(ValueError) as want:
        R.matmat_ds(*[R.to_dist_block(p) for p in ds_from_f64(_block(700, 2, 1))])
    assert str(port.value) == str(want.value)
    with pytest.raises(ValueError, match="matmat_ds"):
        P.matmat(xs[0])
    Q = build_dist_matrix(pt, n_devices=2, local_format="well", device="cpu")
    with pytest.raises(ValueError, match="matmat_ds requires"):
        Q.matmat_ds(*xs)
