"""The symmetric dual-WELL apply in one op: ``spmv_well_sym_stacked``
(``ops/spmv_well_cuda.py``, the kernel ``well_sym_spmv`` of
``csrc/spmv_well.cu``) and the route of ``DistMatrix.matvec`` that sends
every symmetric "well" operator to it.

On the CPU the op takes its plain version, which is the apply's three steps
(L's row lists, plus L^T's, plus diagonal * x): it must give those steps'
answer bit for bit, whatever the stacks' widths, windows, position widths
and shards, and match a dense float64 apply. A symmetric "well" matvec
makes one call of the op and none of ``spmv_well_stacked``, and operators
with a far remainder or a halo still match the host CSR.

On the card (the ``cuda`` marker; this file imports no jax, so run it there
with ``python -m pytest tests/test_torch_well_sym.py -m cuda --noconftest``):
the kernel gives the two-launch route's bits (``well_spmv`` on each stack,
then the two torch adds and the multiply), is within tolerance of the plain
version, and one apply is one launch under "well_sym".
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import spmv_torch.parallel.dist_matrix as dm
from spmv_torch import _build
from spmv_torch import corpus
from spmv_torch.formats.csr import CSRHost
from spmv_torch.ops.spmv_well import spmv_well_rows_plain, spmv_well_sym_rows_plain
from spmv_torch.ops.spmv_well_cuda import spmv_well_stacked, spmv_well_sym_stacked
from spmv_torch.reorder import rcm_reorder

TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
WIDTHS = {"i16": torch.int16, "i32": torch.int32}


def _stack(rng, nd, ns, tile_groups, pos_dtype, dtype, max_width, device="cpu"):
    """Random row lists of D = nd shards of ns slices: slice widths 0 to
    ``max_width`` (empty rows, and rows wider than the slots a thread loads
    ahead), window starts of 0 or 1 segment and positions up to the shard's
    width, so that some gathers fall past the shard's x (col_pad) and read
    0, as padding slots near a shard's end may. Returns (values, pos,
    slice_ptr, w0, tile_groups)."""
    width = rng.integers(0, max_width + 1, (nd, ns))
    ptr = np.zeros((nd, ns + 1), dtype=np.int64)
    ptr[:, 1:] = np.cumsum(width * 32, axis=1)
    e = max(int(ptr[:, -1].max()), 1)
    w0 = rng.integers(0, 2, (nd, ns // 4 // tile_groups))
    pos = rng.integers(0, ns * 32, (nd, e))
    return (torch.as_tensor(rng.standard_normal((nd, e)), dtype=dtype, device=device),
            torch.as_tensor(pos, dtype=pos_dtype, device=device),
            torch.as_tensor(ptr, device=device),
            torch.as_tensor(w0, dtype=torch.int32, device=device), tile_groups)


def _operands(seed, nd, ns, dtype, pos_l, pos_u, device="cpu"):
    """Two stacks over the same shards and slices with their own widths,
    windows, position widths and tile_groups, a diagonal and x."""
    rng = np.random.default_rng(seed)
    lower = _stack(rng, nd, ns, 1, pos_l, dtype, 3, device)
    upper = _stack(rng, nd, ns, ns // 4, pos_u, dtype, 9, device)
    d = torch.as_tensor(rng.standard_normal((nd, ns * 32)), dtype=dtype, device=device)
    x2 = torch.as_tensor(rng.standard_normal((nd * ns // 4, 128)), dtype=dtype,
                         device=device)
    return lower, upper, d, x2


def _dense(stack, x2, nd):
    """y of one stack's row lists, summed in float64 on the host; a gather
    past the shard's x reads 0."""
    values, pos, ptr, w0, tg = (t.cpu().numpy() if torch.is_tensor(t) else t
                                for t in stack)
    xs = x2.cpu().double().numpy().reshape(nd, -1)
    ns = ptr.shape[1] - 1
    y = np.zeros((nd, ns * 32))
    for s in range(nd):
        for sl in range(ns):
            base = int(w0[s, sl // 4 // tg]) * 128
            for e in range(int(ptr[s, sl]), int(ptr[s, sl + 1])):
                r = sl * 32 + (e - int(ptr[s, sl])) % 32
                j = base + int(pos[s, e])
                if j < xs.shape[1]:
                    y[s, r] += float(values[s, e]) * xs[s, j]
    return y


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("pos_l,pos_u", [("i16", "i16"), ("i32", "i32"), ("i16", "i32"),
                                         ("i32", "i16")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_plain_version_is_the_three_steps_bit_for_bit(dtype, pos_l, pos_u, nd):
    lower, upper, d, x2 = _operands(nd, nd, 12, dtype, WIDTHS[pos_l], WIDTHS[pos_u])
    _build.launches.clear()
    y = spmv_well_sym_stacked(lower, upper, d, x2)
    assert y.dtype == dtype and y.shape == x2.shape
    assert torch.equal(y, spmv_well_sym_rows_plain(lower, upper, d, x2,
                                                   apply=spmv_well_rows_plain))
    assert not _build.launches
    want = (_dense(lower, x2, nd) + _dense(upper, x2, nd)
            + d.double().numpy() * x2.double().numpy().reshape(nd, -1))
    assert _rel(y.reshape(nd, -1).numpy(), want) <= TOL[dtype]


def test_wrapper_refuses_mismatched_operands():
    lower, upper, d, x2 = _operands(3, 2, 12, torch.float64, torch.int16, torch.int32)
    with pytest.raises(TypeError, match="one dtype"):
        spmv_well_sym_stacked(lower, upper, d.float(), x2)
    other = _stack(np.random.default_rng(4), 2, 16, 1, torch.int16, torch.float64, 2)
    with pytest.raises(ValueError):
        spmv_well_sym_stacked(lower, other, d, x2)
    with pytest.raises(ValueError, match="diagonal"):
        spmv_well_sym_stacked(lower, upper, d[:, :-1], x2)
    with pytest.raises(ValueError, match="one entry a row"):
        spmv_well_sym_stacked(lower, upper, d, torch.cat([x2, x2]))


def _fem(n=3000, seed=1):
    a, _ = rcm_reorder(corpus.fem_p1_2d(n, seed=seed, dtype=np.float64), keep_best=True)
    return a


def _long_range(n=80_000, pairs=300, seed=3):
    """A tridiagonal operator plus entries joining the first and the last
    rows, further apart than the 512-segment window: a far remainder."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pi, pj = rng.integers(0, 5000, pairs), rng.integers(n - 5000, n, pairs)
    rows = np.concatenate([i, i[1:], i[:-1], pi, pj])
    cols = np.concatenate([i, i[:-1], i[1:], pj, pi])
    vals = np.concatenate([np.full(n, 4.0), np.full(2 * (n - 1), -1.0),
                           np.full(2 * pairs, -0.5)])
    return CSRHost.from_coo(rows, cols, vals, n, n)


OPERATORS = {
    "fem D=1": (_fem, 1),
    "fem D=2": (_fem, 2),
    "fem D=4": (_fem, 4),
    "far remainder D=1": (_long_range, 1),
    "circuit halo D=4": (lambda: corpus.circuit_network(70, extra_frac=0.05, seed=2,
                                                        dtype=np.float64), 4),
}


def _counted(monkeypatch):
    calls = {"well_sym": 0, "well": 0}

    def spy(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(dm, "spmv_well_sym_stacked", spy("well_sym", dm.spmv_well_sym_stacked))
    monkeypatch.setattr(dm, "spmv_well_stacked", spy("well", dm.spmv_well_stacked))
    return calls


@pytest.mark.parametrize("case", list(OPERATORS))
def test_symmetric_well_matvec_is_one_fused_call(case, monkeypatch):
    """A symmetric "well" matvec calls the fused op once and
    ``spmv_well_stacked`` never; with a far remainder or a halo the far,
    remote and reverse-exchange terms are added to its y, and every case
    matches the host CSR within test_torch_dist_well's tolerances (1e-13 of
    the largest |y|, 10x that against the host)."""
    make, nd = OPERATORS[case]
    a = make()
    A = dm.build_dist_matrix(a, n_devices=nd, symmetric=True, local_format="well",
                             dtype=np.float64, device="cpu")
    assert A.local_format == "well"
    if case.startswith("far"):
        assert A.well_far_nnz + A.well_farT_nnz > 0
    if case.startswith("circuit"):
        assert A.plan.nghost_pad > 0
    calls = _counted(monkeypatch)
    x = np.random.default_rng(7).standard_normal(a.nrows)
    got = A.from_dist(A.matvec(A.to_dist(x)))
    assert calls == {"well_sym": 1, "well": 0}
    want = a.matvec(x)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 10 * TOL[torch.float64]


def test_vanilla_well_matvec_keeps_well_spmv(monkeypatch):
    a = _fem()
    A = dm.build_dist_matrix(a, n_devices=2, symmetric=False, local_format="well",
                             dtype=np.float64, device="cpu")
    calls = _counted(monkeypatch)
    A.matvec(A.to_dist(np.ones(a.nrows)))
    assert calls == {"well_sym": 0, "well": 1}


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "tests/test_torch_well_sym.py -m cuda --noconftest)")
    return torch.device("cuda")


def _poisson(cx=96, cy=48):
    from bench_h100.matrices import poisson2d_p1

    g = poisson2d_p1.generate({"cx": cx, "cy": cy})
    return CSRHost(g.rowptr, g.colind, g.values, g.ncols)


def _check_kernel(lower, upper, d, x2):
    """The kernel against the two-launch route on the card, bit for bit,
    twice; against the plain version within TOL."""
    _build.launches.clear()
    y = spmv_well_sym_stacked(lower, upper, d, x2)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"well_sym": 1}
    assert torch.equal(y, spmv_well_sym_rows_plain(lower, upper, d, x2,
                                                   apply=spmv_well_stacked))
    assert torch.equal(spmv_well_sym_stacked(lower, upper, d, x2), y)
    cpu = [tuple(t.cpu() if torch.is_tensor(t) else t for t in s) for s in (lower, upper)]
    plain = spmv_well_sym_stacked(*cpu, d.cpu(), x2.cpu())
    assert _rel(y.cpu().numpy(), plain.numpy()) <= TOL[y.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("nd,ns", [(1, 12), (3, 404)])
@pytest.mark.parametrize("pos_l,pos_u", [("i16", "i16"), ("i32", "i32"), ("i16", "i32"),
                                         ("i32", "i16")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_kernel_is_the_two_launch_route_bit_for_bit_on_cuda(cuda, dtype, pos_l, pos_u,
                                                           nd, ns):
    """Random stacks of other widths (0 to 3 and 0 to 9 slots: empty rows,
    rows wider than the slots loaded ahead), windows, tile_groups (1 and
    S/4) and position widths; 384 and 12928 rows a shard, neither a
    multiple of 256; some gathers past the shard's x, which read 0."""
    _check_kernel(*_operands(ns + nd, nd, ns, dtype, WIDTHS[pos_l], WIDTHS[pos_u], cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["poisson2d_p1 96x48", "far remainder D=1", "fem D=2"])
def test_kernel_on_operators_row_lists_on_cuda(cuda, case):
    """The kernel on the stacks of real operators: DOLFINx's P1 mesh in its
    level order, one with a far remainder, and an RCM'd FEM on 2 shards."""
    if case.startswith("poisson"):
        a, nd = _poisson(), 1
    else:
        make, nd = OPERATORS[case]
        a = make()
    A = dm.build_dist_matrix(a, n_devices=nd, symmetric=True, local_format="well",
                             dtype=np.float64, device=cuda)
    x2 = A.to_dist(np.random.default_rng(9).standard_normal(a.nrows))
    _check_kernel(dm._well_rows(A, ""), dm._well_rows(A, "T"), A.diagonal, x2)


@pytest.mark.cuda
def test_one_apply_is_one_well_sym_launch_on_cuda(cuda):
    """On the cell's kind of operator (one shard, no far part, no halo) one
    matvec is one launch under "well_sym" and none under "well", and gives
    the two-launch route's y bit for bit."""
    a = _poisson()
    A = dm.build_dist_matrix(a, n_devices=1, symmetric=True, local_format="well",
                             dtype=np.float64, device=cuda)
    assert A.well_far_nnz == A.well_farT_nnz == 0 and A.plan.nghost_pad == 0
    x2 = A.to_dist(np.random.default_rng(10).standard_normal(a.nrows))
    _build.launches.clear()
    y = A.matvec(x2)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"well_sym": 1}
    assert _build.launches["well"] == 0
    want = spmv_well_sym_rows_plain(dm._well_rows(A, ""), dm._well_rows(A, "T"),
                                    A.diagonal, x2, apply=spmv_well_stacked)
    assert torch.equal(y, want)
