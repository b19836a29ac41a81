"""The window plan of the DIA tile kernel (``csrc/dia_window.cuh``), which
``dia_sym_spmv`` and ``dia_spmm`` run on the card.

``spmv_dia_cuda.window_plan`` lays out, once per (offsets, symmetric, nrhs,
dtype), which rows of x and of each diagonal a tile of R rows stages in
shared memory, and writes that as the int32 table the kernel reads. The
kernel cannot run here, so these tests hold the table itself:

- against brute force: every (row, offset) read a tile makes, forward and
  transposed, lands in a staged window at the element that holds that row,
  or in an interval marked for global reads; every copy fits its buffer
  and lies in one 128-row tile row (one bulk copy); the x copies tile the
  staged windows; shared memory stays within 227 KB;
- through a torch model of the kernel that follows the table word for word
  (staging by its copy lists, a copy outside the shard written as zeros,
  the next stage's copies landing in the other buffer before the current
  one is summed, unstaged shared memory NaN so a stray read shows), bit
  for bit against the plain versions and, per column, against the
  single-RHS plain apply;
- and that the plan is cached, one object per key;
- ``route``, which picks the kernel each DIA apply launches, and the C
  entry ``entry`` names for it: cached per key, the loop kernel wherever
  K has no ``dia_spmv_rows`` instance, argument counts that match the
  bound entry points.

The plans at nrhs > 1 in symmetric storage are held too: the tile kernel
runs symmetric storage one column at a time (dia_sym_spmv), but the plan
lays out the transposed reads of every column, and the model takes each
column's transpose term through them.

The offset sets are the port's: the 3200^2 and 512^2 Laplacians, phase 3's
+-301 band, the K = 65 and K = 297 bands of AMG's 1-D interval levels, one
interval level of ``spmv_torch.solvers.amg``, each also in symmetric
storage (its offsets <= 0).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from spmv_torch.gen import create_laplace_2d
from spmv_torch.ops import spmv_dia_cuda
from spmv_torch.ops.spmm_dia import columns, spmm_dia_stacked_plain
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain
from spmv_torch.ops.spmv_dia_cuda import (
    COPY_BYTES,
    DIAG_WORDS,
    SMEM_MAX,
    SMEM_TARGET,
    STAGE_WORDS,
    WIN_WORDS,
    XCOPY_WORDS,
    window_plan,
)

LAP = {n: (-n, -1, 0, 1, n) for n in (3200, 512)}
OFFSET_SETS = {
    "laplace 3200^2": LAP[3200],
    "laplace 512^2": LAP[512],
    "band +-301": (-301, -37, -5, -1, 0, 1, 5, 37, 301),
    "band K=65": tuple(range(-32, 33)),
    "band K=297": tuple(range(-148, 149)),
    "amg interval level": None,  # from the fixture below
    # 29 windows of 128 rows, 8 fp64 columns: more than 227 KB, so the
    # plan reads the largest from global memory
    "spread past shared memory": tuple(range(-2800, 2801, 200)),
}
DTYPES = (torch.float32, torch.float64, torch.bfloat16)


@pytest.fixture(scope="module")
def amg_offsets():
    """Level 1 of the interval aggregation on a 49 x 47 Laplacian (23
    diagonals in -74..74, with gaps), as tests/test_torch_amg.py builds it."""
    from spmv_torch.parallel.dist_matrix import build_dist_matrix
    from spmv_torch.solvers.amg import amg_setup

    a = create_laplace_2d(49, 47)
    A = build_dist_matrix(a, n_devices=1, local_format="dia", device=torch.device("cpu"))
    with pytest.warns(UserWarning, match="unsmoothed"):
        h = amg_setup(a, A, aggregate="interval", local_format="dia", coarse_max=300)
    return tuple(h.levels[1].A.dia_offsets)


def offsets_of(name, amg_offsets, symmetric):
    offs = OFFSET_SETS[name] if OFFSET_SETS[name] is not None else amg_offsets
    return tuple(o for o in offs if o <= 0) if symmetric else offs


class Table:
    """The plan's int32 words, decoded as csrc/dia_window.cuh reads them."""

    def __init__(self, plan):
        t = np.asarray(plan.table, dtype=np.int64)
        (self.rows, self.K, nwin, nstages, self.x_elems, self.buf_elems, wb, sb, cb,
         db, self.cols, self.symmetric, xb, nx) = (int(v) for v in t[:14])
        self.wins = t[wb: wb + WIN_WORDS * nwin].reshape(nwin, WIN_WORDS)
        self.stages = t[sb: sb + STAGE_WORDS * nstages].reshape(nstages, STAGE_WORDS)
        self.copies = t[cb: db].reshape(-1, 4)
        self.diags = t[db: db + DIAG_WORDS * self.K].reshape(self.K, DIAG_WORDS)
        self.xcopies = t[xb: xb + XCOPY_WORDS * nx].reshape(nx, XCOPY_WORDS)
        self.nbuf = 2 if nstages > 1 else 1

    def stage_of(self, k):
        return next(g for g, (k0, k1, _, _) in enumerate(self.stages) if k0 <= k < k1)

    def x_row(self, idx, c):
        """The x row (relative to the tile) and column held at shared
        element ``idx`` (an array), or None where no window holds it."""
        for lo, length, at, _ in self.wins:
            if at < 0:
                continue
            base = at + c * length
            if np.all((idx >= base) & (idx < base + length)):
                return lo + idx - base
        return None

    def data_row(self, idx, k):
        """The rows of diagonal k held at buffer elements ``idx`` of its
        stage (-1 where no copy of diagonal k lands)."""
        _, _, first, end = self.stages[self.stage_of(k)]
        row = np.full(self.buf_elems, -1)
        for ck, lo, length, pos in self.copies[first:end]:
            if ck == k:
                row[pos: pos + length] = np.arange(lo, lo + length)
        assert idx.min() >= 0 and idx.max() < self.buf_elems
        return row[idx]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("symmetric,nrhs", [(False, 1), (False, 3), (False, 8),
                                            (False, 11), (True, 1), (True, 3), (True, 8),
                                            (True, 11)])
@pytest.mark.parametrize("name", list(OFFSET_SETS))
def test_plan_covers_every_read(name, symmetric, nrhs, dtype, amg_offsets):
    """Brute force over one tile: each row's read of each diagonal, forward
    and transposed, of x (every staged column) and of the diagonal's data,
    is the right element of a staged window, or its interval is read from
    global memory. Copies fit their buffers; the windows tile the x region
    without overlap; shared memory within 227 KB (and within the 48 KB
    target whenever R > 128)."""
    offsets = offsets_of(name, amg_offsets, symmetric)
    plan = window_plan(offsets, symmetric, nrhs, dtype)
    t = Table(plan)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    chunk = COPY_BYTES // itemsize
    assert t.rows == plan.rows and t.rows % 128 == 0 and t.K == len(offsets)
    assert t.cols == min(nrhs, 8) and t.symmetric == int(symmetric)
    # several stages alternate two buffers
    assert plan.smem_bytes == (t.x_elems + t.nbuf * t.buf_elems) * itemsize
    assert plan.smem_bytes <= SMEM_MAX
    if plan.rows > 128:
        assert plan.smem_bytes <= SMEM_TARGET
    # windows: 16-byte aligned, disjoint, inside the x region
    spans = sorted((at, at + length * t.cols) for lo, length, at, _ in t.wins if at >= 0)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    for lo, length, at, _ in t.wins:
        if at >= 0:
            assert lo % chunk == 0 and length % chunk == 0 and at % chunk == 0
            assert at + length * t.cols <= t.x_elems
    for k, lo, length, pos in t.copies:
        assert lo % chunk == 0 and length % chunk == 0 and pos % chunk == 0
        assert pos + length <= t.buf_elems
        assert lo // 128 == (lo + length - 1) // 128  # one bulk copy: one tile row
    # the x copies tile each staged window, one tile row at most each
    got = sorted((int(a), int(n), int(at), int(st)) for a, n, at, st in t.xcopies)
    want = []
    for lo, length, at, _ in t.wins:
        if at >= 0:
            a = lo
            while a < lo + length:
                n = min(lo + length, (a // 128 + 1) * 128) - a
                want.append((a, n, at + a - lo, length))
                a += n
    assert got == sorted(want)
    assert [int(v) for v in t.stages[:, 0]] == [k0 for k0, _ in plan.stages]
    assert int(t.stages[-1, 1]) == t.K

    def is_global(rows):
        return any(plan.intervals[w][0] <= rows.min() and rows.max() < plan.intervals[w][1]
                   for w in plan.global_intervals)

    r = np.arange(t.rows)
    for k, o in enumerate(offsets):
        _, xf, xfl, xt, xtl, df, dt, _ = (int(v) for v in t.diags[k])
        assert int(t.diags[k, 0]) == o
        assert np.array_equal(t.data_row(df + r, k), r)
        reads = [(xf, xfl, o)]
        if symmetric and o < 0:
            assert np.array_equal(t.data_row(dt + r, k), r - o)
            reads.append((xt, xtl, -o))
        for base, stride, shift in reads:
            if base < 0:
                assert is_global(r + shift)
                continue
            assert not is_global(r + shift)
            for c in range(t.cols):
                got = t.x_row(base + c * stride + r, c)
                assert got is not None and np.array_equal(got, r + shift)


@pytest.mark.parametrize("nrhs", [1, 8, 11])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
def test_plan_is_cached(dtype, symmetric, nrhs):
    key = (LAP[3200][:3] if symmetric else LAP[3200], symmetric, nrhs, dtype)
    assert window_plan(*key) is window_plan(*key)
    plan, table = spmv_dia_cuda.device_window_plan(*key, torch.device("cpu"))
    assert plan is window_plan(*key)
    assert table is spmv_dia_cuda.device_window_plan(*key, torch.device("cpu"))[1]
    assert table.dtype == torch.int32 and table.tolist() == list(plan.table)
    assert window_plan(*key[:2], nrhs + 1, dtype) is not plan


AMG_LEVEL_1 = (-801, -800, -799, -1, 0, 1, 799, 800, 801)  # 800^2 under the 3200^2
ROUTE_KEYS = [
    # (offsets, symmetric, block, dtype) -> (kernel, rows a thread)
    ((LAP[3200], False, False, torch.float32), ("rows", 4)),
    ((LAP[3200], False, False, torch.float64), ("rows", 1)),
    ((LAP[3200], False, False, torch.bfloat16), ("rows", 8)),
    ((LAP[512], False, False, torch.bfloat16), ("rows", 8)),
    ((AMG_LEVEL_1, False, False, torch.float32), ("rows", 1)),
    ((AMG_LEVEL_1, False, False, torch.bfloat16), ("rows", 1)),
    ((OFFSET_SETS["band +-301"], False, False, torch.float32), ("rows", 1)),
    ((OFFSET_SETS["band K=65"], False, False, torch.float32), ("loop", 1)),
    ((OFFSET_SETS["band K=297"], False, False, torch.bfloat16), ("loop", 1)),
    ((LAP[3200][:3], True, False, torch.float32), ("tile", 1)),
    ((LAP[3200], False, True, torch.float32), ("tile", 1)),
    ((LAP[3200][:3], True, True, torch.float32), ("loop", 1)),
    ((LAP[512][:3], True, True, torch.float64), ("loop", 1)),
]


@pytest.mark.parametrize("key,want", ROUTE_KEYS,
                         ids=lambda v: str(v).replace("torch.", "")[:60])
def test_route_is_cached_and_names_its_kernel(key, want):
    """``route`` gives one Route object per key, the same for an equal key
    built anew; dia_spmv runs dia_spmv_rows at K = 5 and 9 (16 bytes of
    fp32 or bf16 rows a thread where at most two offsets are not multiples
    of that count), its loop kernel at every other K; dia_sym_spmv and
    dia_spmm the tile kernel; dia_sym_spmm its direct kernel. The C entry
    ``entry`` names for it exists, with as many arguments as it is bound
    with (beside data, x, y, npad, K, shards and stream)."""
    from spmv_torch._build import KERNEL_ENTRIES

    r = spmv_dia_cuda.route(*key)
    assert (r.kernel, r.rows_per_thread) == want
    assert spmv_dia_cuda.route(*key) is r
    assert spmv_dia_cuda.route(tuple(list(key[0])), *key[1:]) is r
    offsets, symmetric, block, dtype = key
    nrhs = 8 if block else 1
    name, args, _ = spmv_dia_cuda.entry(r, offsets, symmetric, block, nrhs, dtype,
                                        torch.device("cpu"))
    assert name.rsplit("_", 1)[1] == spmv_dia_cuda.DTYPES[dtype]
    assert len(KERNEL_ENTRIES[name]) == len(args) + 7
    if r.kernel == "loop" and not symmetric:
        assert name.startswith("dia_spmv_") and not name.startswith("dia_spmv_rows")
    assert spmv_dia_cuda.entry(r, offsets, symmetric, block, nrhs, dtype,
                               torch.device("cpu"))[0] is name


def test_entry_refuses_a_route_no_kernel_runs():
    """A route no kernel takes (dia_spmv_rows on symmetric storage, the tile
    kernel for a symmetric block) raises instead of launching another
    kernel."""
    for r, symmetric, block in ((spmv_dia_cuda.Route("rows", 1), True, False),
                                (spmv_dia_cuda.Route("tile"), True, True),
                                (spmv_dia_cuda.Route("loop"), True, False)):
        with pytest.raises(ValueError, match="no DIA kernel runs route"):
            spmv_dia_cuda.entry(r, LAP[512][:3], symmetric, block, 3, torch.float32,
                                torch.device("cpu"))


@pytest.mark.parametrize("k", range(1, 13))
def test_rows_route_only_for_built_k(k):
    """dia_spmv_rows is built for K in ROWS_K only: any other K goes to PR
    1's kernel, which reads the offsets from the card."""
    r = spmv_dia_cuda.route(tuple(range(k)), False, False, torch.float32)
    assert r.kernel == ("rows" if k in spmv_dia_cuda.ROWS_K else "loop")


def test_plan_refuses_positive_symmetric_offsets():
    with pytest.raises(ValueError, match="offsets <= 0"):
        window_plan((-1, 0, 1), True, 1, torch.float32)


def model(plan, data, x2, symmetric):
    """The tile kernel on the CPU, driven by the plan's table as the CUDA
    code reads it: each tile of R rows staged by its copy lists (a copy
    outside [0, npad) written as zeros), the next stage's copies made into
    the other buffer before the current stage is summed, the rows that lie
    inside the shard stored. Accumulates in float64 for float64 and in
    float32 otherwise (bf16 rounded once, at the end), one multiply and one
    add a term, as the plain versions do."""
    t = Table(plan)
    nd, nr = data.shape[0], data.shape[1]
    npad = nr * 128
    nrhs = x2.shape[1] // 128
    acc_t = torch.float64 if data.dtype == torch.float64 else torch.float32
    R = t.rows
    y = torch.full((nd, nr, nrhs, 128), float("nan"), dtype=acc_t)
    x4 = x2.view(nd, nr, nrhs, 128).to(acc_t)
    d4 = data.view(nd, nr, t.K, 128).to(acc_t)
    size = t.x_elems + t.nbuf * t.buf_elems

    def rows_of(flat_rows, j):
        """Values at rows j of a (npad,) vector, zero outside [0, npad)."""
        out = torch.zeros(len(j), dtype=acc_t)
        ok = (j >= 0) & (j < npad)
        out[ok] = flat_rows[j[ok]]
        return out

    def at(idx):
        assert idx.min() >= 0 and idx.max() < size, "read outside shared memory"
        return idx

    r = torch.arange(R)
    for s in range(nd):
        xcol = [x4[s, :, c, :].reshape(-1) for c in range(nrhs)]
        dcol = [d4[s, :, k, :].reshape(-1) for k in range(t.K)]
        for c0 in range(0, nrhs, t.cols):
            nc = min(t.cols, nrhs - c0)
            for i0 in range(0, npad, R):
                smem = torch.full((size,), float("nan"), dtype=acc_t)
                for a, n, pos, stride in t.xcopies:
                    j = torch.arange(i0 + a, i0 + a + n)
                    for c in range(nc):
                        smem[pos + c * stride: pos + c * stride + n] = rows_of(
                            xcol[c0 + c], j)

                def issue(g):
                    base = t.x_elems + (g % 2) * t.buf_elems
                    _, _, first, end = t.stages[g]
                    for k, a, n, pos in t.copies[first:end]:
                        j = torch.arange(i0 + a, i0 + a + n)
                        smem[base + pos: base + pos + n] = rows_of(dcol[k], j)

                acc = torch.zeros((R, nc), dtype=acc_t)
                issue(0)
                for g, (k0, k1, _, _) in enumerate(t.stages):
                    if g + 1 < len(t.stages):
                        issue(g + 1)
                    base = t.x_elems + (g % 2) * t.buf_elems
                    for k in range(k0, k1):
                        o, xf, xfl, xt, xtl, df, dt, _ = (int(v) for v in t.diags[k])
                        d = smem[at(base + df + r)]
                        for c in range(nc):
                            xv = (smem[at(xf + c * xfl + r)] if xf >= 0
                                  else rows_of(xcol[c0 + c], i0 + r + o))
                            acc[:, c] = acc[:, c] + d * xv
                        if symmetric and o < 0:
                            dv = smem[at(base + dt + r)]
                            for c in range(nc):
                                xv = (smem[at(xt + c * xtl + r)] if xt >= 0
                                      else rows_of(xcol[c0 + c], i0 + r - o))
                                acc[:, c] = acc[:, c] + dv * xv
                keep = i0 + r < npad
                rows = (i0 + r)[keep]
                for c in range(nc):
                    y[s, rows // 128, c0 + c, rows % 128] = acc[keep, c]
    return y.view(nd * nr, nrhs * 128).to(x2.dtype)


MODEL_CASES = [
    (name, symmetric, nrhs, dtype)
    for name in ("laplace 3200^2", "band +-301", "band K=65", "amg interval level")
    for symmetric, nrhs in ((False, 1), (False, 3), (False, 11), (True, 1), (True, 3),
                            (True, 8), (True, 11))
    for dtype in DTYPES
] + [("spread past shared memory", False, 8, torch.float64),
     ("spread past shared memory", True, 1, torch.float64)]


def model_inputs(offsets, nrhs, dtype, rows, seed):
    """Random data and x on D = 2 shards of a whole number of 128-row tile
    rows, at least ``rows`` of them and no multiple of 512 (a partial last
    tile)."""
    rng = np.random.default_rng(seed)
    nr = max(-(-rows // 128), 5)
    nr += 1 if nr % 4 == 0 else 0
    data = torch.as_tensor(rng.standard_normal((2, nr, len(offsets) * 128))).to(dtype)
    x2 = torch.as_tensor(rng.standard_normal((2 * nr, nrhs * 128))).to(dtype)
    return data, x2


def check_model(plan, data, x2, offsets, symmetric):
    got = model(plan, data, x2, symmetric)
    want = spmm_dia_stacked_plain(data, x2, offsets, symmetric)
    assert torch.equal(got, want)
    for c, (gc, xc) in enumerate(zip(columns(got), columns(x2))):
        assert torch.equal(gc, spmv_dia_stacked_plain(data, xc, offsets, symmetric)), c


@pytest.mark.parametrize("name,symmetric,nrhs,dtype", MODEL_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_model_of_kernel_equals_plain(name, symmetric, nrhs, dtype, amg_offsets):
    """The plan's table, run as the kernel runs it, gives the plain
    version's output bit for bit on D = 2 stacked shards with a partial
    last tile, and each column equals the single-RHS plain apply on it."""
    offsets = offsets_of(name, amg_offsets, symmetric)
    span = max(abs(o) for o in offsets)
    data, x2 = model_inputs(offsets, nrhs, dtype, span + 3 * 128, len(offsets) + nrhs)
    plan = window_plan(offsets, symmetric, nrhs, dtype)
    if name == "spread past shared memory" and not symmetric:
        assert plan.global_intervals, "the spread case must read some x from global"
    check_model(plan, data, x2, offsets, symmetric)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("rows", spmv_dia_cuda.TILE_ROWS)
@pytest.mark.parametrize("symmetric,nrhs", [(True, 1), (False, 3)])
def test_model_at_every_tile_size(symmetric, nrhs, rows, dtype):
    """Every R the kernel is built for, imposed on the Laplacian's offsets
    (the wider ones a partial tile on a short shard): bit for bit against
    the plain versions."""
    offsets = LAP[512][:3] if symmetric else LAP[512]
    data, x2 = model_inputs(offsets, nrhs, dtype, 512 + 3 * 128, rows + nrhs)
    plan = spmv_dia_cuda._plan_at(offsets, symmetric, nrhs, data.element_size(), rows,
                                  SMEM_MAX)
    assert plan is not None and plan.rows == rows
    check_model(plan, data, x2, offsets, symmetric)
