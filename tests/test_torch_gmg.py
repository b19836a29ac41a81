"""HPCG's multigrid in the port (``solvers/gmg.py``, ``ops/symgs_dia.py``,
``gen.hpcg_27pt``) against the plain reference of HPCG's code
(``tests/hpcg_reference.py``), on seeded uniform loads at 16³ (4 levels,
down to 2³).

On the card (the ``cuda`` marker; this file imports no jax, so run it there
with ``python -m pytest tests/test_torch_gmg.py -m cuda --noconftest``):
the kernels of ``csrc/symgs_dia.cu`` against their plain versions, and the
preconditioned solve against the CPU's.
"""
from __future__ import annotations

import collections
import os
import sys
import types

import numpy as np
import pytest
import torch

from spmv_torch import _build
from spmv_torch.gen import hpcg_27pt
from spmv_torch.ops import symgs_dia, symgs_dia_cuda
from spmv_torch.parallel.dist_matrix import build_dist_matrix
from spmv_torch.solvers import cg as cg_module
from spmv_torch.solvers import gmg
from spmv_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import hpcg_reference as ref  # noqa: E402

GRID = (16, 16, 16)
LEVELS = 4
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
# port against reference, relative 2-norm. Both compute the same sweeps;
# they differ in rounding alone: the port sums a row over its stored
# diagonals (lower, then upper terms), the reference over its CSR columns,
# and the port takes the rows after each row from the kept w
# (ops/symgs_dia.py), which rounds otherwise than the reference's update
# from x. A cycle and a set of 50 read at most 2.8e-16 in float64 at 16³
# and 1.8e-7 in float32 at 32³; each tolerance is some 350x and 55x that,
# and float32 arithmetic fails the float64 one by 5 orders.
TOL = {np.float64: 1e-13, np.float32: 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the plain sweeps are many small torch ops: threads only add
    # contention where test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(x: torch.Tensor, ref_x: torch.Tensor) -> float:
    x = x.reshape(-1)[: ref_x.numel()].double().cpu()
    ref_x = ref_x.double().cpu()
    return float(torch.linalg.vector_norm(x - ref_x) / torch.linalg.vector_norm(ref_x))


def _load(n: int, seed: int = 2**31 + 16) -> np.ndarray:
    return 2.0 * np.random.default_rng(seed).random(n) - 1.0


def _mg(grid=GRID, dt=np.float64, device="cpu"):
    A = build_dist_matrix(hpcg_27pt(*grid), n_devices=1, symmetric=True,
                          dtype=dt, local_format="dia", device=device)
    return A, gmg.hpcg_hierarchy(A, grid, LEVELS)


@pytest.mark.parametrize("grid", [GRID, (5, 4, 3)])
def test_generator_is_hpcgs(grid):
    a = hpcg_27pt(*grid)
    rowptr, colind, values = ref.generate(*grid)
    assert np.array_equal(a.rowptr, rowptr)
    assert np.array_equal(a.colind, colind) and a.colind.dtype == np.int32
    assert np.array_equal(a.values, values)
    # HPCG's exact solution is ones: b = A 1 = 26 - (neighbours in the grid)
    ones = a.to_dense() @ np.ones(a.nrows)
    assert np.array_equal(ones, 26.0 - (np.diff(a.rowptr) - 1))


@pytest.mark.parametrize("grid", [GRID, (5, 4, 3), (2, 2, 2)])
def test_colours_are_independent(grid):
    a = hpcg_27pt(*grid)
    col = symgs_dia.colours(grid, "cpu").numpy()
    assert np.array_equal(col, ref.colours(*grid))
    rows = np.repeat(np.arange(a.nrows), np.diff(a.rowptr))
    off = a.colind != rows
    assert not np.any(col[rows[off]] == col[a.colind[off]])
    assert set(col) == set(range(8))


def _smooth(A, lv, b, x, w, from_zero, sweep=symgs_dia_cuda.symgs_sweep):
    """A SymGS as the cycle runs it: from zero it keeps w, else it starts
    from the w kept."""
    w_in = None if from_zero else w
    sweep(lv.data, A.dia_offsets, lv.grid, b, x, True, w_in)
    sweep(lv.data, A.dia_offsets, lv.grid, b, x, False, w_in,
          w if from_zero else None)


def _prolong(x, grid, seed):
    """x += a seeded vector at the colour-0 (coarse) points, as the
    prolongation changes it."""
    f2c = symgs_dia.coarse_rows(grid, "cpu")
    add = torch.as_tensor(_load(f2c.numel(), seed), dtype=x.dtype)
    x.view(-1)[f2c.to(x.device)] += add.to(x.device)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_symgs_pair_matches_reference(dt):
    # a level's two SymGS: from zero, then after a prolongation
    A, mg = _mg(dt=dt)
    lv = mg.levels[0]
    rl = ref.hierarchy(GRID, 1, dtype=DTYPES[dt])[0]
    b = _load(A.nrows_global)
    bd, br = A.to_dist(b.astype(dt)), torch.as_tensor(b, dtype=DTYPES[dt])
    x, w = torch.zeros_like(bd), torch.zeros_like(bd)
    xr = torch.zeros_like(br)
    for from_zero in (True, False):
        if not from_zero:
            _prolong(x, GRID, 6)
            _prolong(xr, GRID, 6)
        _smooth(A, lv, bd, x, w, from_zero)
        ref.symgs(rl, br, xr)
        assert _err(x, xr) < TOL[dt]


def test_kept_w_is_the_sum_after_each_row():
    # w = sum of a_ij x_j over the rows j after i in the forward order,
    # before and after a prolongation (which changes only colour 0)
    A, mg = _mg()
    lv = mg.levels[0]
    b = A.to_dist(_load(A.nrows_global))
    x, w = torch.zeros_like(b), torch.zeros_like(b)
    _smooth(A, lv, b, x, w, True)
    a = hpcg_27pt(*GRID)
    col = symgs_dia.colours(GRID, "cpu").numpy()
    rows = np.repeat(np.arange(a.nrows), np.diff(a.rowptr))
    after = col[a.colind] > col[rows]
    upper = np.zeros((a.nrows, a.nrows))
    upper[rows[after], a.colind[after]] = a.values[after]
    for _ in range(2):
        want = upper @ x.reshape(-1)[: a.nrows].numpy()
        assert _err(w, torch.as_tensor(want)) < 1e-15
        _prolong(x, GRID, 2)


def test_restriction_is_the_residual_at_the_coarse_points():
    A, mg = _mg()
    b = A.to_dist(_load(A.nrows_global))
    x = A.to_dist(_load(A.nrows_global, 5))
    rc = torch.full((A.row_lane_rows, 128), 7.0, dtype=torch.float64)
    symgs_dia_cuda.restrict_residual(mg.levels[0].data, A.dia_offsets, GRID,
                                     b, x, rc)
    f2c = symgs_dia.coarse_rows(GRID, "cpu")
    want = (b - A.matvec(x)).reshape(-1)[f2c]
    assert _err(rc.reshape(-1)[: f2c.numel()], want) < 1e-15


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cycle_matches_reference(dt):
    A, mg = _mg(dt=dt)
    b = _load(A.nrows_global)
    z = mg.as_preconditioner()(A.to_dist(b.astype(dt)))
    levels = ref.hierarchy(GRID, LEVELS, dtype=DTYPES[dt])
    assert _err(z, ref.mg(levels, torch.as_tensor(b, dtype=DTYPES[dt]))) < TOL[dt]
    if dt == np.float32:
        # a cycle in float32 is not the float64 one
        levels64 = ref.hierarchy(GRID, LEVELS)
        assert _err(z, ref.mg(levels64, torch.as_tensor(b))) > TOL[np.float64]


# float32 at 32³: at 16³ the multigrid takes the recurrence's residual
# below 1e-22 by iteration 35, and r.z (its square) under float32's
# smallest normal, so a 50-iteration set there ends in 0/0
@pytest.mark.parametrize("dt,grid", [(np.float64, GRID),
                                     (np.float32, (32, 32, 32))])
def test_set_of_50_matches_reference(dt, grid):
    A, mg = _mg(grid, dt)
    b = _load(A.nrows_global)
    res = cg_module.cg(A.matvec, A.to_dist(b.astype(dt)), kmax=50, rtol=0.0,
                       preconditioner=mg.as_preconditioner())
    x_ref, reduction = ref.cg(ref.hierarchy(grid, LEVELS, dtype=DTYPES[dt]),
                              torch.as_tensor(b, dtype=DTYPES[dt]), 50)
    assert res.iterations == 50 and reduction < 1e-12
    assert _err(res.x, x_ref) < TOL[dt]


def test_refuses_what_it_does_not_run():
    a = hpcg_27pt(*GRID)
    two = build_dist_matrix(a, n_devices=2, symmetric=True, local_format="dia",
                            device="cpu")
    with pytest.raises(ValueError, match="one shard"):
        gmg.GeometricMG([two], [GRID])
    ell = build_dist_matrix(a, n_devices=1, symmetric=True, local_format="ell",
                            device="cpu")
    with pytest.raises(ValueError, match="symmetric DIA"):
        gmg.GeometricMG([ell], [GRID])
    A, _ = _mg()
    with pytest.raises(ValueError, match="halve"):
        gmg.hpcg_hierarchy(A, GRID, 6)
    with pytest.raises(ValueError, match="halved"):
        gmg.GeometricMG([A, A], [GRID, GRID])


def test_counters_and_spans_of_one_apply():
    A, mg = _mg()
    b = A.to_dist(_load(A.nrows_global))
    before = dict(gmg.sweeps)
    _build.launches.clear()
    symgs_dia_cuda.bands.clear()
    profiling.record.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        mg.apply(b)
    names = [s.name for s in profiling.record]
    profiling.record.clear()
    assert names.count("spmv_torch.mg") == 1
    # 1 pre- and 1 post-SymGS on 3 levels, 1 on the coarsest; 3 restrictions
    # and 3 prolongations
    assert names.count("spmv_torch.mg.smooth") == 2 * (LEVELS - 1) + 1
    assert names.count("spmv_torch.mg.transfer") == 2 * (LEVELS - 1)
    assert {k: gmg.sweeps[k] - before.get(k, 0) for k in range(LEVELS)} == {
        0: 4, 1: 4, 2: 4, 3: 2}
    # the plain path launches nothing
    assert not _build.launches and not symgs_dia_cuda.bands


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_gmg.py -m cuda --noconftest)")
    return torch.device("cuda")


# odd and even colour-row counts, lines of 1-2 points, a grid longer in z,
# lines of 300 points, lines of 2 to 5 segments (more than 512 points),
# planes the band rule cuts (16 bands of 4 lines), one plane (one launch a
# sweep direction)
CARD_GRIDS = [(16, 16, 16), (6, 6, 6), (5, 4, 3), (2, 2, 2), (7, 3, 9),
              (32, 8, 4), (300, 5, 4), (521, 3, 2), (64, 64, 8), (12, 10, 1),
              (1100, 3, 2), (2100, 2, 3)]


@pytest.mark.parametrize("grid", CARD_GRIDS)
def test_plane_parity_orders_the_sweep(grid):
    # what the kernel's schedule rests on, from the terms a sweep reads
    # through nonzero stored values: a plane of the parity that goes first
    # (even forward, odd backward) reads only itself, the other parity its
    # own plane and the planes beside it; inside a plane a line of the
    # first parity reads no other line, each other line only the first
    # lines beside it; inside a line the first points (ix of the first
    # parity) read none of it, the others only their two neighbours
    nx, ny, nz = grid
    n = nx * ny * nz
    A = build_dist_matrix(hpcg_27pt(*grid), n_devices=1, symmetric=True,
                          local_format="dia", device="cpu")
    flat = A.local_dia_data[0].reshape(-1)
    rows = torch.arange(n)
    vals, xs, oks, _ = symgs_dia._terms(rows, A.dia_offsets, n)
    col = symgs_dia.colours(grid, "cpu")
    nonzero = oks & (flat[vals] != 0)
    for forward, first in ((True, 0), (False, 1)):
        before = col[xs] < col[rows] if forward else col[xs] > col[rows]
        read = nonzero & before
        p, q = rows.expand_as(xs)[read], xs[read]
        assert p.numel() > 0 or n == 1
        (px, py, pz), (qx, qy, qz) = [(v % nx, v // nx % ny, v // (nx * ny))
                                      for v in (p, q)]
        plane, line = qz == pz, (qz == pz) & (qy == py)
        assert torch.all(torch.where(pz % 2 == first, plane, (qz - pz).abs() <= 1))
        assert torch.all(~plane | torch.where(
            py % 2 == first, qy == py,
            (qy == py) | (((qy - py).abs() == 1) & (qy % 2 == first))))
        assert torch.all(~line | ((px % 2 != first) & ((qx - px).abs() == 1)))
        if nx >= 3 and ny >= 3:
            # the first launch's couplings, inside its planes, lie on the
            # last 5 stored diagonals, the kernel's window for that launch
            k = len(A.dia_offsets)
            d = vals[read] // symgs_dia.LANES % k
            assert torch.all((pz % 2 != first) | (d >= k - 5))


@pytest.mark.parametrize("grid,forward_bands,lines", [
    ((256, 256, 256), [1, 1], [256, 256]), ((128, 128, 128), [2, 2], [64, 64]),
    ((64, 64, 64), [4, 4], [16, 16]), ((32, 32, 32), [8, 8], [4, 4]),
    ((640, 64, 32), [1, 1], [64, 64]), ((1100, 8, 4), [1, 1], [8, 8]),
    ((64, 64, 8), [16, 16], [4, 4]),
    ((16, 13, 4), [2, 2], [8, 8]), ((12, 10, 1), [2], [6]),
    ((7, 3, 9), [1, 1], [3, 3])])
def test_launches_and_bands_follow_the_grid(grid, forward_bands, lines):
    # 2 launches a sweep direction (1 where nz = 1); a forward sweep of
    # short lines cuts its planes where they leave the SMs idle, in bands
    # of an even number of lines that cover the plane; a backward sweep
    # never; each a function of the grid alone
    nx, ny, nz = grid
    launches = symgs_dia_cuda.sweep_launches(grid)
    assert launches == (1 if nz == 1 else 2) == len(forward_bands)
    assert symgs_dia_cuda.sweep_bands(grid, True) == forward_bands
    assert symgs_dia_cuda.sweep_bands(grid, False) == [1] * launches
    # the lines of each launch, which the kernel takes
    assert symgs_dia_cuda.sweep_lines(grid, True) == lines
    assert symgs_dia_cuda.sweep_lines(grid, False) == [ny] * launches
    for pz, (b, h) in enumerate(zip(forward_bands, lines)):
        planes = (nz - pz + 1) // 2
        assert symgs_dia_cuda.band_lines(grid, planes, True) == h
        assert symgs_dia_cuda.band_lines(grid, planes, False) == ny
        assert (b - 1) * h < ny <= b * h
        if b > 1:
            assert h % 2 == 0 and h >= 4
            assert planes * b <= symgs_dia_cuda.SMS
    assert symgs_dia_cuda.sweep_bands(grid, True) == forward_bands  # again


def test_a_v_cycle_of_hpcg_256_launches_28_sweeps():
    # 7 SymGS (2 on each of the three finer levels, 1 on the coarsest), 2
    # directions each, 2 launches a direction; 1428 in a set of 51 applies
    grids = [(256 >> k,) * 3 for k in range(LEVELS)]
    per_cycle = sum((2 if k + 1 < LEVELS else 1) * 2 *
                    symgs_dia_cuda.sweep_launches(g) for k, g in enumerate(grids))
    assert per_cycle == 28 and 51 * per_cycle == 1428


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("grid", CARD_GRIDS)
def test_kernels_match_plain_on_the_card(cuda, dt, grid, monkeypatch):
    A = build_dist_matrix(hpcg_27pt(*grid), n_devices=1, symmetric=True,
                          dtype=dt, local_format="dia", device=cuda)
    data, offs = A.local_dia_data[0], A.dia_offsets
    n = A.nrows_global
    b = A.to_dist(_load(n).astype(dt))
    # the band lines each sweep passes to the kernel, in bands a plane
    passed = collections.Counter()
    launch = _build.launch

    def spy(entry, device, *args, key, count=1):
        if entry.startswith("symgs_dia_"):
            for lines in args[-2:][:count]:
                passed[grid, -(-grid[1] // lines)] += 1
        launch(entry, device, *args, key=key, count=count)

    monkeypatch.setattr(_build, "launch", spy)
    _build.launches.clear()
    symgs_dia_cuda.bands.clear()
    x, wx = torch.zeros_like(b), torch.zeros_like(b)
    y, wy = torch.zeros_like(b), torch.zeros_like(b)
    lv = types.SimpleNamespace(data=data, grid=grid)
    for from_zero in (True, False):
        if not from_zero and all(v % 2 == 0 for v in grid):
            _prolong(x, grid, 3)
            _prolong(y, grid, 3)
        _smooth(A, lv, b, x, wx, from_zero)
        _smooth(A, lv, b, y, wy, from_zero, symgs_dia.symgs_sweep_plain)
        torch.cuda.synchronize()
        # the kernel adds in the plain version's order with its roundings
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(wx, wy, rtol=0, atol=0)
    # 2 SymGS, 2 sweep directions each, sweep_launches a direction
    assert _build.launches["symgs_planes", grid] == \
        4 * symgs_dia_cuda.sweep_launches(grid)
    cut = [b for forward in (True, False)
           for b in symgs_dia_cuda.sweep_bands(grid, forward)]
    assert dict(symgs_dia_cuda.bands) == dict(passed) == {
        (grid, b): 2 * cut.count(b) for b in set(cut)}
    if all(v % 2 == 0 for v in grid):
        rc = torch.zeros_like(b)
        rc2 = torch.zeros_like(b)
        symgs_dia_cuda.restrict_residual(data, offs, grid, b, x, rc)
        symgs_dia.restrict_residual_plain(data, offs, grid, b, x, rc2)
        torch.testing.assert_close(rc, rc2, rtol=0, atol=0)
        assert _build.launches["restrict", grid] == 1


# bands the sweep kernel cannot run: (grid, forward, lines of each launch)
BAD_BANDS = {
    "odd": ((16, 16, 16), True, (5, 16)),
    "under 4": ((16, 16, 16), True, (16, 2)),
    "backward": ((16, 16, 16), False, (8, 16)),
    "long lines": ((1100, 8, 4), True, (4, 4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAD_BANDS)
def test_sweep_kernel_refuses_a_band_it_cannot_run(cuda, case):
    grid, forward, lines = BAD_BANDS[case]
    A = build_dist_matrix(hpcg_27pt(*grid), n_devices=1, symmetric=True,
                          local_format="dia", device=cuda)
    data, offs = A.local_dia_data[0], A.dia_offsets
    b = A.to_dist(_load(A.nrows_global))
    x = torch.zeros_like(b)
    table = symgs_dia_cuda.device_steps(tuple(offs), grid, cuda)
    _build.launches.clear()
    with pytest.raises(RuntimeError, match="symgs_dia_f64 launch failed"):
        _build.launch("symgs_dia_f64", cuda, data.data_ptr(), b.data_ptr(),
                      x.data_ptr(), None, None, table.data_ptr(), len(offs), *grid,
                      int(forward), *lines, key=("symgs_planes", grid), count=2)
    torch.cuda.synchronize()
    assert not _build.launches
    assert not torch.any(x)


@pytest.mark.cuda
def test_preconditioned_set_on_the_card_is_the_cpus(cuda):
    got = []
    for device in ("cpu", cuda):
        A, mg = _mg(device=device)
        b = A.to_dist(_load(A.nrows_global))
        before = dict(gmg.sweeps)
        _build.launches.clear()
        res = cg_module.cg(A.matvec, b, kmax=50, rtol=0.0,
                           preconditioner=mg.as_preconditioner())
        got.append(res.x.cpu())
    # the card's dots and the DIA apply sum in other orders than the CPU's
    assert _err(got[1], got[0].reshape(-1)) < TOL[np.float64]
    # every sweep of the card's set on its level's grid through the kernel
    for k, lv in enumerate(mg.levels):
        swept = gmg.sweeps[k] - before.get(k, 0)
        assert swept > 0
        assert _build.launches["symgs_planes", lv.grid] == \
            swept * symgs_dia_cuda.sweep_launches(lv.grid)
