"""HPCG 3.1's geometric multigrid, as a preconditioner for ``cg``.

Not in the reference, which has no multigrid. One V-cycle, as
``ComputeMG_ref`` makes it, on levels of a structured grid, each coarser
level the same 27-point operator on a grid halved in every dimension
(``GenerateCoarseProblem``):

    x = 0;  SymGS(A, r, x)                       on every level but the last
    rc = r[f2c] - (A x)[f2c]                     restriction by injection
    xc = cycle(Ac, rc)                           the next level, from 0
    x[f2c] += xc                                 prolongation by injection
    SymGS(A, r, x)
    ...and on the coarsest level one SymGS alone,

where f2c takes coarse (i, j, k) to fine (2i, 2j, 2k) and SymGS is one
forward and one backward sweep of Gauss–Seidel, here in 8 colours
(``ops/symgs_dia.py``). Each level is a ``DistMatrix`` in symmetric DIA
storage on one shard (D = 1: the sweep needs every row of the grid on its
device), float32 or float64; the smoother and the restricted residual run
the kernels of ``csrc/symgs_dia.cu`` on the card (a sweep direction 2
launches, one a z parity of planes, so 28 sweep launches a 4-level cycle)
and their plain torch versions on the CPU, the prolongation a strided
torch add. The first SymGS of a level starts from x = 0, and its backward
sweep keeps the level's ``w``, the sum over the rows after each row in the
forward order; the prolongation changes only colour-0 points, which come
after no row, so the second SymGS starts from that ``w``
(``ops/symgs_dia.py``). Each sweep reads each coupling once.

Under a torch profiler an apply records ``spmv_torch.mg``, each SymGS
``spmv_torch.mg.smooth`` and each restriction or prolongation
``spmv_torch.mg.transfer``. ``sweeps`` counts, over the process and by
level (0 the finest), the sweep directions run; the kernels' launches are
in ``_build.launches``, by kernel and grid, and the bands each sweep
launch cut its planes into ``symgs_dia_cuda.bands`` (none on the plain
path).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from spmv_torch.formats.csr import CSRHost
from spmv_torch.gen import hpcg_27pt
from spmv_torch.ops import symgs_dia_cuda
from spmv_torch.parallel.dist_matrix import DistMatrix, build_dist_matrix
from spmv_torch.utils.profiling import profile_region

sweeps: collections.Counter = collections.Counter()

Grid = tuple[int, int, int]


@dataclasses.dataclass
class Level:
    A: DistMatrix
    grid: Grid
    # the pre-smoother's backward sum, which the post-smoother starts from
    # (every level but the last)
    w: torch.Tensor | None = None
    # the restricted residual and the level's correction, kept between
    # applies (coarse levels; the finest takes the caller's r and returns
    # a new x)
    r: torch.Tensor | None = None
    x: torch.Tensor | None = None

    @property
    def n(self) -> int:
        nx, ny, nz = self.grid
        return nx * ny * nz

    @property
    def data(self) -> torch.Tensor:
        return self.A.local_dia_data[0]

    def grid_view(self, v: torch.Tensor) -> torch.Tensor:
        """The vector's first n entries as the (nz, ny, nx) grid."""
        nx, ny, nz = self.grid
        return v.view(-1)[: self.n].view(nz, ny, nx)


class GeometricMG:
    """The V-cycle on ``operators[k]``, the 27-point operator on
    ``grids[k]`` = (nx, ny, nz), finest first, each grid the last one
    halved. Raises on anything else than one-shard symmetric DIA levels of
    one float32 or float64 dtype on one device."""

    def __init__(self, operators: list[DistMatrix], grids: list[Grid]):
        if not operators or len(operators) != len(grids):
            raise ValueError("GeometricMG takes one grid for each operator")
        fine = operators[0]
        for k, (A, g) in enumerate(zip(operators, grids)):
            if A.n_devices != 1:
                raise ValueError(f"GeometricMG runs on one shard (D = 1): level "
                                 f"{k} has {A.n_devices}")
            if A.local_format != "dia" or not A.symmetric:
                raise ValueError(f"level {k}: GeometricMG takes symmetric DIA "
                                 f"storage, got {A.local_format!r}, "
                                 f"symmetric={A.symmetric}")
            if A.dtype not in symgs_dia_cuda.DTYPES or A.dtype != fine.dtype \
                    or A.device != fine.device:
                raise ValueError(f"level {k}: {A.dtype} on {A.device}; every "
                                 "level float32 or float64, as the finest, on "
                                 "its device")
            if A.nrows_global != g[0] * g[1] * g[2]:
                raise ValueError(f"level {k}: {A.nrows_global} rows for grid {g}")
            if k and tuple(grids[k - 1]) != tuple(2 * v for v in g):
                raise ValueError(f"level {k}: grid {g} is not level {k - 1}'s "
                                 f"{grids[k - 1]} halved")
        self.levels = [Level(A, tuple(g)) for A, g in zip(operators, grids)]
        for k, lv in enumerate(self.levels):
            def zeros():
                return torch.zeros((lv.A.row_lane_rows, 128), dtype=lv.A.dtype,
                                   device=lv.A.device)
            if k + 1 < len(self.levels):
                lv.w = zeros()
            if k:
                lv.r, lv.x = zeros(), zeros()

    def as_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """M^-1 for ``cg(preconditioner=...)``: one V-cycle from zero on a
        residual in the finest operator's lane layout; returns a new
        vector (its padding zero)."""
        return self.apply

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        with profile_region("spmv_torch.mg"):
            fine = self.levels[0]
            x = torch.empty_like(r)
            x.view(-1)[fine.n:].zero_()
            self._cycle(0, r, x)
        return x

    def _cycle(self, k: int, r: torch.Tensor, x: torch.Tensor) -> None:
        lv = self.levels[k]
        self._symgs(k, r, x, from_zero=True)
        if k + 1 == len(self.levels):
            return
        coarse = self.levels[k + 1]
        with profile_region("spmv_torch.mg.transfer"):
            symgs_dia_cuda.restrict_residual(lv.data, lv.A.dia_offsets, lv.grid,
                                             r, x, coarse.r)
        self._cycle(k + 1, coarse.r, coarse.x)
        with profile_region("spmv_torch.mg.transfer"):
            lv.grid_view(x)[::2, ::2, ::2].add_(coarse.grid_view(coarse.x))
        self._symgs(k, r, x, from_zero=False)

    def _symgs(self, k: int, r: torch.Tensor, x: torch.Tensor,
               from_zero: bool) -> None:
        lv = self.levels[k]
        with profile_region("spmv_torch.mg.smooth"):
            w_in = None if from_zero else lv.w
            symgs_dia_cuda.symgs_sweep(lv.data, lv.A.dia_offsets, lv.grid,
                                       r, x, True, w_in)
            symgs_dia_cuda.symgs_sweep(lv.data, lv.A.dia_offsets, lv.grid,
                                       r, x, False, w_in,
                                       lv.w if from_zero else None)
        sweeps[k] += 2


def hpcg_hierarchy(A: DistMatrix, grid: Grid, levels: int = 4,
                   generate: Callable[[int, int, int], CSRHost] = hpcg_27pt
                   ) -> GeometricMG:
    """HPCG's multigrid on ``A``, its operator on ``grid``: ``levels`` - 1
    coarser levels, each ``generate``'s operator on the grid halved,
    assembled as ``A`` was (its dtype, symmetric DIA, one shard, its
    device)."""
    operators, grids = [A], [tuple(grid)]
    for _ in range(levels - 1):
        g = grids[-1]
        if any(v % 2 for v in g):
            raise ValueError(f"grid {grid} does not halve {levels - 1} times")
        g = tuple(v // 2 for v in g)
        operators.append(build_dist_matrix(
            generate(*g), n_devices=1, symmetric=A.symmetric, dtype=A.dtype,
            local_format=A.local_format, device=A.device))
        grids.append(g)
    return GeometricMG(operators, grids)
