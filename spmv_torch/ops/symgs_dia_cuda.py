"""The multigrid smoother and restriction on symmetric DIA storage:
wrappers over the kernels of ``csrc/symgs_dia.cu``, and their plain torch
versions (``ops/symgs_dia.py``, which says what a sweep computes).

Replaces no Pallas kernel: the reference has no multigrid.

- ``symgs_sweep(data, offsets, grid, r, x, forward, w_in, w_out)``: one
  sweep direction of the 8-colour symmetric Gauss–Seidel, x updated in
  place from the rows before each row and ``w_in`` (a backward sweep keeps
  its sum in ``w_out``); on the card 2 launches, the planes of one z
  parity each (1 where nz = 1), a block a plane or a band of one;
- ``restrict_residual(data, offsets, grid, r, x, rc)``: rc = r - A x at the
  coarse points (fine (2i, 2j, 2k)), in the coarse grid's numbering; one
  launch.

``data`` is a symmetric DIA block in the interleaved layout, (npad / 128,
K * 128) (a one-shard DistMatrix's ``local_dia_data[0]``), ``offsets`` its
stored offsets (ascending, all <= 0, the diagonal among them), ``grid``
(nx, ny, nz) the grid whose points are its rows. Vectors are contiguous,
of the block's dtype and at least n = nx ny nz long (the lane layout's
padding is neither read nor written).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises, counted in ``_build.launches`` by (kernel, grid), so by multigrid
level: ``("symgs_planes", grid)`` the sweep's, ``("restrict", grid)`` the
restriction's. How a sweep cuts its planes into bands is decided here
(``band_lines``), and the kernel takes the band lines of each launch;
``bands`` counts the sweep's launches by (grid, bands a plane) from the
lines passed, so a run shows how each level's shape cut its planes. Its
reader clears it.
"""
from __future__ import annotations

import collections
import functools

import torch

from spmv_torch import _build
from spmv_torch.formats.dia import LANES
from spmv_torch.ops.symgs_dia import restrict_residual_plain, symgs_sweep_plain

DTYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_DIAGS = 14   # csrc/symgs_dia.cu: kMaxDiags, the 27-point stencil's lower half
# must equal csrc/symgs_dia.cu's kSweepThreads, the block of the sweep's
# full shape: lines of more than twice as many points are long, and never cut
SWEEP_THREADS = 256
SMS = 132  # the H100's SMs, which the band rule fills

bands: collections.Counter = collections.Counter()


def steps(offsets: tuple[int, ...], grid: tuple[int, int, int]
          ) -> list[tuple[int, int, int, int]]:
    """Each stored diagonal's (u, ux, uy, uz): u = -offset split into grid
    steps, u = ux + nx (uy + ny uz) with 0 <= ux < nx, 0 <= uy < ny."""
    nx, ny, _ = grid
    out = []
    for o in offsets:
        u = -o
        out.append((u, u % nx, u // nx % ny, u // (nx * ny)))
    return out


@functools.lru_cache(maxsize=64)
def device_steps(offsets: tuple[int, ...], grid: tuple[int, int, int],
                 device: torch.device) -> torch.Tensor:
    """``steps`` as a (K, 4) int32 tensor on ``device``, which the kernels
    read; one copy per (offsets, grid, device)."""
    return torch.tensor(steps(offsets, grid), dtype=torch.int32, device=device)


def band_lines(grid: tuple[int, int, int], planes: int, forward: bool) -> int:
    """Lines of a band of a plane, where a launch takes ``planes`` planes:
    the whole plane, but where a forward sweep of short lines (at most 2
    SWEEP_THREADS points) has fewer planes than half the SMs, each plane
    cut into the most bands (a power of two) that keep the blocks within
    the SMs, each of an even number of lines and at least 4. A backward
    sweep is never cut (its update reads the row's x before the sweep,
    which a band beside may have overwritten). The sweep kernel takes it
    and refuses a band it cannot run."""
    nx, ny, _ = grid
    if not forward or nx > 2 * SWEEP_THREADS:
        return ny
    b = 1
    while 2 * b * planes <= SMS and ny >= 8 * b:
        b *= 2
    return ny if b == 1 else 2 * -(-ny // (2 * b))


def sweep_lines(grid: tuple[int, int, int], forward: bool) -> list[int]:
    """Lines a band of each launch of one sweep direction on the card, in
    launch order: the even planes then the odd forward, the odd then the
    even backward (a parity without planes takes no launch)."""
    nz = grid[2]
    return [band_lines(grid, (nz - pz + 1) // 2, forward)
            for pz in ((0, 1) if forward else (1, 0)) if (nz - pz + 1) // 2]


def sweep_bands(grid: tuple[int, int, int], forward: bool) -> list[int]:
    """Bands a plane of each launch of one sweep direction on the card, in
    launch order."""
    return [-(-grid[1] // lines) for lines in sweep_lines(grid, forward)]


def sweep_launches(grid: tuple[int, int, int]) -> int:
    """Launches of one sweep direction on the card: one a z parity that
    has planes, so 2, or 1 where nz = 1."""
    return len(sweep_bands(grid, True))


def _check(data: torch.Tensor, offsets, grid, *vecs: torch.Tensor) -> None:
    nx, ny, nz = grid
    n = nx * ny * nz
    k = len(offsets)
    if data.dtype not in DTYPES:
        raise TypeError(f"SymGS takes float32 or float64 storage, got {data.dtype}")
    if not 1 <= k <= MAX_DIAGS or list(offsets) != sorted(offsets) \
            or max(offsets) != 0:
        raise ValueError("SymGS takes symmetric DIA storage: at most "
                         f"{MAX_DIAGS} ascending offsets <= 0 ending with "
                         f"the diagonal, got {offsets}")
    if data.dim() != 2 or data.shape[1] != k * LANES or not data.is_contiguous():
        raise ValueError(f"DIA data must be a contiguous (npad/128, {k * LANES}) "
                         f"block, got {tuple(data.shape)}")
    if data.shape[0] * LANES < n or data.numel() >= 2**31:
        raise ValueError(f"the block's {data.shape[0] * LANES} rows do not hold "
                         f"the grid's {n}, or its index passes 32 bits")
    for v in vecs:
        if v.dtype != data.dtype or v.device != data.device:
            raise TypeError(f"SymGS vectors must be {data.dtype} on "
                            f"{data.device}, got {v.dtype} on {v.device}")
        if not v.is_contiguous():
            raise ValueError("SymGS takes contiguous vectors")


def symgs_sweep(data: torch.Tensor, offsets: tuple[int, ...],
                grid: tuple[int, int, int], r: torch.Tensor, x: torch.Tensor,
                forward: bool, w_in: torch.Tensor | None = None,
                w_out: torch.Tensor | None = None) -> None:
    """One sweep direction (colours 0 .. 7 forward, 7 .. 0 backward), x
    updated in place: ``w_in`` the sum over the rows after each row that
    the last backward sweep kept (None: 0, a SymGS from x = 0); a backward
    sweep keeps its own in ``w_out``, where given."""
    nx, ny, nz = grid
    if forward and w_out is not None:
        raise ValueError("a forward sweep keeps no w")
    vecs = [v for v in (r, x, w_in, w_out) if v is not None]
    if min(v.numel() for v in vecs) < nx * ny * nz:
        raise ValueError("SymGS vectors are shorter than the grid")
    _check(data, offsets, grid, *vecs)
    if x.device.type == "cpu":
        return symgs_sweep_plain(data, offsets, grid, r, x, forward, w_in, w_out)
    grid = tuple(grid)
    table = device_steps(tuple(offsets), grid, x.device)
    lines = sweep_lines(grid, forward)
    first, second = (lines + [ny])[:2]  # nz = 1: one launch, the second's unread
    _build.launch(f"symgs_dia_{DTYPES[data.dtype]}", x.device, data.data_ptr(),
                  r.data_ptr(), x.data_ptr(), None if w_in is None else w_in.data_ptr(),
                  None if w_out is None else w_out.data_ptr(), table.data_ptr(),
                  len(offsets), nx, ny, nz, int(forward), first, second,
                  key=("symgs_planes", grid), count=len(lines))
    for n in lines:
        bands[grid, -(-ny // n)] += 1


def restrict_residual(data: torch.Tensor, offsets: tuple[int, ...],
                      grid: tuple[int, int, int], r: torch.Tensor,
                      x: torch.Tensor, rc: torch.Tensor) -> None:
    """rc[:nc] = (r - A x) at the coarse points; nx, ny, nz even."""
    nx, ny, nz = grid
    if nx % 2 or ny % 2 or nz % 2:
        raise ValueError(f"restriction halves every dimension; got grid {grid}")
    if min(r.numel(), x.numel()) < nx * ny * nz or rc.numel() < nx * ny * nz // 8:
        raise ValueError("restriction vectors are shorter than their grids")
    _check(data, offsets, grid, r, x, rc)
    if x.device.type == "cpu":
        return restrict_residual_plain(data, offsets, grid, r, x, rc)
    table = device_steps(tuple(offsets), tuple(grid), x.device)
    _build.launch(f"mg_restrict_{DTYPES[data.dtype]}", x.device, data.data_ptr(),
                  r.data_ptr(), x.data_ptr(), rc.data_ptr(), table.data_ptr(),
                  len(offsets), nx, ny, nz, key=("restrict", tuple(grid)))
