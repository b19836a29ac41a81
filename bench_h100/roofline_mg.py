"""The least bytes of one multigrid V-cycle of HPCG's MG-PCG, counted from
the benchmark's level matrices (never from the program's objects), at the
configuration's itemsize.

- One sweep direction over a level of n rows with L stored values (the
  lower triangle with the diagonal) moves (L + 3 n) items: the values
  once, x read and written, r read. The first forward sweep of a level
  starts from x = 0 and moves (L + 2 n). A SymGS is a forward and a
  backward sweep; every level but the last makes two, the last one.
- On every level but the last, the residual is needed only at the next
  level's points (HPCG uses A x nowhere else): the values of those rows
  (each of their nonzeros: no two of them are neighbours, so no value is
  counted twice), x once (every point neighbours one of them) and r at
  them; the restriction and the prolongation each count their elements
  once (nc, the next level's rows).

An implementation that reads more than it must reads under 100% of this.
"""
from __future__ import annotations

import numpy as np

from bench_h100.reference.hpcg_mg import coarse_points
from bench_h100.roofline import PEAK_BYTES_PER_S


def sweep_items(levels: list) -> int:
    """Items the SymGS sweeps of one cycle move. ``levels``: [(grid, CSR)],
    finest first."""
    total = 0
    for k, (_, a) in enumerate(levels):
        n, lower = a.nrows, a.lower_nnz()
        first = lower + 2 * n
        total += first + (lower + 3 * n) * (1 if k + 1 == len(levels) else 3)
    return total


def transfer_items(levels: list) -> int:
    """Items of the residual at the coarse points, the restriction and the
    prolongation of one cycle."""
    total = 0
    for (grid, a), (_, coarse) in zip(levels[:-1], levels[1:]):
        f2c = coarse_points(grid)
        nc = coarse.nrows
        row_nnz = int(np.sum(a.rowptr[f2c + 1] - a.rowptr[f2c]))
        total += row_nnz + a.nrows + nc + 2 * nc
    return total


def cycle_bytes(levels: list, dtype: str) -> dict:
    """{"mg_sweep_bytes", "mg_cycle_bytes"}: one cycle's least bytes."""
    itemsize = np.dtype(dtype).itemsize
    sweeps = sweep_items(levels) * itemsize
    return {"mg_sweep_bytes": sweeps,
            "mg_cycle_bytes": sweeps + transfer_items(levels) * itemsize}


def cycles(run) -> tuple[float, int] | None:
    """(device seconds launched inside the traced slice's ``precond``
    spans, the cycles begun in it), or None where there is nothing to read:
    no device time (a CPU run), a device operation with no launch found,
    or no cycle in the slice."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.unlinked or not t.spans.get("precond") \
            or not t.device_s.get("precond"):
        return None
    return t.device_s["precond"], t.spans["precond"]


def share(least_bytes, device_s: float, count: int) -> float | None:
    """Percent of the peak bandwidth: ``least_bytes`` a cycle over the
    device seconds of ``count`` cycles; None without the bytes."""
    if not least_bytes or device_s <= 0 or count <= 0:
        return None
    return 100.0 * least_bytes / PEAK_BYTES_PER_S / (device_s / count)

