"""WELL SpMV: the plain torch version and the format-level entry points.

Counterpart of the apply functions of ``spmv_tpu.ops.spmv_well_pallas``
(``well_to_2d``, ``spmv_well_pallas_2d`` as ``spmv_well_2d``,
``spmv_well``, ``spmv_well_sym``, ``spmv_well_sym_2d``).
``spmv_well_stacked_plain`` is the plain version of the CUDA kernel
(``ops/spmv_well_cuda.py``): one torch gather of ``x[w0[tile]*128 + pos]``
per slot, times the values, summed over the K
slots in order. It is the CPU path and the card's oracle for the kernel.
The entry points go through the wrapper, which takes the plain version on
a CPU tensor and launches the kernel on a CUDA tensor.

The far remainders of the symmetric form are applied with ``index_add_``
(plain torch: on the TPU they were XLA scatter-adds, not a Pallas kernel).
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import LANES, SymWellMatrix, WellMatrix


def spmv_well_stacked_plain(values: torch.Tensor, pos: torch.Tensor,
                            w0: torch.Tensor, x2: torch.Tensor,
                            tile_groups: int) -> torch.Tensor:
    """D stacked WELL blocks: values/pos (D, K, G, 128), w0 (D, G/tg),
    x2 (D*col_pad/128, 128) -> y2 (D*G, 128)."""
    nd, k, g, _ = values.shape
    xs = x2.reshape(nd, -1)
    base = (w0.to(torch.int64) * LANES).repeat_interleave(
        tile_groups * LANES, dim=1)  # (D, G*128)
    y = values.new_zeros((nd, g * LANES))
    for kk in range(k):
        idx = base + pos[:, kk].reshape(nd, -1).to(torch.int64)
        y += values[:, kk].reshape(nd, -1) * torch.gather(xs, 1, idx)
    return y.reshape(nd * g, LANES)


def well_to_2d(a: WellMatrix, x: torch.Tensor) -> torch.Tensor:
    """A flat x in the (ncols_pad/128, 128) lane layout the format reads
    (a view when x is already padded; zero-filled otherwise)."""
    if x.dim() == 2:
        return x
    npad = a.ncols_pad
    if x.shape[0] == npad:
        return x.reshape(npad // LANES, LANES)
    flat = x.new_zeros(npad)
    take = min(x.shape[0], npad)
    flat[:take] = x[:take]
    return flat.reshape(npad // LANES, LANES)


def spmv_well_2d(a: WellMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout SpMV: x2 (ncols_pad/128, 128) -> y2 (nrows_pad/128, 128);
    output (g, j) is row 128g + j."""
    # imported here: the wrapper module imports this one for the plain path
    from spmv_torch.ops.spmv_well_cuda import spmv_well_stacked

    return spmv_well_stacked(a.values.unsqueeze(0), a.pos.unsqueeze(0),
                             a.w0.unsqueeze(0), x2, a.tile_groups)


def spmv_well(a: WellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a flat x, of length nrows_pad."""
    return spmv_well_2d(a, well_to_2d(a, x)).reshape(a.nrows_pad)


def far_add(y: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            vals: torch.Tensor, x: torch.Tensor) -> None:
    """y[s, rows[s]] += vals[s] * x[s, cols[s]] in place for every shard s
    of a compact-COO far remainder: y (D, R), x (D, C), the rest (D, F).
    ``index_add_`` sums with atomics on the card, so the order (and the
    last bits) may change from run to run."""
    nd = rows.shape[0]
    shard = torch.arange(nd, device=rows.device)[:, None]
    src = vals * x.reshape(-1)[(cols + shard * x.shape[1]).reshape(-1)].reshape(nd, -1)
    y.view(-1).index_add_(0, (rows + shard * y.shape[1]).reshape(-1),
                          src.reshape(-1))


def spmv_well_sym(a: SymWellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = (L + D + L^T) x with both triangles as WELL gather applies, the
    diagonal product and the (usually empty) far remainders. ``x`` flat
    (>= nrows); returns flat y of length nrows_pad."""
    npad = a.nrows_pad
    xp = x
    if x.shape[0] != npad:
        xp = x.new_zeros(npad)
        xp[: min(x.shape[0], npad)] = x[:npad]
    y = spmv_well(a.lower, xp) + spmv_well(a.upper, xp)
    y = y + a.diag * xp
    for far in (a.farl, a.faru):
        if far is not None:
            far_add(y.view(1, -1), *(t.view(1, -1) for t in far), xp.view(1, -1))
    return y


def spmv_well_sym_2d(a: SymWellMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout wrapper for solver chaining: x2 (nrows_pad/128, 128) ->
    y2 of the same shape."""
    return spmv_well_sym(a, x2.reshape(-1)).reshape(-1, LANES)
