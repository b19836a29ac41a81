"""WELL SpMV: the plain torch version and the format-level entry points.

Counterpart of the apply functions of ``spmv_tpu.ops.spmv_well_pallas``
(``well_to_2d``, ``spmv_well_pallas_2d`` as ``spmv_well_2d``,
``spmv_well``, ``spmv_well_sym``, ``spmv_well_sym_2d``).
``spmv_well_rows_plain`` is the plain version of the CUDA kernel
(``ops/spmv_well_cuda.py``), which reads the WELL stack's row lists
(``formats/well.pack_rows``): one torch gather of ``x[w0[tile]*128 + pos]``
per slice slot, times the values, summed in slot order. It is the CPU path
and the card's oracle for the kernel. ``spmv_well_stacked_plain`` applies
the WELL formula itself, one gather per WELL slot summed over the K slots
in order; it equals the row-list version bit for bit (each row sums the
same terms in the same order, and every padded term adds an exact zero)
and is the oracle both are held to. The entry points go through the
wrapper, which takes the plain version on a CPU tensor and launches the
kernel on a CUDA tensor. ``spmv_well_sym_rows_plain`` is the plain version
of the symmetric kernel (``spmv_well_sym_stacked``), which applies both
row-list stacks of the dual-WELL form and the diagonal in one pass.

The far remainders of the symmetric form are applied as gathers over
their ELL rectangles (plain torch: on the TPU they were XLA scatter-adds,
not a Pallas kernel), with no atomics, so the sum's order is fixed.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import LANES, SLICE, SymWellMatrix, WellMatrix


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


def row_slots(slice_ptr: torch.Tensor, w0: torch.Tensor, tile_groups: int):
    """Per-row geometry of D stacked row lists: (the entry of each row's
    slot 0, each row's slice width, each row's window base in x), each
    (D, R) int64, and the widest slice."""
    nd = slice_ptr.shape[0]
    start = slice_ptr[:, :-1]
    width = (slice_ptr[:, 1:] - start) // SLICE
    lane = torch.arange(SLICE, device=slice_ptr.device)
    first = (start[:, :, None] + lane).reshape(nd, -1)
    base = (w0.to(torch.int64) * LANES).repeat_interleave(tile_groups * LANES, dim=1)
    wmax = int(width.max()) if width.numel() else 0
    return first, width.repeat_interleave(SLICE, dim=1), base, wmax


def spmv_well_rows_plain(values: torch.Tensor, pos: torch.Tensor,
                         slice_ptr: torch.Tensor, w0: torch.Tensor,
                         x2: torch.Tensor, tile_groups: int) -> torch.Tensor:
    """D stacked row lists: values/pos (D, E), slice_ptr (D, S+1), w0
    (D, S/4/tg), x2 (D*col_pad/128, 128) -> y2 (D*S/4, 128). Rows past
    their slice's width keep their sum (the kernel's thread stops); a
    gather outside [0, col_pad) reads 0, as the kernel's does."""
    nd = values.shape[0]
    xs = x2.reshape(nd, -1)
    col_pad = xs.shape[1]
    first, width, base, wmax = row_slots(slice_ptr, w0, tile_groups)
    y = values.new_zeros(first.shape)
    for j in range(wmax):
        live = width > j
        e = torch.where(live, first + SLICE * j, 0)
        idx = base + torch.gather(pos, 1, e).to(torch.int64)
        inside = (idx >= 0) & (idx < col_pad)
        xj = torch.where(inside, torch.gather(xs, 1, idx.clamp(0, col_pad - 1)), 0)
        y = torch.where(live, y + torch.gather(values, 1, e) * xj, y)
    return y.reshape(-1, LANES)


def spmv_well_sym_rows_plain(lower: tuple, upper: tuple, diagonal: torch.Tensor,
                             x2: torch.Tensor, apply=spmv_well_rows_plain) -> torch.Tensor:
    """The symmetric dual-WELL apply y = L x + L^T x + d x of D stacked
    shards in three steps: ``apply`` over L's row lists, plus the same
    over L^T's, plus diagonal * x. ``lower`` and ``upper`` are (values,
    pos, slice_ptr, w0, tile_groups) of the two stacks, diagonal (D, R)
    and x2 (D*R/128, 128) -> y2 (D*R/128, 128). ``apply`` takes
    (values, pos, slice_ptr, w0, x2, tile_groups) of one stack, as
    ``spmv_well_rows_plain`` and ``spmv_well_stacked`` do: with the latter
    on the card these are the two-launch route that the fused kernel
    replaced, which it equals bit for bit."""
    *rows, tg = lower
    *rows_t, tg_t = upper
    y = apply(*rows, x2, tg) + apply(*rows_t, x2, tg_t)
    return y + diagonal.reshape(y.shape) * x2


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

    return spmv_well_stacked(a.rows_values.unsqueeze(0), a.rows_pos.unsqueeze(0),
                             a.slice_ptr.unsqueeze(0), a.w0.unsqueeze(0), x2,
                             a.tile_groups)


def spmv_well(a: WellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a flat x, of length nrows_pad."""
    return spmv_well_2d(a, well_to_2d(a, x)).reshape(a.nrows_pad)


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
    for far in (a.farl_ell, a.faru_ell):
        if far is not None:
            cols, vals = far
            y = y + (vals * xp[cols]).sum(-1)
    return y


def spmv_well_sym_2d(a: SymWellMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout wrapper for solver chaining: x2 (nrows_pad/128, 128) ->
    y2 of the same shape."""
    return spmv_well_sym(a, x2.reshape(-1)).reshape(-1, LANES)
