"""WELL block SpMM (Y = A X for nrhs columns): the plain torch versions and
the format-level entry points, plain and double-single.

Counterpart of ``spmv_tpu.ops.spmm_well_pallas`` (``spmm_well_pallas_2d``,
``spmm_well_ds_pallas_2d``). Blocks live in the SpMM lane layout of
``ops/spmm_dia.py``: (rows, nrhs*128), column r the lane slice
[r*128, (r+1)*128).

The block kernels of ``ops/spmm_well_cuda.py`` read the stack's row lists
(``formats/well.pack_rows``), as the single-RHS kernels do.
``spmm_well_stacked_plain`` and ``spmm_well_ds_stacked_plain`` are their
plain versions: the single-RHS row-list plain apply on each column, so
column r equals the single-RHS plain version on column r bit for bit.
They are the CPU path and the card's oracle for the kernels.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import WellMatrix
from spmv_torch.ops.spmm_dia import columns, from_columns
from spmv_torch.ops.spmv_well import spmv_well_rows_plain
from spmv_torch.ops.spmv_well_ds import WellDsMatrix, spmv_well_ds_rows_plain


def spmm_well_stacked_plain(values: torch.Tensor, pos: torch.Tensor,
                            slice_ptr: torch.Tensor, w0: torch.Tensor,
                            x2: torch.Tensor, tile_groups: int) -> torch.Tensor:
    """D stacked row lists: values/pos (D, E), slice_ptr (D, S+1), w0
    (D, S/4/tg), x2 (D*col_pad/128, nrhs*128) -> y2 (D*S/4, nrhs*128)."""
    return from_columns([spmv_well_rows_plain(values, pos, slice_ptr, w0, c,
                                              tile_groups)
                         for c in columns(x2)])


def spmm_well_ds_stacked_plain(values_hi: torch.Tensor, values_lo: torch.Tensor,
                               pos: torch.Tensor, slice_ptr: torch.Tensor,
                               w0: torch.Tensor, xh2: torch.Tensor,
                               xl2: torch.Tensor, tile_groups: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """D stacked DS row lists: values hi/lo and pos (D, E), slice_ptr
    (D, S+1), w0 (D, S/4/tg), x hi/lo (D*col_pad/128, nrhs*128) ->
    (yh, yl), each (D*S/4, nrhs*128)."""
    outs = [spmv_well_ds_rows_plain(values_hi, values_lo, pos, slice_ptr, w0,
                                    h, lo, tile_groups)
            for h, lo in zip(columns(xh2), columns(xl2))]
    return from_columns([o[0] for o in outs]), from_columns([o[1] for o in outs])


def spmm_well_2d(a: WellMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Block apply in the lane layout: x2 (ncols_pad/128, nrhs*128) ->
    y2 (nrows_pad/128, nrhs*128); the row lists are read once for up to 8
    columns."""
    from spmv_torch.ops.spmm_well_cuda import spmm_well_stacked

    return spmm_well_stacked(a.rows_values.unsqueeze(0), a.rows_pos.unsqueeze(0),
                             a.slice_ptr.unsqueeze(0), a.w0.unsqueeze(0), x2,
                             a.tile_groups)


def spmm_well_ds_2d(a: WellDsMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-single block apply in the lane layout: (hi, lo) x blocks
    (ncols_pad/128, nrhs*128) -> (hi, lo) y blocks (nrows_pad/128,
    nrhs*128), both value planes read once for up to 8 columns."""
    from spmv_torch.ops.spmm_well_cuda import spmm_well_ds_stacked

    return spmm_well_ds_stacked(
        a.rows_values_hi.unsqueeze(0), a.rows_values_lo.unsqueeze(0),
        a.rows_pos.unsqueeze(0), a.slice_ptr.unsqueeze(0), a.w0.unsqueeze(0),
        xh2, xl2, a.tile_groups)
