"""Double-single WELL SpMV wrapper over the CUDA kernel of
``csrc/spmv_well_ds.cu``.

Counterpart of ``spmv_tpu.ops.spmv_well_pallas``: ``well_ds_spmv``
replaces ``_well_ds_kernel``. The kernel reads the WELL stack's
warp-sliced row lists (``formats/well.pack_rows``, both value planes). D
stacked shards take one launch; vectors stay in the (rows, 128) lane
layout as hi/lo float32 pairs.

A CPU tensor takes the plain torch version (``ops/spmv_well_ds.py``); a
CUDA tensor launches the kernel or raises, counted in ``_build.launches``
under "well_ds".
"""
from __future__ import annotations

import torch

from spmv_torch import _build
from spmv_torch.formats.well import LANES, SLICE
from spmv_torch.ops.spmv_well_cuda import check_rows
from spmv_torch.ops.spmv_well_ds import spmv_well_ds_rows_plain


def spmv_well_ds_stacked(values_hi: torch.Tensor, values_lo: torch.Tensor,
                         pos: torch.Tensor, slice_ptr: torch.Tensor,
                         w0: torch.Tensor, xh2: torch.Tensor, xl2: torch.Tensor,
                         tile_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard lane-layout DS apply, one launch for all D shards: the
    row lists values hi/lo and pos (D, E) and slice_ptr (D, S+1), w0
    (D, G/tile_groups) with G = S/4, x hi/lo (D*col_pad/128, 128) ->
    (yh, yl) (D*G, 128). Shard s reads only its own col_pad entries of x
    (zero outside)."""
    planes = (values_hi, values_lo, xh2, xl2)
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError("DS WELL apply takes float32 hi/lo planes, got "
                        f"{[str(t.dtype) for t in planes]}")
    col_pad = check_rows((values_hi, values_lo), pos, slice_ptr, w0, (xh2, xl2),
                         tile_groups)
    if xh2.device.type == "cpu":
        return spmv_well_ds_rows_plain(values_hi, values_lo, pos, slice_ptr, w0,
                                       xh2, xl2, tile_groups)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS WELL kernel for device {xh2.device}")
    nd, ns = slice_ptr.shape[0], slice_ptr.shape[1] - 1
    yh = torch.empty((nd * ns * SLICE // LANES, LANES), dtype=torch.float32,
                     device=xh2.device)
    yl = torch.empty_like(yh)
    name = "well_ds_spmv_" + ("i16" if pos.dtype == torch.int16 else "i32")
    _build.launch(name, xh2.device, values_hi.data_ptr(), values_lo.data_ptr(),
                  pos.data_ptr(), slice_ptr.data_ptr(), w0.data_ptr(), xh2.data_ptr(),
                  xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(), ns, values_hi.shape[1],
                  tile_groups, col_pad, nd, key="well_ds")
    return yh, yl
