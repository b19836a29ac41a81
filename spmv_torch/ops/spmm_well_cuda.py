"""WELL block SpMM wrappers over the CUDA kernels of ``csrc/spmm_well.cu``.

Counterpart of ``spmv_tpu.ops.spmm_well_pallas``: ``well_spmm`` replaces
``_well_mrhs_kernel`` and ``well_ds_spmm`` replaces
``_well_ds_mrhs_kernel``. The kernels read the stack's warp-sliced row
lists (``formats/well.pack_rows``), as the single-RHS kernels do. D
stacked shards take one launch; blocks stay in the SpMM lane layout
(rows, nrhs*128), hi/lo float32 pairs for DS.

A CPU tensor takes the plain torch version (``ops/spmm_well.py``); a CUDA
tensor launches the kernel or raises, counted in ``_build.launches`` under
"well_spmm" and "well_ds_spmm".
"""
from __future__ import annotations

import torch

from spmv_torch import _build
from spmv_torch.formats.well import LANES, SLICE
from spmv_torch.ops.spmm_well import (
    spmm_well_ds_stacked_plain,
    spmm_well_stacked_plain,
)
from spmv_torch.ops.spmv_well_cuda import check_rows


def spmm_well_stacked(values: torch.Tensor, pos: torch.Tensor,
                      slice_ptr: torch.Tensor, w0: torch.Tensor,
                      x2: torch.Tensor, tile_groups: int) -> torch.Tensor:
    """Stacked-shard block apply, one launch for all D shards and columns:
    the row lists values/pos (D, E) and slice_ptr (D, S+1), w0
    (D, G/tile_groups) with G = S/4, x2 (D*col_pad/128, nrhs*128) ->
    y2 (D*G, nrhs*128). Shard s reads only its own col_pad rows of x (zero
    outside)."""
    if values.dtype not in (torch.float32, torch.float64) or x2.dtype != values.dtype:
        raise TypeError(f"WELL apply takes float32 or float64 values and x of "
                        f"the same dtype, got {values.dtype} and {x2.dtype}")
    col_pad = check_rows((values,), pos, slice_ptr, w0, (x2,), tile_groups,
                         block=True)
    if x2.device.type == "cpu":
        return spmm_well_stacked_plain(values, pos, slice_ptr, w0, x2, tile_groups)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no WELL SpMM kernel for device {x2.device}")
    nd, ns = slice_ptr.shape[0], slice_ptr.shape[1] - 1
    nrhs = x2.shape[1] // LANES
    y2 = torch.empty((nd * ns * SLICE // LANES, nrhs * LANES), dtype=values.dtype,
                     device=x2.device)
    name = ("well_spmm_" + ("f64" if values.dtype == torch.float64 else "f32")
            + ("_i16" if pos.dtype == torch.int16 else "_i32"))
    _build.launch(name, x2.device, values.data_ptr(), pos.data_ptr(),
                  slice_ptr.data_ptr(), w0.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                  ns, values.shape[1], tile_groups, col_pad, nrhs, nd, key="well_spmm")
    return y2


def spmm_well_ds_stacked(values_hi: torch.Tensor, values_lo: torch.Tensor,
                         pos: torch.Tensor, slice_ptr: torch.Tensor,
                         w0: torch.Tensor, xh2: torch.Tensor, xl2: torch.Tensor,
                         tile_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard double-single block apply, one launch for all D shards
    and columns: the row lists values hi/lo and pos (D, E) and slice_ptr
    (D, S+1), w0 (D, G/tile_groups) with G = S/4, x hi/lo
    (D*col_pad/128, nrhs*128) -> (yh, yl) (D*G, nrhs*128)."""
    planes = (values_hi, values_lo, xh2, xl2)
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError("DS WELL apply takes float32 hi/lo planes, got "
                        f"{[str(t.dtype) for t in planes]}")
    col_pad = check_rows((values_hi, values_lo), pos, slice_ptr, w0, (xh2, xl2),
                         tile_groups, block=True)
    if xh2.device.type == "cpu":
        return spmm_well_ds_stacked_plain(values_hi, values_lo, pos, slice_ptr, w0,
                                          xh2, xl2, tile_groups)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS WELL SpMM kernel for device {xh2.device}")
    nd, ns = slice_ptr.shape[0], slice_ptr.shape[1] - 1
    nrhs = xh2.shape[1] // LANES
    yh = torch.empty((nd * ns * SLICE // LANES, nrhs * LANES), dtype=torch.float32,
                     device=xh2.device)
    yl = torch.empty_like(yh)
    name = "well_ds_spmm_" + ("i16" if pos.dtype == torch.int16 else "i32")
    _build.launch(name, xh2.device, values_hi.data_ptr(), values_lo.data_ptr(),
                  pos.data_ptr(), slice_ptr.data_ptr(), w0.data_ptr(), xh2.data_ptr(),
                  xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(), ns, values_hi.shape[1],
                  tile_groups, col_pad, nrhs, nd, key="well_ds_spmm")
    return yh, yl
