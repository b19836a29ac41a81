"""WELL SpMV wrapper over the CUDA kernel of ``csrc/spmv_well.cu``.

Counterpart of ``spmv_tpu.ops.spmv_well_pallas``: ``well_spmv`` replaces
``_well_kernel``. The kernel reads the WELL stack's warp-sliced row lists
(``formats/well.pack_rows``). D stacked shards take one launch; vectors
stay in the (rows, 128) lane layout.

A CPU tensor takes the plain torch version (``ops/spmv_well.py``); a CUDA
tensor launches the kernel or raises, counted in ``_build.launches`` under
"well".
"""
from __future__ import annotations

import torch

from spmv_torch import _build
from spmv_torch.formats.well import LANES, SLICE
from spmv_torch.ops.spmv_dia_cuda import _lanes_ok
from spmv_torch.ops.spmv_well import spmv_well_rows_plain


def check_rows(planes, pos, slice_ptr, w0, xs, tile_groups: int,
               block: bool = False) -> int:
    """Validate stacked row-list operands: value planes and pos (D, E),
    slice_ptr (D, S+1) with S a multiple of 4 (G = S/4 groups), w0
    (D, G/tile_groups), each x plane (D*col_pad/128, 128), or
    (D*col_pad/128, nrhs*128) in the SpMM lane layout for a ``block``
    apply. Returns col_pad (x rows per shard, times 128)."""
    ops = (*planes, pos, slice_ptr, w0, *xs)
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"WELL operands on several devices: {sorted(map(str, devs))}")
    if pos.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"pos must be int16 or int32, got {pos.dtype}")
    if slice_ptr.dtype != torch.int64:
        raise TypeError(f"slice_ptr must be int64, got {slice_ptr.dtype}")
    if w0.dtype != torch.int32:
        raise TypeError(f"w0 must be int32, got {w0.dtype}")
    if pos.dim() != 2 or pos.shape[1] < 1 or any(v.shape != pos.shape for v in planes):
        raise ValueError(f"values and pos must be (D, E), got "
                         f"{[tuple(t.shape) for t in (*planes, pos)]}")
    nd = pos.shape[0]
    ns = slice_ptr.shape[-1] - 1 if slice_ptr.dim() == 2 else 0
    if ns < 1 or slice_ptr.shape[0] != nd or ns % (LANES // SLICE):
        raise ValueError(f"slice_ptr must be ({nd}, S+1) with S a positive multiple "
                         f"of {LANES // SLICE}, got {tuple(slice_ptr.shape)}")
    g = ns // (LANES // SLICE)
    if tile_groups < 1 or g % tile_groups:
        raise ValueError(f"G={g} groups must be a multiple of tile_groups={tile_groups}")
    if tuple(w0.shape) != (nd, g // tile_groups):
        raise ValueError(f"w0 must be ({nd}, {g // tile_groups}), got "
                         f"{tuple(w0.shape)}")
    for x in xs:
        if (x.dim() != 2 or not _lanes_ok(x.shape[1], block) or x.shape[0] % nd
                or x.shape != xs[0].shape):
            raise ValueError(f"x must be (D*col_pad/128, {'nrhs*' if block else ''}128) "
                             f"for D={nd}, got {[tuple(t.shape) for t in xs]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("WELL apply takes contiguous operands")
    return xs[0].shape[0] // nd * LANES


def spmv_well_stacked(values: torch.Tensor, pos: torch.Tensor,
                      slice_ptr: torch.Tensor, w0: torch.Tensor,
                      x2: torch.Tensor, tile_groups: int) -> torch.Tensor:
    """Stacked-shard lane-layout apply, one launch for all D shards: the row
    lists values/pos (D, E) and slice_ptr (D, S+1), w0 (D, G/tile_groups)
    with G = S/4, x2 (D*col_pad/128, 128) -> y2 (D*G, 128). Shard s reads
    only its own col_pad entries of x (zero outside)."""
    if values.dtype not in (torch.float32, torch.float64) or x2.dtype != values.dtype:
        raise TypeError(f"WELL apply takes float32 or float64 values and x of "
                        f"the same dtype, got {values.dtype} and {x2.dtype}")
    col_pad = check_rows((values,), pos, slice_ptr, w0, (x2,), tile_groups)
    if x2.device.type == "cpu":
        return spmv_well_rows_plain(values, pos, slice_ptr, w0, x2, tile_groups)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no WELL kernel for device {x2.device}")
    nd, ns = slice_ptr.shape[0], slice_ptr.shape[1] - 1
    y2 = torch.empty((nd * ns * SLICE // LANES, LANES), dtype=values.dtype,
                     device=x2.device)
    name = ("well_spmv_" + ("f64" if values.dtype == torch.float64 else "f32")
            + ("_i16" if pos.dtype == torch.int16 else "_i32"))
    _build.launch(name, x2.device, values.data_ptr(), pos.data_ptr(),
                  slice_ptr.data_ptr(), w0.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                  ns, values.shape[1], tile_groups, col_pad, nd, key="well")
    return y2
