"""WELL block SpMM wrappers over the CUDA kernels of ``csrc/spmm_well.cu``.

Counterpart of ``spmv_tpu.ops.spmm_well_pallas``: ``well_spmm`` replaces
``_well_mrhs_kernel`` and ``well_ds_spmm`` replaces
``_well_ds_mrhs_kernel``. D stacked shards take one launch; blocks stay in
the SpMM lane layout (rows, nrhs*128), hi/lo float32 pairs for DS.

A CPU tensor takes the plain torch version (``ops/spmm_well.py``); a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
(one per call on a CUDA tensor, none on the plain path).
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import LANES
from spmv_torch.ops.spmm_well import (
    spmm_well_ds_stacked_plain,
    spmm_well_stacked_plain,
)
from spmv_torch.ops.spmv_dia_cuda import _lanes_ok

launches = {"well_spmm": 0, "well_ds_spmm": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(planes, pos, w0, xs, tile_groups: int) -> int:
    """Validate stacked WELL operands: value planes and pos (D, K, G, 128),
    w0 (D, G/tile_groups), each x plane (D*col_pad/128, nrhs*128). Returns
    col_pad (x rows per shard, times 128)."""
    ops = (*planes, pos, w0, *xs)
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"WELL operands on several devices: {sorted(map(str, devs))}")
    if pos.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"pos must be int16 or int32, got {pos.dtype}")
    if w0.dtype != torch.int32:
        raise TypeError(f"w0 must be int32, got {w0.dtype}")
    if pos.dim() != 4 or pos.shape[3] != LANES or any(v.shape != pos.shape
                                                       for v in planes):
        raise ValueError(f"values and pos must be (D, K, G, 128), got "
                         f"{[tuple(t.shape) for t in (*planes, pos)]}")
    nd, k, g, _ = pos.shape
    if k < 1 or g < 1 or tile_groups < 1 or g % tile_groups:
        raise ValueError(f"G={g} groups must be a positive multiple of "
                         f"tile_groups={tile_groups}, with K={k} >= 1 slots")
    if tuple(w0.shape) != (nd, g // tile_groups):
        raise ValueError(f"w0 must be ({nd}, {g // tile_groups}), got "
                         f"{tuple(w0.shape)}")
    for x in xs:
        if (x.dim() != 2 or not _lanes_ok(x.shape[1], True) or x.shape[0] % nd
                or x.shape != xs[0].shape):
            raise ValueError(f"x must be (D*col_pad/128, nrhs*128) for D={nd}, "
                             f"got {[tuple(t.shape) for t in xs]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("WELL apply takes contiguous operands")
    return xs[0].shape[0] // nd * LANES


def spmm_well_stacked(values: torch.Tensor, pos: torch.Tensor, w0: torch.Tensor,
                      x2: torch.Tensor, tile_groups: int) -> torch.Tensor:
    """Stacked-shard block apply, one launch for all D shards and columns:
    values/pos (D, K, G, 128), w0 (D, G/tile_groups), x2 (D*col_pad/128,
    nrhs*128) -> y2 (D*G, nrhs*128). Shard s reads only its own col_pad
    rows of x (zero outside)."""
    if values.dtype not in (torch.float32, torch.float64) or x2.dtype != values.dtype:
        raise TypeError(f"WELL apply takes float32 or float64 values and x of "
                        f"the same dtype, got {values.dtype} and {x2.dtype}")
    col_pad = _check((values,), pos, w0, (x2,), tile_groups)
    if x2.device.type == "cpu":
        return spmm_well_stacked_plain(values, pos, w0, x2, tile_groups)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no WELL SpMM kernel for device {x2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, k, g, _ = values.shape
    nrhs = x2.shape[1] // LANES
    y2 = torch.empty((nd * g, nrhs * LANES), dtype=values.dtype, device=x2.device)
    name = ("well_spmm_" + ("f64" if values.dtype == torch.float64 else "f32")
            + ("_i16" if pos.dtype == torch.int16 else "_i32"))
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = getattr(lib, name)(values.data_ptr(), pos.data_ptr(), w0.data_ptr(),
                                x2.data_ptr(), y2.data_ptr(), g, k, tile_groups,
                                col_pad, nrhs, nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches["well_spmm"] += 1
    return y2


def spmm_well_ds_stacked(values_hi: torch.Tensor, values_lo: torch.Tensor,
                         pos: torch.Tensor, w0: torch.Tensor, xh2: torch.Tensor,
                         xl2: torch.Tensor, tile_groups: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard double-single block apply, one launch for all D shards
    and columns: values hi/lo and pos (D, K, G, 128), w0 (D, G/tile_groups),
    x hi/lo (D*col_pad/128, nrhs*128) -> (yh, yl) (D*G, nrhs*128)."""
    planes = (values_hi, values_lo, xh2, xl2)
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError("DS WELL apply takes float32 hi/lo planes, got "
                        f"{[str(t.dtype) for t in planes]}")
    col_pad = _check((values_hi, values_lo), pos, w0, (xh2, xl2), tile_groups)
    if xh2.device.type == "cpu":
        return spmm_well_ds_stacked_plain(values_hi, values_lo, pos, w0, xh2,
                                          xl2, tile_groups)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS WELL SpMM kernel for device {xh2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, k, g, _ = values_hi.shape
    nrhs = xh2.shape[1] // LANES
    yh = torch.empty((nd * g, nrhs * LANES), dtype=torch.float32, device=xh2.device)
    yl = torch.empty_like(yh)
    name = "well_ds_spmm_" + ("i16" if pos.dtype == torch.int16 else "i32")
    with torch.cuda.device(xh2.device):
        stream = torch.cuda.current_stream(xh2.device).cuda_stream
        rc = getattr(lib, name)(values_hi.data_ptr(), values_lo.data_ptr(),
                                pos.data_ptr(), w0.data_ptr(), xh2.data_ptr(),
                                xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                                g, k, tile_groups, col_pad, nrhs, nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches["well_ds_spmm"] += 1
    return yh, yl
