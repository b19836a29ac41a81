"""Double-single WELL SpMV wrapper over the CUDA kernel of
``csrc/spmv_well_ds.cu``.

Counterpart of ``spmv_tpu.ops.spmv_well_pallas``: ``well_ds_spmv``
replaces ``_well_ds_kernel``. D stacked shards take one launch; vectors
stay in the (rows, 128) lane layout as hi/lo float32 pairs.

A CPU tensor takes the plain torch version (``ops/spmv_well_ds.py``); a
CUDA tensor launches the kernel or raises. ``launches["well_ds"]`` counts
kernel launches (one per call on a CUDA tensor, none on the plain path),
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import LANES
from spmv_torch.ops.spmv_dia_cuda import _lanes_ok
from spmv_torch.ops.spmv_well_ds import spmv_well_ds_stacked_plain

launches = {"well_ds": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(values_hi, values_lo, pos, w0, xh2, xl2, tile_groups: int,
           block: bool = False) -> int:
    """Validate the stacked operands; returns col_pad (x entries per shard)."""
    ops = (values_hi, values_lo, pos, w0, xh2, xl2)
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"DS WELL operands on several devices: {sorted(map(str, devs))}")
    planes = (values_hi, values_lo, xh2, xl2)
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError("DS WELL apply takes float32 hi/lo planes, got "
                        f"{[str(t.dtype) for t in planes]}")
    if pos.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"pos must be int16 or int32, got {pos.dtype}")
    if w0.dtype != torch.int32:
        raise TypeError(f"w0 must be int32, got {w0.dtype}")
    if (values_hi.dim() != 4 or values_hi.shape[3] != LANES
            or values_lo.shape != values_hi.shape or pos.shape != values_hi.shape):
        raise ValueError("values hi/lo and pos must be (D, K, G, 128), got "
                         f"{tuple(values_hi.shape)}, {tuple(values_lo.shape)} "
                         f"and {tuple(pos.shape)}")
    nd, k, g, _ = values_hi.shape
    if k < 1 or g < 1 or tile_groups < 1 or g % tile_groups:
        raise ValueError(f"G={g} groups must be a positive multiple of "
                         f"tile_groups={tile_groups}, with K={k} >= 1 slots")
    if tuple(w0.shape) != (nd, g // tile_groups):
        raise ValueError(f"w0 must be ({nd}, {g // tile_groups}), got "
                         f"{tuple(w0.shape)}")
    for x in (xh2, xl2):
        if (x.dim() != 2 or not _lanes_ok(x.shape[1], block) or x.shape[0] % nd
                or x.shape != xh2.shape):
            raise ValueError(f"x hi/lo must be (D*col_pad/128, "
                             f"{'nrhs*' if block else ''}128) for D={nd}, "
                             f"got {tuple(xh2.shape)} and {tuple(xl2.shape)}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("DS WELL apply takes contiguous operands")
    return xh2.shape[0] // nd * LANES


def spmv_well_ds_stacked(values_hi: torch.Tensor, values_lo: torch.Tensor,
                         pos: torch.Tensor, w0: torch.Tensor,
                         xh2: torch.Tensor, xl2: torch.Tensor, tile_groups: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard lane-layout DS apply, one launch for all D shards:
    values hi/lo and pos (D, K, G, 128), w0 (D, G/tile_groups), x hi/lo
    (D*col_pad/128, 128) -> (yh, yl) (D*G, 128). Shard s reads only its own
    col_pad entries of x (zero outside)."""
    col_pad = _check(values_hi, values_lo, pos, w0, xh2, xl2, tile_groups)
    if xh2.device.type == "cpu":
        return spmv_well_ds_stacked_plain(values_hi, values_lo, pos, w0, xh2,
                                          xl2, tile_groups)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS WELL kernel for device {xh2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, k, g, _ = values_hi.shape
    yh = torch.empty((nd * g, LANES), dtype=torch.float32, device=xh2.device)
    yl = torch.empty_like(yh)
    name = "well_ds_spmv_" + ("i16" if pos.dtype == torch.int16 else "i32")
    with torch.cuda.device(xh2.device):
        stream = torch.cuda.current_stream(xh2.device).cuda_stream
        rc = getattr(lib, name)(values_hi.data_ptr(), values_lo.data_ptr(),
                                pos.data_ptr(), w0.data_ptr(), xh2.data_ptr(),
                                xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                                g, k, tile_groups, col_pad, nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches["well_ds"] += 1
    return yh, yl
