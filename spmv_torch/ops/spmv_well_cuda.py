"""WELL SpMV wrapper over the CUDA kernel of ``csrc/spmv_well.cu``.

Counterpart of ``spmv_tpu.ops.spmv_well_pallas``: ``well_spmv`` replaces
``_well_kernel``. D stacked shards take one launch; vectors stay in the
(rows, 128) lane layout.

A CPU tensor takes the plain torch version (``ops/spmv_well.py``); a CUDA
tensor launches the kernel or raises. ``launches["well"]`` counts kernel
launches (one per call on a CUDA tensor, none on the plain path), so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.well import LANES
from spmv_torch.ops.spmv_well import spmv_well_stacked_plain

launches = {"well": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _check(values, pos, w0, x2, tile_groups: int) -> int:
    """Validate the stacked operands; returns col_pad (x entries per shard)."""
    devs = {t.device for t in (values, pos, w0, x2)}
    if len(devs) != 1:
        raise ValueError(f"WELL operands on several devices: {sorted(map(str, devs))}")
    if values.dtype not in (torch.float32, torch.float64) or x2.dtype != values.dtype:
        raise TypeError(f"WELL apply takes float32 or float64 values and x of "
                        f"the same dtype, got {values.dtype} and {x2.dtype}")
    if pos.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"pos must be int16 or int32, got {pos.dtype}")
    if w0.dtype != torch.int32:
        raise TypeError(f"w0 must be int32, got {w0.dtype}")
    if values.dim() != 4 or values.shape[3] != LANES or pos.shape != values.shape:
        raise ValueError(f"values and pos must be (D, K, G, 128), got "
                         f"{tuple(values.shape)} and {tuple(pos.shape)}")
    nd, k, g, _ = values.shape
    if k < 1 or g < 1 or tile_groups < 1 or g % tile_groups:
        raise ValueError(f"G={g} groups must be a positive multiple of "
                         f"tile_groups={tile_groups}, with K={k} >= 1 slots")
    if tuple(w0.shape) != (nd, g // tile_groups):
        raise ValueError(f"w0 must be ({nd}, {g // tile_groups}), got "
                         f"{tuple(w0.shape)}")
    if x2.dim() != 2 or x2.shape[1] != LANES or x2.shape[0] % nd:
        raise ValueError(f"x must be (D*col_pad/128, 128) for D={nd}, got "
                         f"{tuple(x2.shape)}")
    if not all(t.is_contiguous() for t in (values, pos, w0, x2)):
        raise ValueError("WELL apply takes contiguous operands")
    return x2.shape[0] // nd * LANES


def spmv_well_stacked(values: torch.Tensor, pos: torch.Tensor,
                      w0: torch.Tensor, x2: torch.Tensor,
                      tile_groups: int) -> torch.Tensor:
    """Stacked-shard lane-layout apply, one launch for all D shards:
    values/pos (D, K, G, 128), w0 (D, G/tile_groups), x2 (D*col_pad/128,
    128) -> y2 (D*G, 128). Shard s reads only its own col_pad entries of x
    (zero outside)."""
    col_pad = _check(values, pos, w0, x2, tile_groups)
    if x2.device.type == "cpu":
        return spmv_well_stacked_plain(values, pos, w0, x2, tile_groups)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no WELL kernel for device {x2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, k, g, _ = values.shape
    y2 = torch.empty((nd * g, LANES), dtype=values.dtype, device=x2.device)
    name = ("well_spmv_" + ("f64" if values.dtype == torch.float64 else "f32")
            + ("_i16" if pos.dtype == torch.int16 else "_i32"))
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = getattr(lib, name)(values.data_ptr(), pos.data_ptr(),
                                w0.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                                g, k, tile_groups, col_pad, nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches["well"] += 1
    return y2
