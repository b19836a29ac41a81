"""DIA block SpMM wrappers over the CUDA kernels of ``csrc/spmm_dia.cu``.

Counterpart of ``spmv_tpu.ops.spmm_dia_pallas``: ``dia_spmm`` replaces
``_dia_mrhs_kernel`` and ``dia_sym_spmm`` replaces ``_dia_sym_kernel`` at
nrhs > 1. D stacked shards take one launch; blocks stay in the SpMM lane
layout (rows, nrhs*128).

A CPU tensor takes the plain torch version (``ops/spmm_dia.py``); a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
(one per call on a CUDA tensor, none on the plain path). ``dia_spmm`` is
the tile kernel of ``csrc/dia_window.cuh`` and reads its window plan
(``spmv_dia_cuda.window_plan``, one per offsets, nrhs and dtype, kept on
the card); ``dia_sym_spmm`` reads the offsets from the card.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.dia import LANES
from spmv_torch.ops.spmm_dia import spmm_dia_stacked_plain
from spmv_torch.ops.spmv_dia_cuda import (
    DTYPES,
    _check,
    _check_aligned,
    device_offsets,
    device_window_plan,
)

launches = {"dia_spmm": 0, "dia_sym_spmm": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def spmm_dia_stacked(data: torch.Tensor, x2: torch.Tensor,
                     offsets: tuple[int, ...], symmetric: bool) -> torch.Tensor:
    """Stacked-shard block apply, one launch for all D shards and columns:
    data (D, R, K*128), x2 (D*R, nrhs*128) -> y2 (D*R, nrhs*128). Shard s
    reads only its own rows of x (zero outside)."""
    _check(data, x2, offsets, symmetric, block=True)
    if x2.device.type == "cpu":
        return spmm_dia_stacked_plain(data, x2, offsets, symmetric)
    if x2.device.type != "cuda":
        raise RuntimeError(f"no DIA SpMM kernel for device {x2.device}")
    from spmv_torch._build import load_library

    lib = load_library()
    nd, nr = data.shape[0], data.shape[1]
    nrhs = x2.shape[1] // LANES
    y2 = torch.empty_like(x2)
    key = "dia_sym_spmm" if symmetric else "dia_spmm"
    name = f"{key}_{DTYPES[data.dtype]}"
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        if symmetric:
            offs = device_offsets(tuple(offsets), x2.device)
            rc = getattr(lib, name)(data.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                                    nr * LANES, len(offsets), offs.data_ptr(), nrhs,
                                    nd, stream)
        else:
            _check_aligned(data, x2)
            plan, table = device_window_plan(tuple(offsets), False, nrhs, data.dtype,
                                             x2.device)
            rc = getattr(lib, name)(data.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                                    nr * LANES, len(offsets), table.data_ptr(),
                                    plan.rows, plan.smem_bytes, nrhs, nd, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[key] += 1
    return y2
