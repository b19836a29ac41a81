"""Double-single DIA SpMV wrapper over the CUDA kernel of
``csrc/spmv_dia_ds.cu``.

Counterpart of ``spmv_tpu.ops.spmv_dia_ds_pallas``: ``dia_ds_spmv``
replaces ``_dia_ds_kernel`` and ``dia_ds_spmm`` (``csrc/spmm_dia_ds.cu``)
replaces ``_dia_ds_mrhs_kernel``. D stacked shards take one launch; vectors
stay in the (rows, 128) lane layout, blocks in the SpMM lane layout
(rows, nrhs*128), as hi/lo float32 pairs.

A CPU tensor takes the plain torch version (``ops/spmv_dia_ds.py``); a CUDA
tensor launches the kernel or raises, counted in ``_build.launches`` under
"dia_ds" and "dia_ds_spmm".
"""
from __future__ import annotations

import numpy as np
import torch

from spmv_torch import _build
from spmv_torch.formats.dia import LANES
from spmv_torch.ops.spmv_dia_cuda import _lanes_ok
from spmv_torch.ops.spmv_dia_ds import (
    spmm_dia_ds_stacked_plain,
    spmv_dia_ds_stacked_plain,
)

MAX_DIAGS = 64  # SPMV_DIA_DS_MAX_DIAGS / SPMM_DIA_DS_MAX_DIAGS in csrc/


def _check(data_hi, data_lo, xh2, xl2, offsets, block: bool = False) -> None:
    ops = (data_hi, data_lo, xh2, xl2)
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"DS DIA operands on several devices: {sorted(map(str, devs))}")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("DS DIA apply takes float32 hi/lo planes, got "
                        f"{[str(t.dtype) for t in ops]}")
    k = len(offsets)
    if not 1 <= k <= MAX_DIAGS:
        raise ValueError(f"{k} diagonals; the kernel takes 1..{MAX_DIAGS}")
    if data_hi.dim() != 3 or data_hi.shape[2] != k * LANES or data_lo.shape != data_hi.shape:
        raise ValueError(f"data hi/lo must be (D, R, {k}*128), got "
                         f"{tuple(data_hi.shape)} and {tuple(data_lo.shape)}")
    nd, nr = data_hi.shape[0], data_hi.shape[1]
    for x in (xh2, xl2):
        if (x.dim() != 2 or x.shape != xh2.shape or x.shape[0] != nd * nr
                or not _lanes_ok(x.shape[1], block)):
            raise ValueError(f"x hi/lo must be ({nd * nr}, "
                             f"{'nrhs*' if block else ''}128), got {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("DS DIA apply takes contiguous operands")


def spmv_dia_ds_stacked(data_hi: torch.Tensor, data_lo: torch.Tensor,
                        xh2: torch.Tensor, xl2: torch.Tensor,
                        offsets: tuple[int, ...]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard lane-layout DS apply, one launch for all D shards:
    data hi/lo (D, R, K*128), x hi/lo (D*R, 128) -> (yh, yl) (D*R, 128).
    Shard s reads only its own R*128 entries of x (zero outside)."""
    _check(data_hi, data_lo, xh2, xl2, offsets)
    if xh2.device.type == "cpu":
        return spmv_dia_ds_stacked_plain(data_hi, data_lo, xh2, xl2, offsets)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS DIA kernel for device {xh2.device}")
    nd, nr = data_hi.shape[0], data_hi.shape[1]
    yh, yl = torch.empty_like(xh2), torch.empty_like(xl2)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    _build.launch("dia_ds_spmv", xh2.device, data_hi.data_ptr(), data_lo.data_ptr(),
                  xh2.data_ptr(), xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                  nr * LANES, len(offsets), offs.ctypes.data, nd, key="dia_ds")
    return yh, yl


def spmm_dia_ds_stacked(data_hi: torch.Tensor, data_lo: torch.Tensor,
                        xh2: torch.Tensor, xl2: torch.Tensor,
                        offsets: tuple[int, ...]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-shard DS block apply (``dia_ds_spmm``, replacing
    ``_dia_ds_mrhs_kernel``), one launch for all D shards and columns:
    data hi/lo (D, R, K*128), x hi/lo (D*R, nrhs*128) in the SpMM lane
    layout -> (yh, yl) (D*R, nrhs*128)."""
    _check(data_hi, data_lo, xh2, xl2, offsets, block=True)
    if xh2.device.type == "cpu":
        return spmm_dia_ds_stacked_plain(data_hi, data_lo, xh2, xl2, offsets)
    if xh2.device.type != "cuda":
        raise RuntimeError(f"no DS DIA SpMM kernel for device {xh2.device}")
    nd, nr = data_hi.shape[0], data_hi.shape[1]
    yh, yl = torch.empty_like(xh2), torch.empty_like(xl2)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    _build.launch("dia_ds_spmm", xh2.device, data_hi.data_ptr(), data_lo.data_ptr(),
                  xh2.data_ptr(), xl2.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                  nr * LANES, len(offsets), offs.ctypes.data, xh2.shape[1] // LANES,
                  nd, key="dia_ds_spmm")
    return yh, yl
