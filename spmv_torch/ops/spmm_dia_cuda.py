"""DIA block SpMM wrappers over the CUDA kernels of ``csrc/spmm_dia.cu``.

Counterpart of ``spmv_tpu.ops.spmm_dia_pallas``: ``dia_spmm`` replaces
``_dia_mrhs_kernel`` and ``dia_sym_spmm`` replaces ``_dia_sym_kernel`` at
nrhs > 1. D stacked shards take one launch; blocks stay in the SpMM lane
layout (rows, nrhs*128).

A CPU tensor takes the plain torch version (``ops/spmm_dia.py``); a CUDA
tensor launches the kernel or raises, counted in ``_build.launches`` under
"dia_spmm" and "dia_sym_spmm". ``dia_spmm`` is
the tile kernel of ``csrc/dia_window.cuh`` and reads its window plan
(``spmv_dia_cuda.window_plan``, one per offsets, nrhs and dtype, kept on
the card); ``dia_sym_spmm`` runs the kernel ``spmv_dia_cuda.route``
picks: its direct kernel, which reads the offsets from the card.
"""
from __future__ import annotations

import torch

from spmv_torch.ops.spmm_dia import spmm_dia_stacked_plain
from spmv_torch.ops.spmv_dia_cuda import _check, launch, route


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
    offsets = tuple(offsets)
    return launch(route(offsets, symmetric, True, data.dtype), data, x2, offsets,
                  symmetric, True)
