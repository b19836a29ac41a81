"""DIA block SpMM (Y = A X for nrhs columns): the SpMM lane layout, the
plain torch versions and the format-level entry points.

Counterpart of ``spmv_tpu.ops.spmm_dia_pallas`` (``spmm_to_layout``,
``spmm_from_layout``, ``spmm_dia``). The layout is the reference's: a block
of nrhs vectors lives as (nrows_pad/128, nrhs*128), element (i, r*128 + j)
being flat element i*128 + j of column r; D stacked shards make it
(D*pad/128, nrhs*128). Column r of the layout is the lane slice
[r*128, (r+1)*128), so a single-RHS apply runs on it unchanged.

``spmm_dia_stacked_plain`` is the plain version of both CUDA kernels of
``ops/spmm_dia_cuda.py`` (vanilla ``dia_spmm`` and symmetric
``dia_sym_spmm``): the single-RHS plain apply on each column, so column r
equals ``spmv_dia_stacked_plain`` on column r bit for bit. It is the CPU
path and the card's oracle for the kernels.
"""
from __future__ import annotations

import torch

from spmv_torch.formats.dia import LANES, DiaMatrix
from spmv_torch.ops.spmv_dia import spmv_dia_stacked_plain


def spmm_to_layout(a, x) -> torch.Tensor:
    """(n, nrhs) column block -> the (nrows_pad/128, nrhs*128) lane layout
    on ``a``'s device, zero below row n (``a``: any matrix with
    ``nrows_pad`` and ``device``)."""
    npad = a.nrows_pad
    x = torch.as_tensor(x, device=a.device)
    n, nrhs = x.shape
    return to_lanes(x if n == npad else torch.cat([x, x.new_zeros((npad - n, nrhs))]))


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """(rows*128, nrhs) columns -> the (rows, nrhs*128) lane layout."""
    n, nrhs = x.shape
    return (x.reshape(n // LANES, LANES, nrhs).transpose(1, 2)
            .reshape(n // LANES, nrhs * LANES).contiguous())


def spmm_from_layout(y2: torch.Tensor, nrhs: int) -> torch.Tensor:
    """Inverse of ``spmm_to_layout``: (rows, nrhs*128) -> (rows*128, nrhs)."""
    rows = y2.shape[0]
    return y2.reshape(rows, nrhs, LANES).transpose(1, 2).reshape(rows * LANES, nrhs)


def columns(x2: torch.Tensor) -> list[torch.Tensor]:
    """The nrhs columns of a lane-layout block, each (rows, 128) contiguous."""
    rows, lanes = x2.shape
    x3 = x2.reshape(rows, lanes // LANES, LANES)
    return [x3[:, r].contiguous() for r in range(lanes // LANES)]


def from_columns(cols: list[torch.Tensor]) -> torch.Tensor:
    """Inverse of ``columns``: (rows, 128) columns -> (rows, nrhs*128)."""
    return torch.stack(cols, dim=1).reshape(cols[0].shape[0], -1)


def spmm_dia_stacked_plain(data: torch.Tensor, x2: torch.Tensor,
                           offsets: tuple[int, ...], symmetric: bool
                           ) -> torch.Tensor:
    """D stacked DIA blocks: data (D, R, K*128), x2 (D*R, nrhs*128) ->
    y2 (D*R, nrhs*128). Shard s reads only its own rows of x (zero
    outside). Symmetric storage (offsets <= 0) applies L + D + L^T."""
    return from_columns([spmv_dia_stacked_plain(data, c, offsets, symmetric)
                         for c in columns(x2)])


def spmm_dia_2d(a: DiaMatrix, x2: torch.Tensor) -> torch.Tensor:
    """Lane-layout block apply: x2 (nrows_pad/128, nrhs*128) -> y2 of the
    same shape; symmetric storage runs the symmetric kernel."""
    from spmv_torch.ops.spmm_dia_cuda import spmm_dia_stacked

    return spmm_dia_stacked(a.data.unsqueeze(0), x2, a.offsets, a.symmetric)


def spmm_dia(a: DiaMatrix, x) -> torch.Tensor:
    """Y = A X for X (n, nrhs): the matrix is read once for the whole block
    (once per chunk of 8 columns). Symmetric (lower-triangle) storage
    dispatches to the symmetric block kernel. Returns (nrows_pad, nrhs)."""
    x2 = spmm_to_layout(a, x)
    return spmm_from_layout(spmm_dia_2d(a, x2), x2.shape[1] // LANES)
