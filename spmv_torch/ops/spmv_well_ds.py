"""Double-single (float64-class) WELL: the container, the packer and the
plain torch apply.

Counterpart of the double-single part of ``spmv_tpu.ops.spmv_well_pallas``
(``WellDsMatrix``, ``csr_to_well_ds``, ``spmv_well_ds``). One packing, two
float32 value planes (``spmv_torch.ds``); the split stays in numpy until
upload. Each slot's term is ``ds_mul_f32`` of the values and the gathered
x pair, accumulated with ``ds_add`` for k = 0..K-1 in order.

``spmv_well_ds_stacked_plain`` is the plain version of the CUDA kernel
(``ops/spmv_well_ds_cuda.py``): the CPU path and the card's oracle for the
kernel. The entry points go through the wrapper, which takes the plain
version on a CPU tensor and launches the kernel on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64, ds_mul_f32, ds_to_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.well import LANES, _build_arrays, _equalize_square_pads


@dataclasses.dataclass
class WellDsMatrix:
    """WELL matrix in double-single storage (hi/lo float32 value planes
    sharing one ``pos``; see ``formats/well.py`` for the layout)."""

    values_hi: torch.Tensor  # (K, G, 128)
    values_lo: torch.Tensor
    pos: torch.Tensor        # (K, G, 128) int16/int32
    w0: torch.Tensor         # (G / tile_groups,) int32
    nrows: int
    ncols: int
    wseg: int
    tile_groups: int
    nseg: int = 0
    _nnz: int = 0
    paired: bool = False

    @property
    def ngroups(self) -> int:
        return self.values_hi.shape[1]

    @property
    def k_slots(self) -> int:
        return self.values_hi.shape[0]

    @property
    def nrows_pad(self) -> int:
        return self.ngroups * LANES

    @property
    def ncols_pad(self) -> int:
        return self.nseg * LANES

    @property
    def n_tiles(self) -> int:
        return self.ngroups // self.tile_groups

    @property
    def device(self) -> torch.device:
        return self.values_hi.device


def csr_to_well_ds(a: CSRHost, tile_groups: int = 16, max_k: int = 64,
                   pair: bool = False, *, device="cuda") -> WellDsMatrix:
    """Convert a float64 host CSR to double-single WELL on ``device`` (the
    card unless the caller asks for another)."""
    v64, pos, w0, wseg, nseg_x, paired = _build_arrays(
        a, tile_groups, max_k, np.float64, pair=pair)
    if a.nrows == a.ncols:
        # square operators chain pad-free
        v64, pos, w0, nseg_x = _equalize_square_pads(v64, pos, w0, nseg_x,
                                                     tile_groups)
    hi, lo = ds_from_f64(v64)

    def put(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)

    return WellDsMatrix(values_hi=put(hi), values_lo=put(lo), pos=put(pos),
                        w0=put(w0), nrows=a.nrows, ncols=a.ncols, wseg=wseg,
                        tile_groups=tile_groups, nseg=nseg_x, _nnz=a.nnz,
                        paired=paired)


def spmv_well_ds_stacked_plain(values_hi: torch.Tensor, values_lo: torch.Tensor,
                               pos: torch.Tensor, w0: torch.Tensor,
                               xh2: torch.Tensor, xl2: torch.Tensor,
                               tile_groups: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """D stacked DS WELL blocks: values hi/lo and pos (D, K, G, 128), w0
    (D, G/tg), x hi/lo (D*col_pad/128, 128) -> (yh, yl), each (D*G, 128)."""
    nd, k, g, _ = values_hi.shape
    xhs, xls = xh2.reshape(nd, -1), xl2.reshape(nd, -1)
    base = (w0.to(torch.int64) * LANES).repeat_interleave(
        tile_groups * LANES, dim=1)  # (D, G*128)
    acc_h = xh2.new_zeros((nd, g * LANES))
    acc_l = xh2.new_zeros((nd, g * LANES))
    for kk in range(k):
        idx = base + pos[:, kk].reshape(nd, -1).to(torch.int64)
        ph, plo = ds_mul_f32(values_hi[:, kk].reshape(nd, -1),
                             values_lo[:, kk].reshape(nd, -1),
                             torch.gather(xhs, 1, idx), torch.gather(xls, 1, idx))
        acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
    return acc_h.view(nd * g, LANES), acc_l.view(nd * g, LANES)


def spmv_well_ds_2d(a: WellDsMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-single SpMV in the lane layout: (hi, lo) x pair
    (ncols_pad/128, 128) -> (hi, lo) y pair (nrows_pad/128, 128)."""
    from spmv_torch.ops.spmv_well_ds_cuda import spmv_well_ds_stacked

    return spmv_well_ds_stacked(
        a.values_hi.unsqueeze(0), a.values_lo.unsqueeze(0), a.pos.unsqueeze(0),
        a.w0.unsqueeze(0), xh2, xl2, a.tile_groups)


def spmv_well_ds(a: WellDsMatrix, x) -> np.ndarray:
    """Convenience: float64 vector in, float64 vector out (length
    nrows_pad). Conversions happen on the host."""
    xv = np.zeros(a.ncols_pad, dtype=np.float64)
    n = min(len(x), a.ncols_pad)
    xv[:n] = np.asarray(x, dtype=np.float64)[:n]
    hi, lo = ds_from_f64(xv)
    yh, yl = spmv_well_ds_2d(
        a, torch.as_tensor(hi.reshape(-1, LANES), device=a.device),
        torch.as_tensor(lo.reshape(-1, LANES), device=a.device))
    return ds_to_f64(yh.cpu().numpy().reshape(-1), yl.cpu().numpy().reshape(-1))
