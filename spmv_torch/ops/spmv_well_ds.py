"""Double-single (float64-class) WELL: the container, the packer and the
plain torch apply.

Counterpart of the double-single part of ``spmv_tpu.ops.spmv_well_pallas``
(``WellDsMatrix``, ``csr_to_well_ds``, ``spmv_well_ds``). One packing, two
float32 value planes (``spmv_torch.ds``); the split stays in numpy until
upload. Each slot's term is ``ds_mul_f32`` of the values and the gathered
x pair, accumulated with ``ds_add`` for k = 0..K-1 in order.

``spmv_well_ds_rows_plain`` is the plain version of the CUDA kernel
(``ops/spmv_well_ds_cuda.py``), which reads the stack's row lists
(``formats/well.pack_rows``, both value planes): the CPU path and the
card's oracle for the kernel. ``spmv_well_ds_stacked_plain`` applies the
WELL formula itself and equals it bit for bit (the same terms per row in
the same order; a padded term adds an exact (0, 0)). The entry points go
through the wrapper, which takes the plain version on a CPU tensor and
launches the kernel on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64, ds_mul_f32, ds_to_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.well import (
    LANES,
    SLICE,
    _build_arrays,
    _equalize_square_pads,
    pack_rows,
)
from spmv_torch.ops.spmv_well import row_slots


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
    # the row lists (formats/well.pack_rows) the kernels read
    rows_values_hi: torch.Tensor | None = None  # (E,)
    rows_values_lo: torch.Tensor | None = None
    rows_pos: torch.Tensor | None = None        # (E,) int16/int32
    slice_ptr: torch.Tensor | None = None       # (G*4 + 1,) int64

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
    rows = pack_rows(hi[None], pos[None], wseg, values_lo=lo[None])

    def put(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)

    return WellDsMatrix(values_hi=put(hi), values_lo=put(lo), pos=put(pos),
                        w0=put(w0), nrows=a.nrows, ncols=a.ncols, wseg=wseg,
                        tile_groups=tile_groups, nseg=nseg_x, _nnz=a.nnz,
                        paired=paired, rows_values_hi=put(rows.values[0]),
                        rows_values_lo=put(rows.values_lo[0]),
                        rows_pos=put(rows.pos[0]), slice_ptr=put(rows.slice_ptr[0]))


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


def spmv_well_ds_rows_plain(values_hi: torch.Tensor, values_lo: torch.Tensor,
                            pos: torch.Tensor, slice_ptr: torch.Tensor,
                            w0: torch.Tensor, xh2: torch.Tensor, xl2: torch.Tensor,
                            tile_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """D stacked DS row lists: values hi/lo and pos (D, E), slice_ptr
    (D, S+1), w0 (D, S/4/tg), x hi/lo (D*col_pad/128, 128) -> (yh, yl),
    each (D*S/4, 128). Rows past their slice's width keep their sum."""
    nd = values_hi.shape[0]
    xhs, xls = xh2.reshape(nd, -1), xl2.reshape(nd, -1)
    first, width, base, wmax = row_slots(slice_ptr, w0, tile_groups)
    acc_h, acc_l = xh2.new_zeros(first.shape), xh2.new_zeros(first.shape)
    for j in range(wmax):
        live = width > j
        e = torch.where(live, first + SLICE * j, 0)
        idx = base + torch.gather(pos, 1, e).to(torch.int64)
        ph, plo = ds_mul_f32(torch.gather(values_hi, 1, e), torch.gather(values_lo, 1, e),
                             torch.gather(xhs, 1, idx), torch.gather(xls, 1, idx))
        sh, sl = ds_add(acc_h, acc_l, ph, plo)
        acc_h, acc_l = torch.where(live, sh, acc_h), torch.where(live, sl, acc_l)
    return acc_h.view(-1, LANES), acc_l.view(-1, LANES)


def spmv_well_ds_2d(a: WellDsMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-single SpMV in the lane layout: (hi, lo) x pair
    (ncols_pad/128, 128) -> (hi, lo) y pair (nrows_pad/128, 128)."""
    from spmv_torch.ops.spmv_well_ds_cuda import spmv_well_ds_stacked

    return spmv_well_ds_stacked(
        a.rows_values_hi.unsqueeze(0), a.rows_values_lo.unsqueeze(0),
        a.rows_pos.unsqueeze(0), a.slice_ptr.unsqueeze(0), a.w0.unsqueeze(0),
        xh2, xl2, a.tile_groups)


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
