"""Double-single (float64-class) DIA: the container, the packer and the
plain torch apply.

Counterpart of ``spmv_tpu.ops.spmv_dia_ds_pallas`` (``DiaDsMatrix``,
``csr_to_dia_ds``, ``spmv_dia_ds_xla``, ``spmv_dia_ds``, and the block
``spmm_dia_ds_xla`` as ``spmm_dia_ds_stacked_plain``). The matrix and
the vectors are hi/lo float32 pairs (``spmv_torch.ds``); every diagonal's
term is ``ds_mul_f32`` then ``ds_add`` into the accumulator, in offset
order, with x zero outside each shard.

``spmv_dia_ds_stacked_plain`` is the plain version of the CUDA kernel
(``ops/spmv_dia_ds_cuda.py``): the CPU path and the card's oracle for the
kernel. The entry points go through the wrapper, which takes the plain
version on a CPU tensor and launches the kernel on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64, ds_mul_f32, ds_to_f64
from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES, _csr_to_dia_host, flat_to_interleaved
from spmv_torch.ops.spmm_dia import columns, from_columns


@dataclasses.dataclass
class DiaDsMatrix:
    """DIA matrix in double-single storage: two interleaved float32 planes
    in the ``DiaMatrix.data`` layout, (nrows_pad/128, K*128) each."""

    data_hi: torch.Tensor
    data_lo: torch.Tensor
    offsets: tuple[int, ...]
    nrows: int
    ncols: int
    _nnz: int = 0

    @property
    def nrows_pad(self) -> int:
        return self.data_hi.shape[0] * LANES

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def device(self) -> torch.device:
        return self.data_hi.device

    def format_size_bytes(self) -> int:
        return 2 * self.data_hi.numel() * 4


def csr_to_dia_ds(a: CSRHost, row_align: int = 128, max_diags: int = 64, *,
                  device="cuda") -> DiaDsMatrix:
    """Convert a float64 host CSR to double-single DIA on ``device`` (the
    card unless the caller asks for another). The split stays in numpy
    until upload."""
    flat, offsets, nnz = _csr_to_dia_host(a, row_align, max_diags, np.float64,
                                          symmetric=False)
    hi, lo = ds_from_f64(flat)
    k = flat.shape[0]

    def put(arr):
        return torch.as_tensor(np.ascontiguousarray(flat_to_interleaved(arr, k)),
                               device=device)

    return DiaDsMatrix(data_hi=put(hi), data_lo=put(lo), offsets=offsets,
                       nrows=a.nrows, ncols=a.ncols, _nnz=nnz)


def spmv_dia_ds_stacked_plain(data_hi: torch.Tensor, data_lo: torch.Tensor,
                              xh2: torch.Tensor, xl2: torch.Tensor,
                              offsets: tuple[int, ...]
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """D stacked DS DIA blocks: data hi/lo (D, R, K*128), x hi/lo
    (D*R, 128) -> (yh, yl), each (D*R, 128). Shard s reads only its own
    R*128 entries of x; x is zero outside them."""
    nd, nr = data_hi.shape[0], data_hi.shape[1]
    npad = nr * LANES
    k = len(offsets)
    omin, omax = min(min(offsets), 0), max(max(offsets), 0)

    def window(x2):
        xw = x2.new_zeros((nd, npad + omax - omin))
        xw[:, -omin: -omin + npad] = x2.view(nd, npad)
        return xw

    xwh, xwl = window(xh2), window(xl2)
    dh3 = data_hi.view(nd, nr, k, LANES)
    dl3 = data_lo.view(nd, nr, k, LANES)
    acc_h = xh2.new_zeros((nd, npad))
    acc_l = xh2.new_zeros((nd, npad))
    for kk, off in enumerate(offsets):
        sl = slice(off - omin, off - omin + npad)
        ph, plo = ds_mul_f32(dh3[:, :, kk, :].reshape(nd, npad),
                             dl3[:, :, kk, :].reshape(nd, npad),
                             xwh[:, sl], xwl[:, sl])
        acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
    return acc_h.view(nd * nr, LANES), acc_l.view(nd * nr, LANES)


def spmm_dia_ds_stacked_plain(data_hi: torch.Tensor, data_lo: torch.Tensor,
                              xh2: torch.Tensor, xl2: torch.Tensor,
                              offsets: tuple[int, ...]
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The DS block apply (the reference's ``spmm_dia_ds_xla``, :541): the
    single-RHS DS apply on each column of the SpMM lane layout, data hi/lo
    (D, R, K*128), x hi/lo (D*R, nrhs*128) -> (yh, yl) (D*R, nrhs*128). The
    plain version of the ``dia_ds_spmm`` kernel."""
    outs = [spmv_dia_ds_stacked_plain(data_hi, data_lo, h, lo, offsets)
            for h, lo in zip(columns(xh2), columns(xl2))]
    return from_columns([o[0] for o in outs]), from_columns([o[1] for o in outs])


def spmm_dia_ds_2d(a: DiaDsMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-single block apply in the SpMM lane layout: (hi, lo) x blocks
    (nrows_pad/128, nrhs*128) -> (hi, lo) y blocks, both matrix planes read
    once for the block."""
    from spmv_torch.ops.spmv_dia_ds_cuda import spmm_dia_ds_stacked

    return spmm_dia_ds_stacked(a.data_hi.unsqueeze(0), a.data_lo.unsqueeze(0),
                               xh2, xl2, a.offsets)


def spmv_dia_ds_2d(a: DiaDsMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Double-single SpMV in the lane layout: (hi, lo) x pair
    (nrows_pad/128, 128) -> (hi, lo) y pair."""
    from spmv_torch.ops.spmv_dia_ds_cuda import spmv_dia_ds_stacked

    return spmv_dia_ds_stacked(a.data_hi.unsqueeze(0), a.data_lo.unsqueeze(0),
                               xh2, xl2, a.offsets)


def spmv_dia_ds(a: DiaDsMatrix, x) -> np.ndarray:
    """Convenience: float64 vector in, float64 vector out (length
    nrows_pad). The split and the recombination happen on the host; hot
    loops keep (hi, lo) pairs and call ``spmv_dia_ds_2d``."""
    npad = a.nrows_pad
    xv = np.zeros(npad, dtype=np.float64)
    n = min(len(x), npad)
    xv[:n] = np.asarray(x, dtype=np.float64)[:n]
    hi, lo = ds_from_f64(xv)
    yh, yl = spmv_dia_ds_2d(
        a, torch.as_tensor(hi.reshape(-1, LANES), device=a.device),
        torch.as_tensor(lo.reshape(-1, LANES), device=a.device))
    return ds_to_f64(yh.cpu().numpy().reshape(-1), yl.cpu().numpy().reshape(-1))
