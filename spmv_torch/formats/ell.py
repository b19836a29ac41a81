"""Padded ELLPACK — the standalone general-sparsity format.

Counterpart of ``spmv_tpu.formats.ell`` (``EllMatrix`` :26, ``csr_to_ell``
:113). ELL stores a (nrows_pad, K) rectangle of column indices and values,
K = max nnz/row (optionally rounded up); short rows pad with (col 0,
value 0). The apply (``ops/spmv_ell.py``) is a gather and a row sum.

The reference applies the symmetric L^T term and the transpose A^T x as
scatter-adds, which sum with atomics on the card in an order that varies
from run to run. Here both are built on the host at packing time as ELL
gathers of their own (``formats/csr.ell_transpose``, each row's entries in
ascending source row), as ``DistMatrix`` builds its transpose terms:
``colindT``/``valuesT`` hold L^T (symmetric storage) or A^T (otherwise).
Only the numpy packer is carried across; the reference's C++ packer
(``_pack_ell_native`` :85) waits for the native host tier (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost, ell_transpose


@dataclasses.dataclass
class EllMatrix:
    """Padded ELLPACK matrix on a torch device.

    colind: (nrows_pad, K) int64 — padded slots point at column 0
    values: (nrows_pad, K)       — padded slots hold 0
    diagonal: (nrows_pad,) dense diagonal, present iff symmetric storage
              (values then holds only the strict lower triangle)
    colindT/valuesT: the transpose term as an ELL gather, built on the
              host: (nrows_pad, K') rows of L^T (symmetric storage) or
              (ncols, K') rows of A^T; each entry indexes a source row
    nrows/ncols: logical (unpadded) dimensions
    symmetric: whether this stores L of A = L + D + L^T
    """

    colind: torch.Tensor
    values: torch.Tensor
    nrows: int
    ncols: int
    symmetric: bool = False
    diagonal: torch.Tensor | None = None
    colindT: torch.Tensor | None = None
    valuesT: torch.Tensor | None = None
    _nnz: int = 0

    @property
    def k(self) -> int:
        return self.colind.shape[1]

    @property
    def nrows_pad(self) -> int:
        return self.colind.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nnz_stored(self) -> int:
        """Stored nonzeros (padding excluded; the lower triangle only when
        symmetric, as the reference counts them)."""
        return int(self._nnz)

    def format_size_bytes(self) -> int:
        """Bytes of device storage actually held: the padded rectangle, the
        diagonal and the host-built transpose term."""
        return sum(t.numel() * t.element_size()
                   for t in (self.colind, self.values, self.diagonal, self.colindT,
                             self.valuesT) if t is not None)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def csr_to_ell(
    a: CSRHost,
    row_align: int = 8,
    k_align: int = 1,
    dtype=None,
    symmetric: bool = False,
    *,
    device="cuda",
) -> EllMatrix:
    """Convert host CSR to padded ELL on ``device`` (the card unless the
    caller asks for another): vectorized numpy, then one upload.

    With ``symmetric=True``, stores only the strict lower triangle plus a
    dense diagonal; ``a`` must then be structurally symmetric. The arrays
    (colind, values, diagonal) equal the reference's; the transpose term
    is the port's own (module docstring)."""
    diag = None
    nnz_logical = a.nnz
    if symmetric:
        a, diag_np = a.split_lower_diag()
        nnz_logical = a.nnz  # the lower-triangle count, as the reference's
    nrows_pad = max(_round_up(a.nrows, row_align), row_align)
    lens = a.row_nnz()
    k = max(int(lens.max()) if a.nrows else 1, 1)
    k = max(_round_up(k, k_align), k_align)

    colind = np.zeros((nrows_pad, k), dtype=np.int64)
    values = np.zeros((nrows_pad, k), dtype=dtype or a.dtype)
    if a.nnz:
        rows = np.repeat(np.arange(a.nrows), lens)
        slot = np.arange(a.nnz) - np.repeat(a.rowptr[:-1], lens)
        colind[rows, slot] = a.colind
        values[rows, slot] = a.values
    if symmetric:
        diag = np.zeros(nrows_pad, dtype=values.dtype)
        diag[: len(diag_np)] = diag_np
    # L^T over nrows_pad rows (symmetric: L's columns index its rows), or
    # A^T over ncols rows
    colT, valT = ell_transpose(colind[None], values[None],
                               nrows_pad if symmetric else a.ncols)

    def put(arr):
        return None if arr is None else torch.as_tensor(arr, device=device)

    return EllMatrix(
        colind=put(colind),
        values=put(values),
        nrows=a.nrows,
        ncols=a.ncols,
        symmetric=symmetric,
        diagonal=put(diag),
        colindT=put(colT[0]),
        valuesT=put(valT[0]),
        _nnz=int(nnz_logical),
    )
