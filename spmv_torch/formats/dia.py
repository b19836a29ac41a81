"""DIA (diagonal) device format — the stencil/banded fast path.

Counterpart of ``spmv_tpu.formats.dia``. The packer is the reference's
numpy packer carried across, so ``csr_to_dia`` gives the reference's arrays
bit for bit; only the container changes (a torch tensor on an explicit
device in place of a jax array).

data[r, k*128 + l] = A[128r + l, 128r + l + offsets[k]]  (zero where the
column falls outside). On a GPU, a thread-per-row read of this layout is
coalesced: lane l of row-tile r is contiguous across l.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost

LANES = 128


def host_dtype(dtype) -> np.dtype | None:
    """The numpy dtype for a numpy or torch dtype (None passes through)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal-format matrix on a torch device.

    data:    (nrows_pad // 128, ndiags * 128) — row-interleaved lane layout:
             data[r, d*128 + l] = A[128r + l, 128r + l + offsets[d]].
    offsets: diagonal offsets (j - i), ascending
    symmetric: offsets <= 0 only; A = L + D + L^T implied
    """

    data: torch.Tensor
    offsets: tuple[int, ...]
    nrows: int
    ncols: int
    symmetric: bool = False
    _nnz: int = 0

    @property
    def nrows_pad(self) -> int:
        return self.data.shape[0] * LANES

    @property
    def data_flat(self) -> torch.Tensor:
        """(ndiags, nrows_pad) logical view. Materializes a de-interleaved
        copy; for inspection and tests, not for hot loops."""
        return interleaved_to_flat(self.data, self.ndiags)

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz_stored(self) -> int:
        return int(self._nnz)

    def format_size_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flat_to_interleaved(flat, k: int):
    """(K, npad) per-diagonal rows -> the (npad/128, K*128) device layout.
    Works on numpy arrays and torch tensors."""
    npad = flat.shape[1]
    blocks = flat.reshape(k, npad // LANES, LANES)
    blocks = (blocks.permute(1, 0, 2) if isinstance(blocks, torch.Tensor)
              else blocks.transpose(1, 0, 2))
    return blocks.reshape(npad // LANES, k * LANES)


def interleaved_to_flat(data, k: int):
    """Inverse of ``flat_to_interleaved``: (npad/128, K*128) -> (K, npad)."""
    r = data.shape[0]
    blocks = data.reshape(r, k, LANES)
    blocks = (blocks.permute(1, 0, 2) if isinstance(blocks, torch.Tensor)
              else blocks.transpose(1, 0, 2))
    return blocks.reshape(k, r * LANES)


def shift_transpose(flat: torch.Tensor, offsets: tuple[int, ...]
                    ) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The transpose of square DIA data given as (..., K, npad) per-diagonal
    rows: offset o becomes -o (ascending again) and its row shifts by o, so
    flatT[..., d', i] = flat[..., d, i + o'] for o = -o' (zero where i + o'
    falls outside). Leading axes (stacked shards) shift together."""
    offsets_t = tuple(-o for o in reversed(offsets))
    rows = []
    for o_new in offsets_t:
        row = flat[..., offsets.index(-o_new), :]
        if o_new > 0:
            row = torch.cat([row[..., o_new:], row.new_zeros((*row.shape[:-1], o_new))],
                            dim=-1)
        elif o_new < 0:
            row = torch.cat([row.new_zeros((*row.shape[:-1], -o_new)), row[..., :o_new]],
                            dim=-1)
        rows.append(row)
    return torch.stack(rows, dim=-2), offsets_t


def dia_transpose(a: DiaMatrix) -> DiaMatrix:
    """A^T as a DiaMatrix (the reference's ``dia_transpose``): the diagonal
    of offset o becomes offset -o with the same data shifted by o rows, one
    pass over the data. Symmetric-stored matrices are their own transpose
    and are returned as they are; a non-square matrix raises."""
    if a.symmetric:
        return a
    if a.nrows != a.ncols:
        raise ValueError("dia_transpose requires a square matrix")
    flat_t, offsets_t = shift_transpose(a.data_flat, a.offsets)
    return DiaMatrix(
        data=flat_to_interleaved(flat_t, a.ndiags).contiguous(),
        offsets=offsets_t,
        nrows=a.ncols,
        ncols=a.nrows,
        symmetric=False,
        _nnz=a._nnz,
    )


def csr_to_dia(
    a: CSRHost,
    row_align: int = 128,
    max_diags: int = 64,
    dtype=None,
    symmetric: bool = False,
    *,
    device="cuda",
) -> DiaMatrix:
    """Convert host CSR to DIA on ``device`` (the card unless the caller asks
    for another); ``dtype`` may be ``torch.bfloat16`` (values rounded once
    from float32). Raises if the matrix has more
    than ``max_diags`` distinct diagonals. Rows pad to a multiple of 128
    (the lane layout of ``DiaMatrix.data``).

    With ``symmetric=True`` (input must be structurally and numerically
    symmetric), only diagonals with offset <= 0 are stored; the transpose
    of diagonal o is diagonal -o with the same data shifted by -o.
    """
    # numpy has no bfloat16: pack in float32 and round once on the way out
    bf16 = dtype == torch.bfloat16
    flat, offsets, nnz = _csr_to_dia_host(a, row_align, max_diags,
                                          np.float32 if bf16 else dtype,
                                          symmetric)
    data = torch.as_tensor(np.ascontiguousarray(
        flat_to_interleaved(flat, flat.shape[0])), device=device)
    return DiaMatrix(
        data=data.to(torch.bfloat16) if bf16 else data,
        offsets=offsets,
        nrows=a.nrows,
        ncols=a.ncols,
        symmetric=symmetric,
        _nnz=nnz,
    )


def _csr_to_dia_host(a, row_align, max_diags, dtype, symmetric):
    """Host-side DIA pack: (data (K, nrows_pad) numpy, offsets, stored nnz).
    The numpy tier of ``spmv_tpu.formats.dia._csr_to_dia_host``."""
    row_align = max(_round_up(row_align, LANES), LANES)
    if a.nrows > 1_000_000:
        # the reference's tile-divisor guarantee for its TPU kernel; kept so
        # the packed arrays (and their padding) match the reference
        row_align = max(row_align, 1024 * LANES)
    lens = a.row_nnz()
    # int32 row/offset math (nrows/ncols < 2^31 always holds here)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int32), lens)
    offs = a.colind - rows
    vals_all = a.values
    if symmetric:
        keep = offs <= 0
        rows, offs, vals_all = rows[keep], offs[keep], vals_all[keep]
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        raise ValueError(
            f"matrix has {len(uniq)} distinct diagonals > max_diags={max_diags}; "
            "use ELL format"
        )
    nrows_pad = max(_round_up(a.nrows, row_align), row_align)
    ndiags = max(len(uniq), 1)
    data = np.zeros((ndiags, nrows_pad), dtype=host_dtype(dtype) or a.dtype)
    if len(rows):
        dsel = np.searchsorted(uniq, offs)
        if ndiags * nrows_pad < 2**31 - 1:
            flat = dsel.astype(np.int32) * np.int32(nrows_pad) + rows
        else:
            flat = dsel * np.int64(nrows_pad) + rows.astype(np.int64)
        # canonical CSR (columns strictly increasing within each row) has no
        # duplicate (row, offset) pairs, so a direct assign suffices;
        # non-canonical inputs accumulate so duplicate entries still SUM
        canonical = getattr(a, "_sorted_unique", False)
        if not canonical:
            cols_f = rows + offs
            same_row = rows[1:] == rows[:-1]
            canonical = not bool(np.any((np.diff(cols_f) <= 0) & same_row))
        if canonical:
            data.reshape(-1)[flat] = vals_all.astype(data.dtype, copy=False)
        else:
            acc = np.bincount(
                flat, weights=vals_all, minlength=ndiags * nrows_pad
            )
            data[:] = acc.reshape(ndiags, nrows_pad).astype(data.dtype)
    return data, tuple(int(o) for o in uniq) or (0,), int(len(rows))
