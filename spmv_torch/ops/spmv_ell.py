"""ELL SpMV: y = alpha * A @ x + beta * y, and the transpose A^T x.

Counterpart of ``spmv_tpu.ops.spmv_ell`` (``spmv_ell`` :31,
``spmv_ell_transpose`` :65). The reference computes these in XLA outside
any Pallas kernel, so plain torch gathers are the port: a gather of x by
the column rectangle and a row sum. The reference's scatter-adds (the
symmetric L^T term, :59, and the transpose, :78) become gathers over the
transpose rectangle built on the host at packing time (``formats/ell.py``),
so no apply sums with atomics and an apply gives the same bits on every
run.

Semantics follow SubMatrix::mult(alpha, in, beta, out) of LIBSPMV.
Outputs are padded to ``a.nrows_pad``; rows >= a.nrows receive alpha * 0
(+ beta * y's padding).
"""
from __future__ import annotations

import torch

from spmv_torch.formats.ell import EllMatrix


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        return x[:n]
    return torch.nn.functional.pad(x, (0, n - x.shape[0]))


def _gather_rows(colind: torch.Tensor, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (values * x[colind]).sum(dim=1)


def spmv_ell(
    a: EllMatrix,
    x: torch.Tensor,
    alpha=1.0,
    beta=0.0,
    y: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a (possibly symmetric-stored) ELL matrix. ``x`` must have
    length >= a.ncols (a padded tail beyond ncols is ignored). Returns a
    vector of length a.nrows_pad."""
    ax = _gather_rows(a.colind, a.values, x)
    if a.symmetric:
        # A = L + D + L^T with only L in a.values: the D term and the L^T
        # term as a gather over the host-built transpose rectangle
        xr = _pad_to(x, a.nrows_pad)
        ax = ax + a.diagonal * xr + _gather_rows(a.colindT, a.valuesT, xr)
    if y is None:
        return alpha * ax
    return alpha * ax + beta * _pad_to(y, a.nrows_pad)


def spmv_ell_transpose(a: EllMatrix, x: torch.Tensor, out_size: int | None = None
                       ) -> torch.Tensor:
    """y = A^T @ x for non-symmetric ELL. Returns a vector of length
    ``out_size`` (default a.ncols rounded up to a multiple of 8); entries
    past a.ncols are zero."""
    if a.symmetric:
        raise ValueError("symmetric-stored matrices are self-transpose; use spmv_ell")
    n = out_size if out_size is not None else -(-a.ncols // 8) * 8
    yt = _gather_rows(a.colindT, a.valuesT, _pad_to(x, a.nrows_pad))
    return _pad_to(yt, n)
