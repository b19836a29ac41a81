"""Ecosystem interop: scipy.sparse and torch.sparse bridges.

Counterpart of ``spmv_tpu.interop``. LIBSPMV's interop boundary is Eigen;
here, as in the reference, it is scipy.sparse (the host staging format
everyone has), and torch's sparse COO and CSR tensors take the place of
jax's BCOO. Every bridge goes to or from :class:`CSRHost`, the import
format all device formats convert from.

``from_scipy`` copies the caller's matrix before canonicalizing it. The
reference's ``from_scipy`` aliases the caller's CSR arrays and sums
duplicates in place, so a later in-place edit of the caller's matrix would
reach a CSRHost flagged canonical (ROADMAP.md §3, deviations).

scipy is imported at call time.
"""
from __future__ import annotations

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost

__all__ = ["from_scipy", "to_scipy", "from_torch_sparse", "to_torch_sparse"]


def from_scipy(m) -> CSRHost:
    """Convert any 2-D ``scipy.sparse`` matrix or array (csr, csc, coo, lil,
    dok, dia, bsr) to :class:`CSRHost`: duplicates summed, columns sorted
    within each row. The caller's matrix is left as it was and shares no
    buffer with the result."""
    import scipy.sparse as sp

    if not sp.issparse(m):
        raise TypeError(f"expected a scipy.sparse matrix, got {type(m)!r}")
    if m.ndim != 2:
        raise ValueError(f"expected a 2-D sparse matrix, got shape {m.shape}")
    c = m.tocsr(copy=True)
    c.sum_duplicates()  # also sorts the indices
    out = CSRHost(
        rowptr=np.array(c.indptr, dtype=np.int64),
        colind=np.array(c.indices, dtype=np.int32),
        values=np.array(c.data),
        ncols=int(c.shape[1]),
    )
    out._sorted_unique = True
    return out


def to_scipy(a: CSRHost):
    """Convert a :class:`CSRHost` to ``scipy.sparse.csr_array`` (a copy)."""
    import scipy.sparse as sp

    return sp.csr_array(
        (a.values.copy(), a.colind.astype(np.int64), a.rowptr.astype(np.int64)),
        shape=a.shape,
    )


def from_torch_sparse(t: torch.Tensor) -> CSRHost:
    """Convert a 2-D torch sparse COO or CSR tensor to :class:`CSRHost`.

    Batched tensors and hybrid ones (dense trailing dimensions) are refused.
    Duplicate indices are summed; entries outside the shape (padding) are
    dropped."""
    if not isinstance(t, torch.Tensor) or t.layout not in (torch.sparse_coo,
                                                           torch.sparse_csr):
        raise TypeError(f"expected a torch sparse COO or CSR tensor, got "
                        f"{getattr(t, 'layout', type(t))!r}")
    if t.layout == torch.sparse_csr:
        n_batch = t.crow_indices().ndim - 1
        n_dense = t.values().ndim - 1 - n_batch
        if n_batch or n_dense or t.ndim != 2:
            raise ValueError(
                "only plain 2-D sparse tensors (n_batch=0, n_dense=0) are "
                f"supported; got shape {tuple(t.shape)}, n_batch={n_batch}, "
                f"n_dense={n_dense}")
        crow = t.crow_indices().cpu().numpy()
        rows = np.repeat(np.arange(t.shape[0], dtype=np.int64), np.diff(crow))
        cols = t.col_indices().cpu().numpy().astype(np.int64)
    else:
        if t.sparse_dim() != 2 or t.dense_dim() or t.ndim != 2:
            raise ValueError(
                "only plain 2-D sparse tensors (n_batch=0, n_dense=0) are "
                f"supported; got shape {tuple(t.shape)}, sparse_dim="
                f"{t.sparse_dim()}, n_dense={t.dense_dim()}")
        # the raw entries: an uncoalesced tensor keeps its duplicates there
        idx = t._indices().cpu().numpy().astype(np.int64)
        rows, cols = idx[0], idx[1]
    vals = (t._values() if t.layout == torch.sparse_coo else t.values()).detach().cpu().numpy()
    nrows, ncols = int(t.shape[0]), int(t.shape[1])
    keep = (rows >= 0) & (rows < nrows) & (cols >= 0) & (cols < ncols)
    return CSRHost.from_coo(rows[keep], cols[keep], vals[keep], nrows, ncols)


def to_torch_sparse(a: CSRHost, layout=torch.sparse_csr, *, device="cuda") -> torch.Tensor:
    """Convert a :class:`CSRHost` to a torch sparse tensor on ``device``
    (the card unless the caller asks for another): ``layout``
    ``torch.sparse_csr`` (default) or ``torch.sparse_coo`` (coalesced)."""
    vals = torch.as_tensor(a.values.copy())
    if layout == torch.sparse_csr:
        t = torch.sparse_csr_tensor(torch.as_tensor(a.rowptr.astype(np.int64)),
                                    torch.as_tensor(a.colind.astype(np.int64)), vals,
                                    size=a.shape, check_invariants=True)
    elif layout == torch.sparse_coo:
        rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
        idx = torch.as_tensor(np.stack([rows, a.colind.astype(np.int64)]))
        t = torch.sparse_coo_tensor(idx, vals, size=a.shape,
                                    check_invariants=True).coalesce()
    else:
        raise ValueError(f"layout must be torch.sparse_csr or torch.sparse_coo, got {layout}")
    return t.to(device)
