"""1-D row-block partitioning + ghost discovery (host side, numpy).

Carried across from ``spmv_tpu.parallel.partition``: each shard owns a
contiguous global row range (near-equal chunking); any column outside the
owned range is a ghost. Columns are renumbered into local + ghost-list
numbering with vectorized numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from spmv_torch.formats.csr import CSRHost


def owner_ranges(global_size: int, num_shards: int) -> np.ndarray:
    """Near-equal contiguous ranges: (num_shards+1,) int64 prefix array; the
    first ``global_size % num_shards`` shards get one extra row."""
    base, rem = divmod(global_size, num_shards)
    sizes = np.full(num_shards, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def owner_of(ranges: np.ndarray, global_idx: np.ndarray) -> np.ndarray:
    """Owning shard of each global index (vectorized upper_bound)."""
    return np.searchsorted(ranges, np.asarray(global_idx), side="right") - 1


@dataclasses.dataclass
class ShardCSR:
    """One shard's rows in local column numbering.

    local:       CSR block whose columns are owned locals [0, nlocal)
    remote:      CSR block whose columns index the ghost list [0, nghosts)
    ghosts:      sorted global column indices of ghosts
    row_range:   (r0, r1) owned global rows
    col_range:   (c0, c1) owned global cols
    diagonal:    dense diagonal (present only when symmetric)
    symmetric:   lower-triangle-only storage active
    """

    local: CSRHost
    remote: CSRHost
    ghosts: np.ndarray
    row_range: tuple[int, int]
    col_range: tuple[int, int]
    diagonal: np.ndarray | None = None
    symmetric: bool = False

    @property
    def nlocal(self) -> int:
        return self.row_range[1] - self.row_range[0]

    @property
    def nghosts(self) -> int:
        return len(self.ghosts)


def classify_shard(
    rowptr: np.ndarray,
    cols_g: np.ndarray,
    vals: np.ndarray,
    row_range: tuple[int, int],
    col_range: tuple[int, int],
    symmetric: bool = False,
) -> ShardCSR:
    """Classify one shard's canonical CSR slice (local ``rowptr``, GLOBAL
    columns ascending within each row) into the local/remote blocks + ghost
    list + (symmetric) diagonal.

    With ``symmetric=True`` (requires col_range == row_range), only entries
    with global col <= global row are kept: the in-range strict lower
    triangle goes to ``local``, the diagonal to ``diagonal``, out-of-range
    entries to ``remote``. Masked subsequences of a canonical slice stay
    canonical, so both blocks are built with boolean masks and prefix sums
    and no sort.
    """
    r0, r1 = row_range
    c0, c1 = col_range
    nloc = r1 - r0
    rowptr = np.asarray(rowptr, dtype=np.int64)
    cols_g = np.asarray(cols_g, dtype=np.int64)
    diag = None
    if symmetric:
        if (c0, c1) != (r0, r1):
            raise ValueError("symmetric storage requires row/col "
                             "partitions to coincide (square matrix)")
        rows_l = np.repeat(np.arange(nloc, dtype=np.int64), np.diff(rowptr))
        rows_g = rows_l + r0
        on_diag = cols_g == rows_g
        diag = np.zeros(nloc, dtype=vals.dtype)
        diag[rows_l[on_diag]] = vals[on_diag]
        keep = cols_g < rows_g  # strict lower triangle only
        cs = np.zeros(len(cols_g) + 1, np.int64)
        cs[1:] = np.cumsum(keep)
        rowptr = cs[rowptr]
        cols_g, vals = cols_g[keep], vals[keep]
    is_local = (cols_g >= c0) & (cols_g < c1)
    cs = np.zeros(len(cols_g) + 1, np.int64)
    cs[1:] = np.cumsum(is_local)
    loc_ptr = cs[rowptr]
    local = CSRHost(loc_ptr, cols_g[is_local] - c0, vals[is_local],
                    max(c1 - c0, 1))
    rem_cols = cols_g[~is_local]
    ghosts = np.unique(rem_cols)
    remote = CSRHost(rowptr - loc_ptr, np.searchsorted(ghosts, rem_cols),
                     vals[~is_local], max(len(ghosts), 1))
    local._sorted_unique = True
    remote._sorted_unique = True
    return ShardCSR(
        local=local, remote=remote, ghosts=ghosts,
        row_range=(r0, r1), col_range=(c0, c1),
        diagonal=diag, symmetric=symmetric,
    )


def _canonical(a: CSRHost) -> bool:
    """Columns strictly ascending within every row, as ``from_coo`` would
    leave them: one pass over the column indices."""
    if a.nnz < 2:
        return True
    ascending = np.diff(a.colind) > 0  # colind < 2^31: the steps fit its type
    # a step into an entry that begins a row may descend
    begins = a.rowptr[1:-1]
    ascending[begins[(begins > 0) & (begins < a.nnz)] - 1] = True
    return bool(ascending.all())


def partition_csr(
    a: CSRHost,
    num_shards: int,
    symmetric: bool = False,
) -> list[ShardCSR]:
    """Split a global CSR into row-block shards with local/remote column
    separation. Rectangular matrices partition rows and columns
    independently; ``symmetric=True`` requires square. A CSR that is not
    canonical (unsorted columns or duplicate entries) is first rebuilt
    through ``CSRHost.from_coo``, which sorts and sums duplicates; one that
    is, flagged or not, is taken as it is."""
    if not (getattr(a, "_sorted_unique", False) or _canonical(a)):
        rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
        a = CSRHost.from_coo(rows, a.colind, a.values, a.nrows, a.ncols)
    row_ranges = owner_ranges(a.nrows, num_shards)
    col_ranges = (row_ranges if a.nrows == a.ncols
                  else owner_ranges(a.ncols, num_shards))
    shards = []
    for s in range(num_shards):
        r0, r1 = int(row_ranges[s]), int(row_ranges[s + 1])
        rows_slice = a.extract_rows(r0, r1)
        shards.append(classify_shard(
            rows_slice.rowptr, rows_slice.colind, rows_slice.values, (r0, r1),
            (int(col_ranges[s]), int(col_ranges[s + 1])), symmetric=symmetric))
    return shards
