"""Algebraic multigrid (aggregation) as a CG preconditioner.

Counterpart of ``spmv_tpu.solvers.amg``. The host setup (aggregation,
smoothed prolongator, Galerkin products, level assembly) is the
reference's numpy code carried across; the cycle runs on the stacked-shard
layout of ``DistMatrix`` (every shard on the leading axis of one tensor),
in plain torch around the operators' own kernels:

- every level's smoother is degree-``degree`` Chebyshev-Jacobi
  (solvers/chebyshev.py): its applies are the level operator's matvec (the
  DIA/ELL/WELL kernels) and no reductions;
- aggregates never cross a shard, so restriction and prolongation stay
  shard-local: reshape-sums of interval blocks (``aggregate="interval"``,
  ``"interval2d"``) with the prolongator smoothing applied implicitly
  through the level's own operator, gather tables (unsmoothed P0), or
  rectangular ELL operators P and R (smoothed ``"match"``);
- the coarsest level is inverted once on the host (float64, identity on
  padding rows) and applied as one dense product over all shards.

Identical pre/post smoothing around an exact Galerkin correction gives a
symmetric positive definite cycle, so it is a valid ``cg`` preconditioner.
``as_preconditioner`` casts float64 residuals through the float32 cycle.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost, csr_matmul as _spgemm
from spmv_torch.formats.dia import LANES
from spmv_torch.parallel.dist_matrix import DistMatrix, build_dist_matrix
from spmv_torch.parallel.dist_matrix import relayout as _relayout
from spmv_torch.parallel.partition import owner_ranges
from spmv_torch.solvers.chebyshev import chebyshev


# --------------------------------------------------------------------------
# host-side setup: pairwise aggregation (the reference's numpy tiers)
# --------------------------------------------------------------------------

def _strongest_neighbor(rows, cols, w, prio, n):
    """cand[i] = argmax_j w(i,j), ties broken by a random priority (the
    last of equal (w, prio) wins), so constant-weight graphs still form
    mutual pairs."""
    order = np.lexsort((prio[cols], w, rows))
    r_sorted = rows[order]
    if len(r_sorted) == 0:
        return np.full(n, -1, dtype=np.int64)
    last = np.flatnonzero(np.r_[r_sorted[1:] != r_sorted[:-1], True])
    cand = np.full(n, -1, dtype=np.int64)
    cand[r_sorted[last]] = cols[order][last]
    return cand


def _pairwise_pass(rows, cols, vals, n, seed):
    """One matching pass: mutual strongest-neighbour pairs merge, remaining
    singletons attach to their strongest matched neighbour. Returns ``agg``
    (n,) int64 in [0, nc) and nc."""
    idx = np.arange(n, dtype=np.int64)
    if len(rows) == 0:
        return idx.copy(), n
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    # symmetrize the strength graph (coalescing not needed for argmax)
    rows2 = np.concatenate([rows, cols])
    cols2 = np.concatenate([cols, rows])
    w = np.abs(np.concatenate([vals, vals]).astype(np.float64))
    prio = np.random.default_rng(seed).permutation(n).astype(np.float64)

    cand = _strongest_neighbor(rows2, cols2, w, prio, n)
    mate = np.where(cand >= 0, cand, idx)
    mutual = (mate[mate] == idx) & (mate != idx)
    rep = np.where(mutual, np.minimum(idx, mate), idx)

    # attach leftover singletons to the aggregate of their strongest
    # already-matched neighbour (reps of matched nodes are final: no chains)
    matched = mutual
    keep = matched[cols2]
    if keep.any():
        att = _strongest_neighbor(rows2[keep], cols2[keep], w[keep], prio, n)
        lone = ~matched & (att >= 0)
        rep = rep.copy()
        rep[lone] = rep[att[lone]]

    uniq, agg = np.unique(rep, return_inverse=True)
    return agg.astype(np.int64), len(uniq)


def _coarsen_graph(rows, cols, vals, agg, nc):
    """Galerkin triplets on the aggregated graph (duplicates summed), which
    drive the next matching pass."""
    cr = agg[rows]
    cc = agg[cols]
    key = cr * nc + cc
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.bincount(inv, weights=vals.astype(np.float64))
    return uniq // nc, uniq % nc, v


def _aggregate_block(rows, cols, vals, n, passes, seed):
    """Compose ``passes`` pairwise passes on one shard's local block.
    Returns the composed fine->coarse map and the coarse size."""
    agg = np.arange(n, dtype=np.int64)
    nc = n
    r, c, v = rows, cols, vals
    for p in range(passes):
        a_p, nc_p = _pairwise_pass(r, c, v, nc, seed + 101 * p)
        agg = a_p[agg]
        nc = nc_p
        if p + 1 < passes:
            r, c, v = _coarsen_graph(r, c, v, a_p, nc)
    return agg, nc


def _smoothed_prolongator(a: CSRHost, agg_g: np.ndarray, ncg: int,
                          dinv: np.ndarray, lmax: float,
                          theta: float = 0.0) -> CSRHost:
    """P = (I - omega D^-1 A) P0 with P0 piecewise-constant over the
    aggregates and omega = 4/3 / rho(D^-1 A) (Gershgorin-bounded rho), the
    smoothed-aggregation prolongator; ``theta > 0`` drops weak entries
    (|p_ij| < theta * row max) and renormalizes rows to their sum."""
    omega = 4.0 / (3.0 * max(lmax, 1e-30))
    lens = a.row_nnz().astype(np.int64)
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    idx = np.arange(a.nrows, dtype=np.int64)
    rows = np.concatenate([idx, rows_g])
    cols = np.concatenate([agg_g, agg_g[a.colind.astype(np.int64)]])
    vals = np.concatenate([
        np.ones(a.nrows, np.float64),
        -omega * dinv[rows_g] * a.values.astype(np.float64),
    ])
    p = CSRHost.from_coo(rows, cols, vals, a.nrows, ncg)
    if p.nnz == 0 or theta <= 0.0:
        # theta = 0 keeps every entry and the renormalization scale is
        # exactly 1.0: the filter below would be an identity
        return p
    lens_p = p.row_nnz().astype(np.int64)
    pr = np.repeat(np.arange(p.nrows, dtype=np.int64), lens_p)
    pv = p.values.astype(np.float64)
    rmax = np.zeros(p.nrows, np.float64)
    np.maximum.at(rmax, pr, np.abs(pv))
    keep = np.abs(pv) >= theta * rmax[pr]
    rsum = np.bincount(pr, weights=pv, minlength=p.nrows)
    ksum = np.bincount(pr[keep], weights=pv[keep], minlength=p.nrows)
    scale = np.divide(rsum, ksum, out=np.ones_like(rsum), where=ksum != 0)
    return CSRHost.from_coo(pr[keep], p.colind[keep].astype(np.int64),
                            pv[keep] * scale[pr[keep]], p.nrows, ncg)


def _detect_strides(a: CSRHost, sample: int = 2_000_000,
                    max_strides: int = 2) -> list[int]:
    """Grid strides of a row-major grid, detected from the sampled
    column-offset histogram: significant offsets > 1 are clustered (a 9- or
    27-point stencil puts near-equal mass on nx-1, nx, nx+1) and each
    cluster's weighted centre is a stride. [nx] for a 2-D stencil,
    [nx, nx*ny] for 3-D, [] for 1-D or pattern-free operators."""
    nnz = a.nnz
    if nnz == 0:
        return []
    if nnz > sample:
        step = nnz // sample
        idx = np.arange(0, nnz, step, dtype=np.int64)
    else:
        idx = np.arange(nnz, dtype=np.int64)
    rows = np.searchsorted(a.rowptr, idx, side="right") - 1
    d = a.colind[idx].astype(np.int64) - rows
    d = d[d > 1]
    if len(d) == 0:
        return []
    vals_u, counts = np.unique(d, return_counts=True)
    sig = counts >= 0.02 * len(idx)  # offsets present in ~every row
    vals_u, counts = vals_u[sig], counts[sig]
    if len(vals_u) == 0:
        return []
    strides: list[int] = []
    start = 0
    for i in range(1, len(vals_u) + 1):
        if (i == len(vals_u)
                or vals_u[i] - vals_u[i - 1] > max(2, vals_u[i - 1] // 8)):
            c = counts[start:i]
            v = vals_u[start:i]
            strides.append(int(round(float((v * c).sum() / c.sum()))))
            start = i
    # the most-supported clusters in ascending order; the 3-D pair must be
    # consistent (s2 % s1 == 0 within the cluster slack)
    strides = strides[:max_strides + 2]
    out = []
    for s in strides:
        if s <= 1:
            continue
        if out and abs(s % out[0]) > max(2, out[0] // 8) \
                and abs(out[0] - s % out[0]) > max(2, out[0] // 8):
            continue  # inconsistent with the base stride: not a grid axis
        out.append(s)
        if len(out) == max_strides:
            break
    return out


def _gershgorin_scaled(rows, cols, vals, diag):
    """max_i sum_j |a_ij| / |a_ii|, an upper bound on lambda_max(D^-1 A)
    (rows with zero diagonal, padding, are excluded)."""
    absrow = np.bincount(rows, weights=np.abs(vals.astype(np.float64)),
                         minlength=len(diag))
    d = np.abs(diag.astype(np.float64))
    ratio = np.divide(absrow, d, out=np.zeros_like(absrow), where=d > 0)
    return float(ratio.max()) if len(ratio) else 1.0


# --------------------------------------------------------------------------
# the hierarchy
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AMGLevel:
    """One fine level: its operator, Jacobi scaling, smoother bounds, and
    the transfers to the next level: interval reshape-sums (``interval``
    > 0), gather tables (unsmoothed P0), or rectangular operators P/R
    (smoothed prolongator)."""

    A: DistMatrix
    dinv: torch.Tensor       # (D*row_pad/128, 128) 1/diag (0 where diag == 0)
    restrict_tab: torch.Tensor | None  # (D, nc_pad, S) int64; dump = row_pad
    prolong_tab: torch.Tensor | None   # (D, row_pad) int64; dump = nc_pad
    P: DistMatrix | None     # smoothed prolongator (fine x coarse)
    R: DistMatrix | None     # its transpose (coarse x fine)
    lmax: float              # Gershgorin bound on lambda_max(D^-1 A)
    lmin: float              # bottom of the smoothing band
    nc_pad: int              # next level's per-shard padded size
    degree: int              # Chebyshev smoothing steps
    interval: int = 0        # aggregate run length (0 = table/operator mode)
    omega_p: float = 0.0     # implicit prolongator smoothing weight
    omega_c: float = 0.0     # coarse-correction over-relaxation (0 = global)
    smoothed: bool = True    # False: fell back to unsmoothed P0
    stride: int = 1          # interval mode: detected grid x-extent
    stride2: int = 0         # 3-D grids: the plane stride nx*ny (0 = 2-D)


@dataclasses.dataclass
class AMGHierarchy:
    """The grid hierarchy; ``as_preconditioner()`` plugs into ``cg``."""

    levels: list[AMGLevel]
    coarse_A: DistMatrix            # coarsest operator
    coarse_inv: torch.Tensor | None  # (D*cpad, D*cpad) dense inverse
    coarse_dinv: torch.Tensor       # fallback smoother scaling on coarsest
    coarse_lmax: float
    coarse_lmin: float
    coarse_iters: int               # Chebyshev fallback iterations
    cycle: int                      # 1 = V-cycle, 2 = W-cycle
    omega: float = 1.0              # coarse-correction over-relaxation

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    def grid_complexity(self) -> float:
        """Sum of level unknowns over fine unknowns."""
        tot = sum(lvl.A.nrows_global for lvl in self.levels)
        tot += self.coarse_A.nrows_global
        return tot / self.levels[0].A.nrows_global if self.levels else 1.0

    def as_preconditioner(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """z = M^-1 r closure for ``cg(preconditioner=...)``. A float64
        residual runs through the float32 cycle and back, and a residual in
        a layout padded otherwise than the first level's (a float64 or
        double-single operator gets a float32 ELL fine level of its own)
        is re-padded on the way in and out."""
        first = self.levels[0].A if self.levels else self.coarse_A
        nd = first.n_devices

        def apply(r):
            pad = r.shape[0] // nd * LANES
            z = _cycle(self, 0, _relayout(r.to(torch.float32), first.row_pad, nd))
            return _relayout(z, pad, nd).to(r.dtype)

        return apply


# --------------------------------------------------------------------------
# the cycle, on the stacked-shard lane layout
# --------------------------------------------------------------------------

def _smooth(A, dinv, lmax, lmin, degree, r, x0=None):
    """``degree`` Chebyshev steps on D^-1 A x = D^-1 r (no reductions)."""
    return chebyshev(lambda v: dinv * A.matvec(v), dinv * r, lmin, lmax,
                     iters=degree, x0=x0).x


def _fit(v: torch.Tensor, n: int) -> torch.Tensor:
    """(D, m) -> (D, n): zero-pad or truncate each shard's row."""
    m = v.shape[1]
    return torch.nn.functional.pad(v, (0, n - m)) if n > m else v[:, :n]


def _interval_stages(lvl: AMGLevel) -> list[int]:
    """The transfer's reshape-sum stages, outermost grid axis first (z with
    stride2, y with stride), then the consecutive x stage as stride 1."""
    stages = []
    if lvl.stride2 > 1:
        stages.append(lvl.stride2)
    if lvl.stride > 1:
        stages.append(lvl.stride)
    stages.append(1)
    return stages


def _restrict_interval(lvl: AMGLevel, r: torch.Tensor) -> torch.Tensor:
    """R r = P0^T (I - omega_p A D^-1) r with P0^T = aggregate-block sums:
    per shard, each stage pads to whole blocks and sums ``interval``
    entries spaced ``s`` apart (one batched reshape over the shard axis).
    Needs a symmetric level operator, so that R = P^T."""
    A = lvl.A
    nd = A.n_devices
    if lvl.omega_p != 0.0:
        r = r - lvl.omega_p * A.matvec(lvl.dinv * r)
    size = lvl.interval
    v = r.reshape(nd, A.row_pad)
    ln = A.row_pad
    for s in _interval_stages(lvl):
        nb = -(-ln // (size * s))
        v = _fit(v, nb * size * s).reshape(nd, nb, size, s).sum(dim=2)
        v = v.reshape(nd, nb * s)
        ln = nb * s
    return _fit(v, lvl.nc_pad).reshape(nd * lvl.nc_pad // LANES, LANES)


def _prolong_interval(lvl: AMGLevel, xc: torch.Tensor) -> torch.Tensor:
    """P xc = (I - omega_p D^-1 A) P0 xc with P0 = aggregate-block repeat
    (the reverse of ``_restrict_interval``'s stage chain). Fine padding
    rows are masked by dinv's zero pattern, so no junk reaches the outer
    solve's dot products."""
    A = lvl.A
    nd = A.n_devices
    size = lvl.interval
    stages = _interval_stages(lvl)
    rp = A.row_pad
    lens = [rp]
    for s in stages:
        nb = -(-lens[-1] // (size * s))
        lens.append(nb * s)
    v = _fit(xc.reshape(nd, lvl.nc_pad), lens[-1])
    for i in range(len(stages) - 1, -1, -1):
        s = stages[i]
        nb = lens[i + 1] // s
        v = v.reshape(nd, nb, 1, s).expand(nd, nb, size, s).reshape(nd, -1)
        v = _fit(v, lens[i])
    xf = v.reshape(nd * rp // LANES, LANES) * (lvl.dinv != 0).to(xc.dtype)
    if lvl.omega_p != 0.0:
        xf = xf - lvl.omega_p * lvl.dinv * A.matvec(xf)
    return xf


def _restrict(lvl: AMGLevel, r: torch.Tensor) -> torch.Tensor:
    if lvl.interval:
        return _restrict_interval(lvl, r)
    nd = lvl.A.n_devices
    if lvl.R is not None:
        rc = lvl.R.matvec(_relayout(r, lvl.R.col_pad, nd))
        return _relayout(rc, lvl.nc_pad, nd)
    # gather table: S sequential gathers, padding slots read the zero
    # appended at row_pad
    rf = torch.cat([r.reshape(nd, lvl.A.row_pad), r.new_zeros((nd, 1))], dim=1)
    t = lvl.restrict_tab
    rc = torch.gather(rf, 1, t[:, :, 0])
    for k in range(1, t.shape[2]):
        rc = rc + torch.gather(rf, 1, t[:, :, k])
    return rc.reshape(nd * lvl.nc_pad // LANES, LANES)


def _prolong(lvl: AMGLevel, xc: torch.Tensor) -> torch.Tensor:
    if lvl.interval:
        return _prolong_interval(lvl, xc)
    nd = lvl.A.n_devices
    if lvl.P is not None:
        xf = lvl.P.matvec(_relayout(xc, lvl.P.col_pad, nd))
        return _relayout(xf, lvl.A.row_pad, nd)
    xf = torch.cat([xc.reshape(nd, lvl.nc_pad), xc.new_zeros((nd, 1))], dim=1)
    return torch.gather(xf, 1, lvl.prolong_tab).reshape(
        nd * lvl.A.row_pad // LANES, LANES)


def _coarse_solve(h: AMGHierarchy, r: torch.Tensor) -> torch.Tensor:
    A = h.coarse_A
    if h.coarse_inv is None:
        # Chebyshev fallback when the coarsest grid was too large to invert
        return _smooth(A, h.coarse_dinv, h.coarse_lmax, h.coarse_lmin,
                       h.coarse_iters, r)
    # every shard's rows of the inverse times the whole (all-shard) vector
    return (h.coarse_inv @ r.reshape(-1)).reshape(r.shape)


def _cycle(h: AMGHierarchy, l: int, r: torch.Tensor) -> torch.Tensor:
    if l == len(h.levels):
        return _coarse_solve(h, r)
    lvl = h.levels[l]
    w = lvl.omega_c if lvl.omega_c != 0.0 else h.omega
    x = _smooth(lvl.A, lvl.dinv, lvl.lmax, lvl.lmin, lvl.degree, r)
    for _ in range(h.cycle):  # 1 = V, 2 = W
        rc = _restrict(lvl, r - lvl.A.matvec(x))
        x = x + w * _prolong(lvl, _cycle(h, l + 1, rc))
    return _smooth(lvl.A, lvl.dinv, lvl.lmax, lvl.lmin, lvl.degree, r, x0=x)


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------

def _level_tables(a: CSRHost, A: DistMatrix, passes: int, seed: int):
    """Shard-local aggregation of one level. Returns (global fine->coarse
    map, coarse global size ``D*ncs_max``, per-shard maps, per-shard
    coarse sizes, ncs_max)."""
    nd = A.n_devices
    ranges = owner_ranges(a.nrows, nd)
    lens = a.row_nnz()
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols_g = a.colind.astype(np.int64)

    aggs, ncs = [], []
    for s in range(nd):
        r0, r1 = int(ranges[s]), int(ranges[s + 1])
        lo, hi = a.rowptr[r0], a.rowptr[r1]
        rs = rows_g[lo:hi] - r0
        cs = cols_g[lo:hi]
        keep = (cs >= r0) & (cs < r1)  # aggregation sees the local block
        agg_s, nc_s = _aggregate_block(
            rs[keep], cs[keep] - r0, a.values[lo:hi][keep], r1 - r0,
            passes, seed + 977 * s)
        aggs.append(agg_s)
        ncs.append(nc_s)

    ncs_max = max(max(ncs), 1)
    agg_global = np.concatenate(
        [s * ncs_max + aggs[s] for s in range(nd)]
    ) if a.nrows else np.zeros(0, np.int64)
    return agg_global, nd * ncs_max, aggs, ncs, ncs_max


def _build_tables(aggs, ncs, row_pad, nc_pad, nd):
    """Gather tables: restrict (nd, nc_pad, S) and prolong (nd, row_pad)."""
    s_max = 1
    per_shard = []
    for s in range(nd):
        agg = aggs[s]
        counts = np.bincount(agg, minlength=ncs[s]) if len(agg) else \
            np.zeros(ncs[s], np.int64)
        s_max = max(s_max, int(counts.max()) if len(counts) else 1)
        per_shard.append(counts)

    restrict = np.full((nd, nc_pad, s_max), row_pad, dtype=np.int32)
    prolong = np.full((nd, row_pad), nc_pad, dtype=np.int32)
    for s in range(nd):
        agg = aggs[s]
        n = len(agg)
        prolong[s, :n] = agg
        order = np.argsort(agg, kind="stable")
        counts = per_shard[s]
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos = np.arange(n) - offsets[agg[order]]
        restrict[s, agg[order], pos] = order
    return restrict, prolong


def amg_setup(
    a: CSRHost,
    A: DistMatrix,
    passes: int = 1,
    max_levels: int = 16,
    coarse_max: int = 3072,
    dense_cap: int = 6144,
    degree: int = 2,
    band: float = 4.0,
    cycle: int = 1,
    omega: float = 1.0,
    smooth: bool = True,
    filter_theta: float = 0.05,
    coarse_iters: int = 24,
    galerkin_budget: float = 12.0,
    seed: int = 0,
    local_format: str = "ell",
    transfer_format: str | None = None,
    aggregate: str = "match",
    interval_size: int = 2,
    smooth_levels: int | None = None,
    dtype=np.float32,
    timings: dict | None = None,
) -> AMGHierarchy:
    """Build the AMG hierarchy for SPD ``a`` (host CSR) whose distributed
    operator is ``A`` (the operator the outer solve uses, any local format;
    its shard count and device carry to every level).

    The defaults are the reference's smoothed aggregation: pairwise
    aggregates of about 3 (``passes=1``), a Jacobi-smoothed prolongator
    applied through rectangular ELL operators P and R, degree-2 Chebyshev
    smoothing over [lmax/band, lmax]. ``cycle``: 1 = V, 2 = W. ``omega``:
    coarse-correction over-relaxation. Coarse grids are assembled at
    ``dtype`` (float32) whatever the fine operator's precision; a float64
    or double-single ``A`` gets its own float32 fine-level operator.
    ``galerkin_budget``: a level whose Galerkin expansion would exceed this
    many times its nnz falls back to the unsmoothed P0 (gather tables,
    1.7 over-relaxation), as do levels past ``smooth_levels``.

    ``aggregate="interval"``: each shard aggregates ``interval_size``
    consecutive rows (banded coarse operators, reshape-sum transfers);
    ``"interval2d"``: ``interval_size``^d blocks of the grid whose strides
    are detected per level (``_detect_strides``): the headline
    configuration, mesh-independent with a bounded stencil.

    ``timings``, when given, receives the host seconds of the setup split
    into "aggregation", "galerkin" (prolongator and SpGEMM), "assembly"
    (level operators, tables, scaling) and "coarse" (the dense inverse).
    """
    if a.nrows != a.ncols:
        raise ValueError("AMG requires a square (SPD) operator")
    if aggregate not in ("match", "interval", "interval2d"):
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    if aggregate.startswith("interval") and interval_size < 2:
        raise ValueError("interval_size must be >= 2")
    clock = {"aggregation": 0.0, "galerkin": 0.0, "assembly": 0.0, "coarse": 0.0}
    t_mark = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        clock[key] += now - t_mark[0]
        t_mark[0] = now

    if transfer_format is None:
        # transfers are rectangular: DIA cannot store them
        transfer_format = "ell" if local_format.startswith("dia") else local_format
    nd, device = A.n_devices, A.device
    levels: list[AMGLevel] = []
    cur = a
    cur_A = A
    if A.local_format in ("dia_ds", "well_ds") or A.dtype == torch.float64:
        # the smoother needs a plain float32 apply: a dedicated fine-level
        # operator (the preconditioner's accuracy does not limit the outer
        # residual)
        cur_A = build_dist_matrix(a, n_devices=nd, local_format=local_format,
                                  dtype=dtype, device=device)
    lap("assembly")

    while (len(levels) < max_levels - 1
           and cur.nrows > max(coarse_max, nd * LANES)):
        lvl_stride = 1
        lvl_stride2 = 0
        if aggregate in ("interval", "interval2d"):
            if aggregate == "interval2d":
                # interval^d grid blocks of the detected 2-D/3-D grid:
                # coarsening every direction keeps the smoothed Galerkin
                # stencil bounded and the counts mesh-independent
                s_det = _detect_strides(cur)
                if s_det and cur.nrows // s_det[0] >= interval_size:
                    lvl_stride = s_det[0]
                    if (len(s_det) > 1
                            and cur.nrows // s_det[1] >= interval_size):
                        lvl_stride2 = s_det[1]
            nlocs = np.diff(owner_ranges(cur.nrows, nd))
            # stage(v, s) = (v // (I*s))*s + v % s, outermost axis first:
            # the device reshape chain of _restrict_interval
            stages_h = ([lvl_stride2] if lvl_stride2 > 1 else []) + \
                ([lvl_stride] if lvl_stride > 1 else []) + [1]
            aggs, ncs = [], []
            for nl in nlocs:
                v = np.arange(int(nl), dtype=np.int64)
                for s in stages_h:
                    v = (v // (interval_size * s)) * s + (v % s)
                aggs.append(v)
                ncs.append(max(int(v.max()) + 1 if len(v) else 1, 1))
            ncs_max = max(ncs)
            agg_g = (np.concatenate([s * ncs_max + aggs[s] for s in range(nd)])
                     if cur.nrows else np.zeros(0, np.int64))
            ncg = nd * ncs_max
        else:
            agg_g, ncg, aggs, ncs, _ = _level_tables(
                cur, cur_A, passes, seed + 7919 * len(levels))
        lap("aggregation")
        if ncg >= 0.8 * cur.nrows:  # coarsening stalled
            break
        diag, lmax = _level_diag(cur)
        restrict = prolong = Pop = Rop = None
        omega_p = 0.0
        omega_c = 0.0
        # smoothing each level's P convolves the stencil; past
        # smooth_levels (or the Galerkin budget) a level falls back to the
        # unsmoothed P0 with a 1.7 over-relaxed correction
        sm_l = smooth and (smooth_levels is None or len(levels) < smooth_levels)
        if sm_l:
            dinv_h = np.divide(1.0, diag, out=np.zeros_like(diag), where=diag != 0)
            # interval mode applies P implicitly: the Galerkin product must
            # use the unfiltered smoothed P that the apply uses
            theta = 0.0 if aggregate.startswith("interval") else filter_theta
            p_host = _smoothed_prolongator(cur, agg_g, ncg, dinv_h, lmax,
                                           theta=theta)
            # densification guard: the partial-product count of cur @ P
            # relative to this level's nnz, before running the product
            pp_nnz = np.diff(p_host.rowptr).astype(np.float64)
            col_hist = np.bincount(cur.colind, minlength=cur.ncols)
            flops_ap = int(pp_nnz @ col_hist[: len(pp_nnz)])
            if flops_ap > galerkin_budget * max(cur.nnz, 1):
                sm_l = False
                warnings.warn(
                    f"amg_setup: level {len(levels)} "
                    f"(n={cur.nrows}) falls back to unsmoothed P0 — "
                    f"Galerkin expansion {flops_ap} > budget "
                    f"{galerkin_budget} * nnz ({cur.nnz}); raise "
                    "galerkin_budget to force smoothing here",
                    stacklevel=2)
        if sm_l:
            coarse = _spgemm(p_host.transpose(), _spgemm(cur, p_host))
            lap("galerkin")
            A_c = _build_op(coarse, nd, local_format, dtype, device)
            if aggregate.startswith("interval"):
                omega_p = 4.0 / (3.0 * max(lmax, 1e-30))
            else:
                Pop = _build_op(p_host, nd, transfer_format, dtype, device)
                Rop = _build_op(p_host.transpose(), nd, transfer_format, dtype,
                                device)
        else:
            lens = cur.row_nnz()
            rows_g = np.repeat(np.arange(cur.nrows, dtype=np.int64), lens)
            coarse = CSRHost.from_coo(
                agg_g[rows_g], agg_g[cur.colind.astype(np.int64)],
                cur.values.astype(np.float64), ncg, ncg)
            lap("galerkin")
            A_c = _build_op(coarse, nd, local_format, dtype, device)
            if not aggregate.startswith("interval"):
                restrict, prolong = _build_tables(
                    aggs, ncs, cur_A.row_pad, A_c.row_pad, nd)
            if smooth:  # unsmoothed P0 only because of the depth cutoff
                omega_c = 1.7
        levels.append(_make_level(
            cur_A, diag, lmax, restrict, prolong, Pop, Rop, A_c.row_pad,
            degree, band,
            interval=(interval_size if aggregate.startswith("interval") else 0),
            omega_p=omega_p, omega_c=omega_c, smoothed=bool(sm_l),
            stride=lvl_stride, stride2=lvl_stride2))
        lap("assembly")
        cur, cur_A = coarse, A_c

    # coarsest: dense inverse (identity on padding rows) when small enough
    diag, lmax = _level_diag(cur)
    cpad = cur_A.row_pad
    ng = nd * cpad
    coarse_inv = None
    if ng <= dense_cap:
        ranges = owner_ranges(cur.nrows, nd)
        dense = np.eye(ng, dtype=np.float64)
        rows_g = np.repeat(np.arange(cur.nrows, dtype=np.int64), cur.row_nnz())
        pr = _padded_index(rows_g, ranges, cpad)
        pc = _padded_index(cur.colind.astype(np.int64), ranges, cpad)
        own = _padded_index(np.arange(cur.nrows, dtype=np.int64), ranges, cpad)
        dense[own, own] = 0.0
        np.add.at(dense, (pr, pc), cur.values.astype(np.float64))
        # structurally-zero rows (padding or isolated) keep the identity
        empty = np.abs(dense).sum(axis=1) == 0
        dense[empty, empty] = 1.0
        coarse_inv = torch.as_tensor(np.linalg.inv(dense).astype(dtype),
                                     device=device)
    coarse_dinv = _dinv_dist(cur_A, diag)
    lap("coarse")
    if timings is not None:
        timings.update(clock)

    return AMGHierarchy(
        levels=levels,
        coarse_A=cur_A,
        coarse_inv=coarse_inv,
        coarse_dinv=coarse_dinv,
        coarse_lmax=lmax,
        coarse_lmin=lmax / max(band * band, 16.0),
        coarse_iters=coarse_iters,
        cycle=cycle,
        omega=omega,
    )


def _build_op(csr, nd, fmt, dtype, device):
    """build_dist_matrix with the reference's per-level ELL fallback: deep
    Galerkin coarse grids can outgrow WELL's slot cap; those levels are
    small, so ELL is fine there. Banded Galerkin grids near-dense within
    their band (at least 0.3 nnz per stored slot) may store as many DIA
    diagonals as they have."""
    try:
        kw = {"well_max_k": 128} if fmt.startswith("well") else {}
        if fmt.startswith("dia"):
            lens = csr.row_nnz()
            rg = np.repeat(np.arange(csr.nrows, dtype=np.int64), lens)
            nd_ = len(np.unique(csr.colind.astype(np.int64) - rg))
            if nd_ and csr.nnz / (nd_ * max(csr.nrows, 1)) >= 0.3:
                kw = {"dia_max_diags": max(nd_, 64)}
        return build_dist_matrix(csr, n_devices=nd, local_format=fmt,
                                 dtype=dtype, device=device, **kw)
    except ValueError:
        if fmt == "ell":
            raise
        return build_dist_matrix(csr, n_devices=nd, local_format="ell",
                                 dtype=dtype, device=device)


def _padded_index(idx_g, ranges, pad):
    """Global index -> padded-global index (shard*pad + local)."""
    s = np.searchsorted(ranges, idx_g, side="right") - 1
    return s * pad + (idx_g - ranges[s])


def _level_diag(a: CSRHost):
    lens = a.row_nnz()
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    on_diag = rows_g == a.colind
    diag = np.bincount(rows_g[on_diag],
                       weights=a.values[on_diag].astype(np.float64),
                       minlength=a.nrows)
    lmax = _gershgorin_scaled(rows_g, a.colind, a.values, diag)
    return diag, lmax


def _dinv_dist(A: DistMatrix, diag: np.ndarray) -> torch.Tensor:
    """1/diag on A's stacked lane layout (0 on padding and zero
    diagonals), in A's dtype (float32 for a float64 operator)."""
    nd, rp = A.n_devices, A.row_pad
    ranges = owner_ranges(len(diag), nd)
    out = np.zeros((nd, rp), np.float64)
    for s in range(nd):
        r0, r1 = int(ranges[s]), int(ranges[s + 1])
        d = diag[r0:r1]
        out[s, : r1 - r0] = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
    arr = out.reshape(nd * rp // LANES, LANES).astype(np.float32)
    return torch.as_tensor(arr, device=A.device)


def _make_level(A, diag, lmax, restrict, prolong, Pop, Rop, nc_pad,
                degree, band, interval=0, omega_p=0.0,
                omega_c=0.0, smoothed=True, stride=1,
                stride2=0) -> AMGLevel:
    def table(t):
        return None if t is None else torch.as_tensor(t, dtype=torch.int64,
                                                      device=A.device)

    return AMGLevel(
        A=A,
        dinv=_dinv_dist(A, diag),
        restrict_tab=table(restrict),
        prolong_tab=table(prolong),
        P=Pop,
        R=Rop,
        lmax=lmax,
        lmin=lmax / band,
        nc_pad=nc_pad,
        degree=degree,
        interval=interval,
        omega_p=float(omega_p),
        omega_c=float(omega_c),
        smoothed=bool(smoothed),
        stride=int(stride),
        stride2=int(stride2),
    )


def amg_preconditioner(a: CSRHost, A: DistMatrix, **kw):
    """Convenience: ``(apply, hierarchy)`` for ``cg(..., preconditioner=
    apply)``."""
    h = amg_setup(a, A, **kw)
    return h.as_preconditioner(), h
