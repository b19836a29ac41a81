"""Matrix-powers kernel (MPK): the s-step Krylov basis from one halo
exchange, over shards stacked on one device.

Counterpart of ``spmv_tpu.parallel.powers`` (``PowersPlan`` :73,
``build_powers_plan`` :154, ``_build_dia_powers`` :274,
``powers_ghost_stats`` :362, ``chebyshev_powers_basis`` :382,
``newton_powers_basis`` :403, ``_powers_basis`` :436). ``cg_sstep`` cuts
the reductions to one per s iterations, but its basis still pays one halo
exchange per apply; the MPK fetches a depth-s ghost region once and builds
all s+1 basis vectors with local applies only:

1. at plan time (host numpy, once): a BFS of the sparsity pattern s hops
   out from each shard's rows gives its extended ghosts; the ghost exchange
   is an ordinary ``CommPlan`` compiled over them (``compile_plan``), and
   the extended operator is A's rows for owned ∪ ghosts. Columns leaving
   the extended space (only on hop-s rows) are dropped: garbage only
   spreads outward one hop per apply (a row at hop h reads hops <= h+1),
   so the owned slice of every v_0..v_s is exact;
2. at apply time: one ``halo_gather`` fills the extended vectors, then s
   local applies run the recurrence on every shard at once.

Two realizations of the extended operator:
- "dia" (banded operators): each shard's extended window is the contiguous
  global range around its rows under pos(g) = gl_pad + g - r0, which keeps
  every diagonal offset, so the windows stack as (D, L/128, K*128) DIA data
  in ``formats/dia.py``'s lane layout and each basis step is ONE
  ``dia_spmv`` launch for all D shards (``spmv_dia_cuda.spmv_dia_stacked``);
  on a CPU tensor the plain version runs. The owned block is written into
  the window first and the ghosts after, since the owned tail's padding
  overlaps the right ghosts. The reference scatters ghosts with
  ``mode="drop"`` into out-of-bounds padding positions; here padding slots
  point at a spare position past the window (as ``comm_plan._spare_slot``
  does) that is dropped, and no apply sums with a scatter-add. Windows are
  aligned to 128 rows, what the port's DIA kernels take (the reference
  aligns to 1024 for its Pallas gate); the owned results do not depend on
  the alignment. The reference's TPU gate and its XLA fallback are gone:
  on the card the kernel always runs.
- "ell" (any sparsity): (D, next_pad, K) gather tables over
  [owned (col_pad) | ghosts (nghost_pad)], applied as plain torch gathers
  (the reference's XLA gather, no Pallas kernel).
``local_format="auto"`` takes "dia" when A itself is DIA and the window has
at most 64 distinct diagonals, else "ell".

Not ported: the two-tier (dcn, ici) plans (``CommPlan2``); the port has
none yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES
from spmv_torch.ops.spmv_dia_cuda import spmv_dia_stacked
from spmv_torch.parallel.comm_plan import OOB, CommPlan, _round_up, compile_plan, halo_gather
from spmv_torch.parallel.dist_matrix import _ell_apply
from spmv_torch.parallel.partition import owner_ranges

# rows a DIA window is padded to: the port's DIA kernels take any multiple
# of 128 rows a shard (csrc/spmv_dia.cu), starting on 16 bytes
WINDOW_ALIGN = LANES
# "auto" and "dia" take a window of at most this many distinct diagonals
MAX_WINDOW_DIAGS = 64


@dataclasses.dataclass
class PowersPlan:
    """Depth-s ghost plan and the extended operator, stacked over shards.

    ELL realization: colind/values (D, next_pad, K), the extended rows in
    the extended-local layout [owned (col_pad) | ghosts (nghost_pad)];
    padding slots hold value 0 (colind 0).

    DIA realization: dia_data (D, dia_rows/128, K*128) in the lane layout;
    ghost_pos (D, nghost_pad) int64, the window positions the ghost buffer
    lands on (padding slots: ``dia_rows``, the spare position); gl_pad, the
    window position of each shard's first owned row.
    """

    colind: torch.Tensor | None
    values: torch.Tensor | None
    plan: CommPlan
    dia_data: torch.Tensor | None
    ghost_pos: torch.Tensor | None
    s: int
    next_pad: int
    local_format: str = "ell"
    dia_offsets: tuple = ()
    gl_pad: int = 0
    dia_rows: int = 0


def _expand_rows(rowptr: np.ndarray, rows: np.ndarray):
    """Indices into colind/values for the given rows, and the per-row
    counts (a vectorized CSR row gather)."""
    starts = rowptr[rows].astype(np.int64)
    cnt = (rowptr[rows + 1] - rowptr[rows]).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), cnt
    off = np.repeat(np.cumsum(cnt) - cnt, cnt)
    return np.repeat(starts, cnt) + (np.arange(total) - off), cnt


def _classify_ext_cols(a: CSRHost, ext_ids, r0, r1, ghosts, dtype):
    """Expand the extended rows and classify each entry's column against
    [r0, r1) ∪ ghosts (shared by both realizations). Returns (cnt, gcols,
    gvals, owned, gclip, keep): per-row counts, global columns and values,
    the owned mask, each column's clipped ghost-list position, and the
    keep mask (columns outside the extended space, hop-s rows only, are
    dropped)."""
    ng = len(ghosts)
    idx, cnt = _expand_rows(a.rowptr, ext_ids)
    gcols = a.colind[idx].astype(np.int64)
    gvals = a.values[idx].astype(dtype)
    owned = (gcols >= r0) & (gcols < r1)
    if ng:
        gclip = np.minimum(np.searchsorted(ghosts, gcols), ng - 1)
        hit = (~owned) & (ghosts[gclip] == gcols)
    else:
        gclip = np.zeros(len(gcols), np.int64)
        hit = np.zeros(len(gcols), bool)
    return cnt, gcols, gvals, owned, gclip, owned | hit


def _bfs_ghosts(a: CSRHost, r0: int, r1: int, s: int) -> np.ndarray:
    """The sorted global rows within s hops of [r0, r1) that the shard does
    not own (the reference's BFS; neighbours inside the owned range are
    filtered before the set operations, which leaves the sets unchanged)."""
    levels = []
    seen = None
    cur = np.arange(r0, r1, dtype=np.int64)
    for _hop in range(s):
        idx, _ = _expand_rows(a.rowptr, cur)
        if len(idx) == 0:
            break
        nb = a.colind[idx].astype(np.int64)
        nb = np.unique(nb[(nb < r0) | (nb >= r1)])
        new = nb if seen is None else np.setdiff1d(nb, seen, assume_unique=True)
        if len(new) == 0:
            break
        levels.append(new)
        seen = new if seen is None else np.union1d(seen, new)
        cur = new
    return np.sort(np.concatenate(levels)) if levels else np.empty(0, np.int64)


def build_powers_plan(a: CSRHost, A, s: int, local_format: str = "auto") -> PowersPlan:
    """Compile the depth-``s`` matrix-powers plan for the square operator
    ``a`` distributed as ``A`` (a ``DistMatrix`` built from the same host
    matrix: its shards, padding, dtype and device). Host numpy, once, at
    assembly time like ``fsai_setup`` or ``amg_setup``.

    ``local_format``: "ell" (any sparsity), "dia" (banded operators: the
    extended windows run the DIA kernel; raises past 64 distinct
    diagonals) or "auto" ("dia" when A's local blocks are DIA and the
    window stays banded, else "ell")."""
    if a.nrows != a.ncols:
        raise ValueError("matrix powers need a square operator")
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if not isinstance(A.plan, CommPlan):
        raise NotImplementedError(
            "two-tier (dcn, ici) halo plans are not ported (ROADMAP.md); "
            "build the operator on one stacked shard axis")
    if local_format not in ("auto", "ell", "dia"):
        raise ValueError(f"unknown local_format {local_format!r}")
    n, D, col_pad = a.nrows, A.n_devices, A.col_pad
    dtype = torch.empty(0, dtype=A.dtype).numpy().dtype
    ranges = owner_ranges(n, D)
    ghost_lists = [_bfs_ghosts(a, int(ranges[sh]), int(ranges[sh + 1]), s)
                   for sh in range(D)]
    plan = compile_plan(ranges, ghost_lists, row_align=col_pad, device=A.device)
    if plan.nlocal_pad != col_pad:
        raise ValueError(f"plan pads shards to {plan.nlocal_pad}, A to {col_pad}")
    next_pad = col_pad + plan.nghost_pad

    if local_format == "dia" or (local_format == "auto" and A.local_format == "dia"):
        built = _build_dia_powers(a, A, s, ranges, ghost_lists, plan, dtype,
                                  strict=local_format == "dia")
        if built is not None:
            return built

    per_shard = []
    K = 1
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        ghosts = ghost_lists[sh]
        ext_ids = np.concatenate([np.arange(r0, r1, dtype=np.int64), ghosts])
        xe_pos = np.concatenate([np.arange(r1 - r0, dtype=np.int64),
                                 col_pad + np.arange(len(ghosts), dtype=np.int64)])
        cnt, gcols, gvals, owned, gclip, keep = _classify_ext_cols(
            a, ext_ids, r0, r1, ghosts, dtype)
        rows_rep = np.repeat(xe_pos, cnt)
        lcols = np.where(owned, gcols - r0, col_pad + gclip)
        rows_rep, lcols, gvals = rows_rep[keep], lcols[keep], gvals[keep]
        kc = np.bincount(rows_rep, minlength=next_pad).astype(np.int64)
        K = max(K, int(kc.max()) if len(kc) else 1)
        per_shard.append((rows_rep, lcols, gvals, kc))

    colind = np.zeros((D, next_pad, K), np.int64)
    values = np.zeros((D, next_pad, K), dtype)
    for sh, (rows_rep, lcols, gvals, kc) in enumerate(per_shard):
        if len(rows_rep) == 0:
            continue
        order = np.argsort(rows_rep, kind="stable")
        rs = rows_rep[order]
        slot = np.arange(len(rs)) - (np.cumsum(kc) - kc)[rs]
        colind[sh, rs, slot] = lcols[order]
        values[sh, rs, slot] = gvals[order]
    return PowersPlan(
        colind=torch.as_tensor(colind, device=A.device),
        values=torch.as_tensor(values, device=A.device),
        plan=plan, dia_data=None, ghost_pos=None, s=s, next_pad=next_pad)


def _build_dia_powers(a, A, s, ranges, ghost_lists, plan, dtype, strict: bool):
    """The DIA realization (``PowersPlan``); None when the window has more
    than MAX_WINDOW_DIAGS distinct diagonals and ``strict`` is False (the
    caller then builds ELL)."""
    D, col_pad = len(ghost_lists), A.col_pad
    gl_needed, right_span = [], []
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        g = ghost_lists[sh]
        gl_needed.append(int(r0 - g.min()) if len(g) and g.min() < r0 else 0)
        gr = int(g.max() + 1 - r1) if len(g) and g.max() >= r1 else 0
        right_span.append(r1 - r0 + gr)
    gl_pad = _round_up(max(gl_needed), LANES)
    L = _round_up(gl_pad + _round_up(max(max(right_span), col_pad), LANES), WINDOW_ALIGN)

    # entries in window coordinates: pos(g) = gl_pad + g - r0 keeps every
    # diagonal offset (pcol - prow = gcol - grow)
    per_shard, all_offs = [], []
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        ghosts = ghost_lists[sh]
        ext_ids = np.concatenate([np.arange(r0, r1, dtype=np.int64), ghosts])
        cnt, gcols, gvals, _owned, _gclip, keep = _classify_ext_cols(
            a, ext_ids, r0, r1, ghosts, dtype)
        grow = np.repeat(ext_ids, cnt)
        offs = (gcols - grow)[keep]
        per_shard.append((gl_pad + grow[keep] - r0, offs, gvals[keep]))
        all_offs.append(np.unique(offs))
    union = np.unique(np.concatenate(all_offs))
    if len(union) > MAX_WINDOW_DIAGS:
        if strict:
            raise ValueError(
                f"extended window has {len(union)} distinct diagonals; "
                "local_format='dia' powers plans are for banded operators")
        return None
    kd = max(len(union), 1)
    dd = np.zeros((D, kd, L), dtype=dtype)
    for sh, (prow, offs, vals) in enumerate(per_shard):
        if len(prow) == 0:
            continue
        key = np.searchsorted(union, offs) * np.int64(L) + prow
        dd[sh] += np.bincount(key, weights=vals, minlength=kd * L).reshape(kd, L).astype(dtype)
    dia_data = (dd.reshape(D, kd, L // LANES, LANES).transpose(0, 2, 1, 3)
                .reshape(D, L // LANES, kd * LANES))
    # the reference's table, its out-of-bounds padding sent to the spare
    # position L
    ghost_pos = np.full((D, max(plan.nghost_pad, 1)), int(OOB), np.int64)
    for sh in range(D):
        g = ghost_lists[sh]
        ghost_pos[sh, : len(g)] = gl_pad + g - int(ranges[sh])
    ghost_pos[ghost_pos == int(OOB)] = L
    return PowersPlan(
        colind=None, values=None, plan=plan,
        dia_data=torch.as_tensor(np.ascontiguousarray(dia_data), device=A.device),
        ghost_pos=torch.as_tensor(ghost_pos, device=A.device),
        s=s, next_pad=col_pad + plan.nghost_pad, local_format="dia",
        dia_offsets=tuple(int(o) for o in union), gl_pad=gl_pad, dia_rows=L)


def powers_ghost_stats(pp: PowersPlan, A) -> dict:
    """The depth-s ghost volume beside the operator's depth-1 halo. A
    growth near s means stencil-like sparsity (the MPK's sweet spot); much
    larger means the pattern defeats the trade."""
    if pp.local_format == "dia":
        ext_rows, nnz_slots = pp.dia_rows, len(pp.dia_offsets) * pp.dia_rows
    else:
        ext_rows, nnz_slots = pp.next_pad, int(pp.values.shape[1] * pp.values.shape[2])
    return {
        "s": pp.s,
        "nghost_pad_depth_s": pp.plan.nghost_pad,
        "nghost_pad_depth_1": A.plan.nghost_pad,
        "growth": pp.plan.nghost_pad / max(A.plan.nghost_pad, 1),
        "ext_rows_pad": ext_rows,
        "ext_nnz_slots": nnz_slots,
    }


def chebyshev_powers_basis(pp: PowersPlan, x: torch.Tensor, c, e) -> torch.Tensor:
    """The s+1 shifted-Chebyshev basis vectors of ``x`` (the stacked lane
    layout) from one halo exchange: (s+1, *x.shape), ``V[j]`` equal to the
    recurrence v_{j+1} = 2((A - c)/e) v_j - v_{j-1} built with s
    halo-exchanged matvecs. Use as ``cg_sstep(..., basis_builder=lambda r,
    c, e: chebyshev_powers_basis(pp, r, c, e))`` with the plan's s."""
    c, e = float(c), float(e)

    def recur(xe, apply_op):
        vs = [xe, (apply_op(xe) - c * xe) / e]
        for _ in range(1, pp.s):
            vs.append(2 * (apply_op(vs[-1]) - c * vs[-1]) / e - vs[-2])
        return vs

    return _powers_basis(pp, x, recur)


def newton_powers_basis(pp: PowersPlan, x: torch.Tensor, ops) -> torch.Tensor:
    """The s+1 Leja-ordered Newton basis vectors of ``x`` from one halo
    exchange: v_{j+1} = (A v_j - alpha_j v_j + gamma_j v_{j-1}) / sigma_j
    with the ``ops`` of ``solvers/newton_basis.newton_basis_ops``
    (``len(ops)`` must be the plan's s). Use as ``gmres_sstep(...,
    newton_ops=ops, basis_builder=lambda q: newton_powers_basis(pp, q,
    ops))``."""
    if len(ops) != pp.s:
        raise ValueError(f"ops length {len(ops)} != plan depth s={pp.s}")
    if ops and ops[0][1] != 0.0:
        raise ValueError("ops[0] must have gamma == 0 (a conjugate pair "
                         f"cannot START the recurrence); got gamma={ops[0][1]!r}")

    def recur(xe, apply_op):
        vs = [xe]
        for alpha, gamma, sigma in ops:
            w = apply_op(vs[-1]) - alpha * vs[-1]
            if gamma != 0.0:
                w = w + gamma * vs[-2]
            vs.append(w / sigma)
        return vs

    return _powers_basis(pp, x, recur)


def _powers_basis(pp: PowersPlan, x: torch.Tensor, recur) -> torch.Tensor:
    """One deep ``halo_gather``, then ``recur(xe, apply_op) -> [v_0..v_s]``
    on the extended vectors of every shard at once; the owned slices,
    stacked as (s+1, *x.shape)."""
    plan = pp.plan
    nd, col_pad = plan.n_devices, plan.nlocal_pad
    xf = x.reshape(nd, col_pad)
    g = halo_gather(xf, plan.send_idx, plan.recv_pos, plan.rounds, plan.nghost_pad)
    if pp.local_format == "dia":
        L = pp.dia_rows
        xe = xf.new_zeros((nd, L + 1))
        # the owned block first: its padding tail overlaps the right ghosts,
        # which land after it; padding ghost slots land on the spare column L
        xe[:, pp.gl_pad: pp.gl_pad + col_pad] = xf
        if plan.nghost_pad:
            xe.scatter_(1, pp.ghost_pos, g)
        xe = xe[:, :L].reshape(nd * L // LANES, LANES)

        def apply_op(v):
            return spmv_dia_stacked(pp.dia_data, v, pp.dia_offsets, False)

        own = (torch.arange(col_pad, device=x.device)[None, :]
               < plan.nlocal[:, None]).to(x.dtype)
        vs = recur(xe, apply_op)
        V = [v.reshape(nd, L)[:, pp.gl_pad: pp.gl_pad + col_pad] * own for v in vs]
    else:
        xe = torch.cat([xf, g], dim=1)

        def apply_op(v):
            return _ell_apply(pp.colind, pp.values, v)

        V = [v[:, :col_pad] for v in recur(xe, apply_op)]
    return torch.stack(V).reshape((pp.s + 1,) + tuple(x.shape))
