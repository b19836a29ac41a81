"""WELL — windowed sliced-ELL, the general-sparsity device format.

Counterpart of ``spmv_tpu.formats.well``. The packer is the reference's
numpy tier carried across, so ``csr_to_well`` gives the reference's
``values``/``pos``/``w0`` bit for bit (the reference's native C++ packer
gives the same bits; it is still to port, ROADMAP.md). Only the container
changes: torch tensors on an explicit device.

Layout: A-row r lives at lane ``r % 128`` of group ``g = r // 128``. Each
group packs its nonzeros into K slots:

  values[k, g, j]  the nonzero of row 128g+j assigned to slot k (0 = pad)
  pos[k, g, j]     window-relative flat column seg*128 + lane (int16 when
                   the window fits, else int32)
  w0[t]            first x segment of the window of tile t, a tile being
                   ``tile_groups`` consecutive groups

so  y[128g + j] = sum_k values[k, g, j] * x[w0[g // tile_groups]*128
                                           + pos[k, g, j]].

Every entry of one slot reads one 128-aligned x segment; with
``pair=True`` two slots whose lane masks are disjoint merge into one that
reads two segments (the endpoint lanes 0 and 127 carry the two legs'
segments). Both forms obey the formula above, because every real entry's
``pos`` carries its own segment and padding slots hold value 0 at a
position inside the window. The formula is what the WELL plain version
(``ops/spmv_well.py``) computes, the oracle of the row lists below.

The kernels, single-RHS and block, read the same stack as warp-sliced row
lists (``pack_rows``), derived from the WELL arrays: rows cut into slices
of 32 consecutive rows (one warp), each slice as wide as its longest row,
and only each row's occupied slots stored, in ascending slot order:

  rows.values[slice_ptr[s] + 32*j + l]  the j-th occupied slot of row 32s+l
  rows.pos[...]                         its window-relative position

A short row is padded to its slice's width with value 0 at one of its own
positions (0 for an empty row), so every read stays inside the window and
every padded term adds an exact zero. ``w0`` is the WELL stack's own: a
32-row slice lies inside one 128-row group.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost, coo_ell
from spmv_torch.formats.dia import host_dtype

LANES = 128
SLICE = 32  # rows per row-list slice: one warp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class WellRows(NamedTuple):
    """Warp-sliced row lists of D stacked WELL blocks (module doc), host
    numpy. Shard d's entries fill ``values[d, :slice_ptr[d, -1]]``; the
    rest, up to the longest shard's count, is never read."""

    values: np.ndarray     # (D, E)
    pos: np.ndarray        # (D, E) int16/int32, window-relative
    slice_ptr: np.ndarray  # (D, G*4 + 1) int64, first entry of each slice
    values_lo: np.ndarray | None = None  # (D, E) double-single lo plane


def pack_rows(values: np.ndarray, pos: np.ndarray, wseg: int,
              values_lo: np.ndarray | None = None) -> WellRows:
    """The row-list layout of D stacked WELL blocks ``values``/``pos``
    (D, K, G, 128) whose windows span ``wseg`` segments; a double-single
    stack passes its lo plane too. A slot is occupied where a value plane
    is nonzero. Each row keeps its slots in the WELL order, so it sums the
    same terms in the same order as the WELL formula; the padding dropped
    and the padding added both add exact zeros. ``pos`` is int16 when
    every window-relative position fits (wseg*128 <= 32767), else int32."""
    nd, k, g, _ = values.shape
    nrows = g * LANES
    ns = nrows // SLICE
    occ = values.reshape(nd, k, nrows) != 0
    if values_lo is not None:
        occ |= values_lo.reshape(nd, k, nrows) != 0
    count = occ.sum(axis=1)                                 # (D, R)
    width = count.reshape(nd, ns, SLICE).max(axis=2)        # (D, S)
    slice_ptr = np.zeros((nd, ns + 1), dtype=np.int64)
    np.cumsum(width * SLICE, axis=1, out=slice_ptr[:, 1:])
    nent = max(int(slice_ptr[:, -1].max()), 1)
    pos_dtype = np.int16 if wseg * LANES <= np.iinfo(np.int16).max else np.int32
    # occupied slots in (shard, slot, row) order; rank = slot's place in
    # its row (int32: max_k may exceed any narrower type's range)
    d_i, k_i, r_i = np.nonzero(occ)
    rank = (np.cumsum(occ, axis=1, dtype=np.int32) - 1)[d_i, k_i, r_i]
    dest = slice_ptr[d_i, r_i // SLICE] + SLICE * rank.astype(np.int64) + r_i % SLICE
    pos_r = pos.reshape(nd, k, nrows)
    real_pos = pos_r[d_i, k_i, r_i]
    # padding reads one of the row's own positions (0 for an empty row)
    own = np.zeros((nd, nrows), dtype=pos_dtype)
    own[d_i, r_i] = real_pos
    out_pos = np.zeros((nd, nent), dtype=pos_dtype)
    for d in range(nd):
        row = (np.repeat(np.arange(ns, dtype=np.int64) * SLICE, width[d] * SLICE)
               + np.arange(int(slice_ptr[d, -1]), dtype=np.int64) % SLICE)
        out_pos[d, : len(row)] = own[d, row]
    out_pos[d_i, dest] = real_pos

    def take(plane):
        out = np.zeros((nd, nent), dtype=plane.dtype)
        out[d_i, dest] = plane.reshape(nd, k, nrows)[d_i, k_i, r_i]
        return out

    return WellRows(take(values), out_pos, slice_ptr,
                    None if values_lo is None else take(values_lo))


@dataclasses.dataclass
class WellMatrix:
    """Windowed sliced-ELL matrix on a torch device, with its row lists."""

    values: torch.Tensor  # (K, G, 128), slot-major
    pos: torch.Tensor     # (K, G, 128) int16/int32, window-relative
    w0: torch.Tensor      # (G / tile_groups,) int32, window start segment
    nrows: int
    ncols: int
    wseg: int             # window size in 128-wide segments
    tile_groups: int      # groups per window tile (fixed at conversion)
    nseg: int = 0         # x segments incl. window-overrun padding
    _nnz: int = 0
    paired: bool = False  # any slot carries two segments
    # the row lists (pack_rows) the kernels read
    rows_values: torch.Tensor | None = None  # (E,)
    rows_pos: torch.Tensor | None = None     # (E,) int16/int32
    slice_ptr: torch.Tensor | None = None    # (G*4 + 1,) int64

    @property
    def ngroups(self) -> int:
        return self.values.shape[1]

    @property
    def k_slots(self) -> int:
        return self.values.shape[0]

    @property
    def nrows_pad(self) -> int:
        return self.ngroups * LANES

    @property
    def ncols_pad(self) -> int:
        """x length the format reads (covers every window, including the
        zero padding past ncols of end-of-matrix windows)."""
        return self.nseg * LANES

    @property
    def n_tiles(self) -> int:
        return self.ngroups // self.tile_groups

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz_stored(self) -> int:
        return int(self._nnz)

    @property
    def ngroups_data(self) -> int:
        """Row groups needed by the matrix's own rows (excludes the
        zero-filled groups ``_equalize_square_pads`` appends)."""
        g = _round_up(max(-(-self.nrows // LANES), 1), self.tile_groups)
        return min(g, self.ngroups)

    @property
    def occupancy(self) -> float:
        """Fraction of data-group value slots holding real nonzeros."""
        return self._nnz / max(self.k_slots * self.ngroups_data * LANES, 1)

    def format_size_bytes(self) -> int:
        """Bytes of the WELL arrays, as the reference counts them (the row
        lists come on top)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.pos, self.w0))


def well_occupancy(a: CSRHost, tile_groups: int = 16) -> float:
    """Predicted storage occupancy of csr_to_well(a) without building the
    arrays (numpy dry run of the packing)."""
    g_, k_, _, _, _, _ = _pack(a, tile_groups, dry_run=True)
    return a.nnz / max(g_ * k_ * LANES, 1)


def split_window(
    a: CSRHost, tile_groups: int, wseg_cap: int
) -> tuple[CSRHost, CSRHost]:
    """Split a into (near, far): per tile of ``tile_groups`` row groups, the
    ``wseg_cap``-segment window covering the most entries keeps them
    (two-pointer over sorted segments); everything outside goes to ``far``,
    the (after reordering, small) remainder applied as compact COO."""
    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols = a.colind.astype(np.int64)
    seg = cols // LANES
    near = np.ones(a.nnz, dtype=bool)
    # CSR rows ascend, so each tile's entries are one contiguous run: its
    # bounds come from the row pointer, and only tiles whose segments span
    # the cap or more are searched
    tile_rows = LANES * tile_groups
    bounds = np.asarray(a.rowptr, dtype=np.int64)[
        np.minimum(np.arange(0, a.nrows + tile_rows, tile_rows), a.nrows)]
    starts, ends = bounds[:-1], bounds[1:]
    starts, ends = starts[ends > starts], ends[ends > starts]
    if len(starts):
        span = (np.maximum.reduceat(seg, starts)
                - np.minimum.reduceat(seg, starts))
        starts, ends = starts[span >= wseg_cap], ends[span >= wseg_cap]
    for e0, e1 in zip(starts.tolist(), ends.tolist()):
        sel = np.arange(e0, e1)
        segs = seg[sel]
        order = np.argsort(segs)
        s_sorted = segs[order]
        # two-pointer max-coverage window of width wseg_cap
        j = np.searchsorted(s_sorted, s_sorted + wseg_cap, side="left")
        counts = j - np.arange(len(s_sorted))
        best = int(np.argmax(counts))
        # 8-align the start so _pack's aligned w0 stays within the cap
        w_lo = (int(s_sorted[best]) // 8) * 8
        keep = (segs >= w_lo) & (segs < w_lo + wseg_cap)
        near[sel[~keep]] = False

    def build(mask):
        return CSRHost.from_coo(rows[mask], cols[mask], a.values[mask],
                                a.nrows, a.ncols, sum_duplicates=False)
    return build(near), build(~near)


def _pair_slots(kg, pre_g, pre_fill, pre_mask, gpad):
    """Greedy complementary-mask pairing of pre-slots (host).

    Per group, first-fit ascending by fill: each unmerged slot grabs the
    first remaining slot whose 128-lane occupancy mask is disjoint. A
    pre-slot owning BOTH endpoint lanes (0 and 127) is excluded, so each
    endpoint belongs to a distinct leg (or padding). Returns (new_local,
    leg, k_new): the merged slot index within its group, which leg (0/1)
    each pre-slot landed on, and the per-group merged slot count.
    Pre-slots are ordered group-major (offset = exclusive cumsum of kg)."""
    n_pre = len(pre_g)
    new_local = np.zeros(n_pre, dtype=np.int64)
    leg = np.zeros(n_pre, dtype=np.int8)
    k_new = np.zeros(gpad, dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(kg)])
    pairable = ~((pre_mask[:, 0] & np.uint64(1)) != 0) | ~(
        (pre_mask[:, 1] >> np.uint64(63)) != 0
    )
    for gg in np.flatnonzero(kg > 1):
        lo, hi = base[gg], base[gg + 1]
        ms = pre_mask[lo:hi]
        ok = pairable[lo:hi]
        idx = np.argsort(pre_fill[lo:hi], kind="stable")
        used = np.zeros(hi - lo, dtype=bool)
        kk = 0
        for ii in range(hi - lo):
            i = idx[ii]
            if used[i]:
                continue
            used[i] = True
            new_local[lo + i] = kk
            if ok[i]:
                cand = (~used) & ok & (
                    ((ms[:, 0] & ms[i, 0]) | (ms[:, 1] & ms[i, 1])) == 0
                )
                j = np.flatnonzero(cand)
                if len(j):
                    used[j[0]] = True
                    new_local[lo + j[0]] = kk
                    leg[lo + j[0]] = 1
            kk += 1
        k_new[gg] = kk
    one = kg == 1
    k_new[one] = 1
    return new_local, leg, k_new


def _pack(a: CSRHost, tile_groups: int, dry_run: bool = False,
          pair: bool = False):
    """Compute the slot packing. Returns (G, K, wseg, w0, nseg_x, scatter)
    where scatter = (g, slot, lane_out, seg_rel, lane_in, vals, sa, sb,
    paired); sa/sb are the (G, K) per-slot leg segments the padding
    endpoint lanes carry (lane 0 reads leg a, lane 127 leg b)."""
    gpad = _round_up(max(-(-a.nrows // LANES), 1), tile_groups)
    n_tiles = gpad // tile_groups

    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols = a.colind.astype(np.int64)
    g = rows // LANES
    lane_out = (rows % LANES).astype(np.int64)
    seg_abs = cols // LANES
    lane_in = (cols % LANES).astype(np.int64)

    # per-(g, seg, row) multiplicity m, then per-(g, seg) block offsets
    order = np.lexsort((lane_out, seg_abs, g))
    g_s, seg_s, lo_s, li_s = g[order], seg_abs[order], lane_out[order], lane_in[order]
    vals_s = a.values[order]
    # m: rank within identical (g, seg, row)
    key_new = np.empty(len(g_s), dtype=bool)
    key_new[:1] = True
    key_new[1:] = (
        (g_s[1:] != g_s[:-1]) | (seg_s[1:] != seg_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    )
    grp_id = np.cumsum(key_new) - 1
    first_of_grp = np.flatnonzero(key_new)
    m = np.arange(len(g_s)) - first_of_grp[grp_id]

    # distinct (g, seg) blocks and their slot widths (max multiplicity + 1)
    blk_new = np.empty(len(g_s), dtype=bool)
    blk_new[:1] = True
    blk_new[1:] = (g_s[1:] != g_s[:-1]) | (seg_s[1:] != seg_s[:-1])
    blk_id = np.cumsum(blk_new) - 1
    nblk = int(blk_id[-1]) + 1 if len(g_s) else 0
    blk_g = g_s[blk_new]
    blk_seg = seg_s[blk_new]
    blk_width = np.zeros(nblk, dtype=np.int64)
    np.maximum.at(blk_width, blk_id, m + 1)

    # per-g exclusive cumsum of widths -> block slot offsets; K = max total
    blk_off = np.zeros(nblk, dtype=np.int64)
    kg = np.zeros(gpad, dtype=np.int64)
    if nblk:
        excl = np.concatenate([[0], np.cumsum(blk_width)[:-1]])
        g_first = np.zeros(nblk, dtype=bool)
        g_first[:1] = True
        g_first[1:] = blk_g[1:] != blk_g[:-1]
        gidx = np.cumsum(g_first) - 1  # dense index of this block's g
        blk_off = excl - excl[np.flatnonzero(g_first)][gidx]
        np.add.at(kg, blk_g, blk_width)
    k = max(int(kg.max()) if len(kg) else 1, 1)

    # windows: per tile min/max referenced segment
    nseg_x = max(_round_up(a.ncols, LANES) // LANES, 1)
    w0 = np.zeros(n_tiles, dtype=np.int64)
    wmax = np.zeros(n_tiles, dtype=np.int64)
    if len(g_s):
        tile_of = (g_s // tile_groups).astype(np.int64)
        w0_full = np.full(n_tiles, np.iinfo(np.int64).max)
        np.minimum.at(w0_full, tile_of, seg_s)
        np.maximum.at(wmax, tile_of, seg_s)
        w0 = np.where(w0_full == np.iinfo(np.int64).max, 0, w0_full)
    # 8-aligned window starts and widths (the reference's TPU DMA tiling;
    # kept so the packed arrays equal the reference's)
    w0 = (w0 // 8) * 8
    wseg = int(max((wmax - w0).max() + 1 if n_tiles else 1, 1))
    wseg = _round_up(wseg, 8)
    # windows may extend past ncols: x is padded so every window stays in
    # bounds (the padding reads zeros)
    nseg_x = max(nseg_x, int(w0.max()) + wseg if n_tiles else wseg)

    pre_slot = blk_off[blk_id] + m if len(g_s) else np.empty(0, np.int64)
    seg_rel = seg_s - w0[(g_s // tile_groups).astype(np.int64)] if len(g_s) else g_s

    # ---- paired slots: merge complementary half-full slots (module doc) ----
    paired = False
    slot = pre_slot
    sa = np.zeros((gpad, k), dtype=np.int64)
    sb = np.zeros((gpad, k), dtype=np.int64)
    if len(g_s):
        base = np.concatenate([[0], np.cumsum(kg)])
        pre_id = base[g_s] + pre_slot              # global pre-slot id
        n_pre = int(base[-1])
        pre_g = np.repeat(blk_g, blk_width)
        pre_seg_rel = np.repeat(
            blk_seg - w0[(blk_g // tile_groups).astype(np.int64)], blk_width
        )
        # per-pre-slot endpoint-lane ownership (lanes 0 and 127)
        pre_mask = np.zeros((n_pre, 2), dtype=np.uint64)
        wrd = (lo_s // 64).astype(np.int64)
        bit = np.uint64(1) << (lo_s % 64).astype(np.uint64)
        np.bitwise_or.at(pre_mask, (pre_id, wrd), bit)
        pre_b0 = (pre_mask[:, 0] & np.uint64(1)) != 0
        pre_b127 = (pre_mask[:, 1] >> np.uint64(63)) != 0
        # per-pre-slot local index within its group (identity = unmerged)
        new_local = np.arange(n_pre) - base[pre_g]
        leg = np.zeros(n_pre, dtype=np.int8)
        if pair:
            pre_fill = np.zeros(n_pre, dtype=np.int64)
            np.add.at(pre_fill, pre_id, 1)
            m_local, m_leg, k_new = _pair_slots(kg, pre_g, pre_fill,
                                                pre_mask, gpad)
            k_merged = max(int(k_new.max()), 1)
            if k_merged < k:
                paired = True
                k = k_merged
                new_local, leg = m_local, m_leg
                slot = new_local[pre_id]
        # per-(g, slot) leg segments + endpoint ownership -> sa/sb: sa is
        # the segment of whichever leg owns lane 0 (either leg when lane 0
        # is padding, then forced by lane 127's owner); sb the other leg's
        seg_leg = np.zeros((gpad, k, 2), dtype=np.int64)
        has_leg1 = np.zeros((gpad, k), dtype=bool)
        b0 = np.zeros((gpad, k, 2), dtype=bool)
        b127 = np.zeros((gpad, k, 2), dtype=bool)
        seg_leg[pre_g, new_local, leg] = pre_seg_rel
        has_leg1[pre_g[leg == 1], new_local[leg == 1]] = True
        b0[pre_g, new_local, leg] = pre_b0
        b127[pre_g, new_local, leg] = pre_b127
        seg0 = seg_leg[:, :, 0]
        seg1 = np.where(has_leg1, seg_leg[:, :, 1], seg0)
        sa = np.where(
            b0[:, :, 0], seg0,
            np.where(b0[:, :, 1], seg1,
                     np.where(b127[:, :, 0], seg1, seg0)),
        )
        sb = seg0 + seg1 - sa

    if dry_run:
        return gpad, k, wseg, w0, nseg_x, None
    return gpad, k, wseg, w0, nseg_x, (
        g_s, slot, lo_s, seg_rel, li_s, vals_s, sa, sb, paired,
    )


def _build_arrays(a: CSRHost, tile_groups: int, max_k: int, dtype,
                  pair: bool = False):
    """Host numpy WELL arrays: returns (values, pos, w0, wseg, nseg_x,
    paired)."""
    gpad, k, wseg, w0, nseg_x, scatter = _pack(a, tile_groups, pair=pair)
    if k > max_k:
        raise ValueError(
            f"WELL packing needs K={k} slots > max_k={max_k}; reorder the "
            "matrix (spmv_torch.reorder.rcm_reorder) or raise max_k"
        )
    g_s, slot, lo_s, seg_rel, li_s, vals_s, sa, sb, paired = scatter

    # int16 positions when the window-relative flat positions fit and the
    # tiles are 16-aligned (the reference's rule, kept so the arrays match)
    pos_dtype = (np.int16 if wseg * LANES <= np.iinfo(np.int16).max
                 and tile_groups % 16 == 0 else np.int32)
    values = np.zeros((k, gpad, LANES), dtype=dtype or a.dtype)
    pos = np.zeros((k, gpad, LANES), dtype=pos_dtype)
    # endpoint-lane invariant: lane 0 carries leg a's segment and lane 127
    # leg b's; real entries overwrite (padding value 0 kills the term)
    pos[...] = (sa.T[:, :, None] * LANES).astype(pos_dtype)
    pos[:, :, LANES - 1] = (sb.T * LANES).astype(pos_dtype)
    if len(g_s):
        values[slot, g_s, lo_s] = vals_s
        pos[slot, g_s, lo_s] = (seg_rel * LANES + li_s).astype(pos_dtype)
    return values, pos, w0.astype(np.int32), wseg, nseg_x, paired


def _equalize_square_pads(values, pos, w0, nseg_x: int, tile_groups: int):
    """For square operators, pad the group axis and x-segment count to a
    common value so nrows_pad == ncols_pad: outputs then chain directly
    into the next apply with no relayout. Zero-valued groups contribute
    nothing."""
    k, g, _ = values.shape
    target = -(-max(g, nseg_x) // tile_groups) * tile_groups
    if target != g:
        padg = target - g
        values = np.pad(values, ((0, 0), (0, padg), (0, 0)))
        pos = np.pad(pos, ((0, 0), (0, padg), (0, 0)))
        w0 = np.concatenate(
            [w0, np.zeros(padg // tile_groups, w0.dtype)])
    return values, pos, w0, target


def _pad_groups(t: torch.Tensor, padg: int, dim: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = padg
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _pad_well_to(w: WellMatrix, target_groups: int) -> WellMatrix:
    """Pad a square-equalized WellMatrix to a larger common group/segment
    count — puts the two triangles of the symmetric dual-WELL form on one
    layout. ``target_groups`` must be a multiple of ``w.tile_groups``."""
    if w.ngroups == target_groups and w.nseg == target_groups:
        return w
    if target_groups % w.tile_groups:
        raise ValueError(f"target_groups={target_groups} must be a multiple "
                         f"of tile_groups={w.tile_groups}")
    padg = target_groups - w.ngroups
    # the appended groups are empty: their slices have width 0
    ptr = w.slice_ptr
    return dataclasses.replace(
        w,
        values=_pad_groups(w.values, padg, 1),
        pos=_pad_groups(w.pos, padg, 1),
        w0=_pad_groups(w.w0, padg // w.tile_groups, 0),
        nseg=target_groups,
        slice_ptr=torch.cat([ptr, ptr[-1:].expand(padg * LANES // SLICE)]),
    )


def csr_to_well(
    a: CSRHost,
    tile_groups: int = 16,
    max_k: int = 64,
    dtype=None,
    pair: bool = False,
    *,
    device="cuda",
) -> WellMatrix:
    """Convert host CSR to WELL on ``device`` (the card unless the caller
    asks for another). ``tile_groups`` is fixed here because ``pos`` is
    window-relative. Raises when a group needs more than ``max_k`` slots.
    ``pair=True`` merges complementary half-full slots (less storage)."""
    dtype = host_dtype(dtype)
    if np.iscomplexobj(a.values) or (dtype is not None
                                     and np.issubdtype(dtype, np.complexfloating)):
        raise ValueError("WELL has no complex kernel; complex operators are "
                         "not ported yet (ROADMAP.md)")
    values, pos, w0, wseg, nseg_x, paired = _build_arrays(
        a, tile_groups, max_k, dtype, pair=pair)
    if a.nrows == a.ncols:
        values, pos, w0, nseg_x = _equalize_square_pads(
            values, pos, w0, nseg_x, tile_groups)
    rows = pack_rows(values[None], pos[None], wseg)
    return WellMatrix(
        values=torch.as_tensor(values, device=device),
        pos=torch.as_tensor(pos, device=device),
        w0=torch.as_tensor(w0, device=device),
        nrows=a.nrows,
        ncols=a.ncols,
        wseg=wseg,
        tile_groups=tile_groups,
        nseg=nseg_x,
        _nnz=a.nnz,
        paired=paired,
        rows_values=torch.as_tensor(rows.values[0], device=device),
        rows_pos=torch.as_tensor(rows.pos[0], device=device),
        slice_ptr=torch.as_tensor(rows.slice_ptr[0], device=device),
    )


@dataclasses.dataclass
class SymWellMatrix:
    """Symmetric general-sparsity format: A = L + D + L^T with the strict
    lower triangle L stored as a WELL operator and its transpose L^T
    pre-built as a second one, so the symmetric apply is two gather kernels
    plus a diagonal product, with no scatter on the hot path. Each
    triangle carries its own far remainder (entries outside its window
    split), empty after RCM for most matrices: as compact COO, the
    reference's form, and as an ELL rectangle, which the apply gathers."""

    lower: WellMatrix
    upper: WellMatrix
    diag: torch.Tensor         # (nrows_pad,) dense diagonal
    farl: tuple | None         # (rows, cols, vals) of the lower far part
    faru: tuple | None         # same for the transposed part
    nrows: int
    farl_ell: tuple | None = None  # (cols, vals) (nrows_pad, Kf) of farl
    faru_ell: tuple | None = None

    @property
    def nrows_pad(self) -> int:
        return self.lower.nrows_pad

    @property
    def nnz_stored(self) -> int:
        nl = self.lower.nnz_stored + self.upper.nnz_stored
        nf = sum(0 if f is None else f[0].numel() for f in (self.farl, self.faru))
        return nl + nf + self.diag.numel()

    def format_size_bytes(self) -> int:
        total = self.lower.format_size_bytes() + self.upper.format_size_bytes()
        total += self.diag.numel() * self.diag.element_size()
        for far in (self.farl, self.faru, self.farl_ell, self.faru_ell):
            if far is not None:
                total += sum(t.numel() * t.element_size() for t in far)
        return total


def _far_coo(far: CSRHost, dtype, device, nrows_pad: int):
    """A far remainder as a compact COO triple (rows, cols int64; values)
    and as an ELL rectangle (cols int64, values) of nrows_pad rows; (None,
    None) when empty."""
    if far.nnz == 0:
        return None, None
    rows = np.repeat(np.arange(far.nrows, dtype=np.int64), far.row_nnz())
    cols = far.colind.astype(np.int64)
    vals = far.values.astype(dtype or far.dtype)
    ell = coo_ell(rows[None], cols[None], vals[None], nrows_pad)
    return (tuple(torch.as_tensor(t, device=device) for t in (rows, cols, vals)),
            tuple(torch.as_tensor(t[0], device=device) for t in ell))


def csr_to_well_sym(
    a: CSRHost,
    tile_groups: int = 16,
    max_k: int = 64,
    dtype=None,
    wseg_cap: int = 512,
    *,
    device="cuda",
) -> SymWellMatrix:
    """Convert a (full) symmetric host CSR to the dual-WELL symmetric format
    on ``device``. Only the lower triangle of ``a`` is read."""
    if a.nrows != a.ncols:
        raise ValueError("symmetric storage requires a square matrix")
    dtype = host_dtype(dtype)
    lower, diag = a.split_lower_diag()
    upper_full = lower.transpose()
    near_l, far_l = split_window(lower, tile_groups, wseg_cap)
    near_u, far_u = split_window(upper_full, tile_groups, wseg_cap)
    wl = csr_to_well(near_l, tile_groups, max_k, dtype, device=device)
    wu = csr_to_well(near_u, tile_groups, max_k, dtype, device=device)
    # both triangles at one common pad so yl + yu + diag*x need no relayout
    tgt = max(wl.ngroups, wu.ngroups)
    wl, wu = _pad_well_to(wl, tgt), _pad_well_to(wu, tgt)
    dpad = np.zeros(wl.nrows_pad, dtype=dtype or a.dtype)
    dpad[: len(diag)] = diag
    farl, farl_ell = _far_coo(far_l, dtype, device, wl.nrows_pad)
    faru, faru_ell = _far_coo(far_u, dtype, device, wl.nrows_pad)
    return SymWellMatrix(
        lower=wl,
        upper=wu,
        diag=torch.as_tensor(dpad, device=device),
        farl=farl,
        faru=faru,
        nrows=a.nrows,
        farl_ell=farl_ell,
        faru_ell=faru_ell,
    )
