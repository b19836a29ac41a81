"""DistMatrix — the row-block distributed matrix, every shard stacked on the
leading axis of one device.

Counterpart of ``spmv_tpu.parallel.dist_matrix`` for ``local_format``
"ell", "dia", "well" and "auto", square, symmetric or vanilla. The
reference stacks each
shard's local/remote blocks along a device-mesh axis and runs ``matvec``
inside ``shard_map``; here the same stacked arrays live on one torch device
(``n_devices`` keeps its name and counts the stacked shards) and ``matvec``
works on all shards at once:

    ghosts = halo_gather(x)            # one roll per plan round
    y  = local_block @ x               # DIA/WELL kernel, one launch for D
    y += remote_block @ ghosts         # ELL gather over the ghost buffer

The symmetric path stores the strict lower triangle plus diagonal; ghost
column contributions return to their owners through the reverse plan. The
symmetric WELL form ("dual-WELL") also stores the local block's transpose
as a second WELL stack, so its local apply is two gather launches plus the
diagonal product, with no scatter.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from spmv_torch.formats.csr import CSRHost
from spmv_torch.formats.dia import LANES, host_dtype
from spmv_torch.formats.well import _build_arrays, _pack, split_window
from spmv_torch.ops.spmv_dia_cuda import MAX_DIAGS, spmv_dia_stacked
from spmv_torch.ops.spmv_well import far_add
from spmv_torch.ops.spmv_well_cuda import spmv_well_stacked
from spmv_torch.parallel.comm_plan import (
    CommPlan,
    compile_plan,
    halo_gather,
    halo_scatter_add,
)
from spmv_torch.parallel.partition import ShardCSR, owner_ranges, partition_csr

LOCAL_FORMATS = ("ell", "dia", "well", "auto")
# the reference's double-single formats, which "auto" picks for float64
# input; not ported yet
DS_FORMATS = ("dia_ds", "well_ds")
# a stacked (D, R, K) ELL block larger than this means a degree-skewed
# matrix that row-uniform storage cannot hold; assembly raises instead
ELL_BYTES_CAP = 4e9
# WELL: entries outside each tile's best window of this many 128-wide
# segments form the far remainder; a group may hold at most this many slots
WELL_WSEG_CAP = 512
WELL_MAX_K = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stack_ell(
    blocks: list[CSRHost], nrows_pad: int, k: int, dtype=None
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-shard CSR blocks into (D, nrows_pad, k) ELL arrays."""
    d = len(blocks)
    colind = np.zeros((d, nrows_pad, k), dtype=np.int32)
    values = np.zeros((d, nrows_pad, k), dtype=dtype or blocks[0].dtype)
    for s, b in enumerate(blocks):
        lens = b.row_nnz()
        if b.nnz == 0:
            continue
        rows = np.repeat(np.arange(b.nrows), lens)
        slot = np.arange(b.nnz) - np.repeat(b.rowptr[:-1], lens)
        colind[s, rows, slot] = b.colind
        values[s, rows, slot] = b.values
    return colind, values


@dataclasses.dataclass
class DistMatrix:
    """Row-block-sharded sparse matrix, D shards stacked on one device.

    local_colind/local_values: (D, R, Kl) ELL local block ("ell" only)
    remote_colind/remote_values: (D, R, Kr) ELL over the ghost buffer
    diagonal: (D, R) when symmetric
    jacobi_diag: (D, R) dense diagonal (preconditioning)
    local_dia_data: (D, R/128, Kd*128) interleaved DIA local block ("dia")
    local_well_*: (D, Kw, G, 128) values and int32 pos, (D, G/tg) int32 w0
        of the stacked WELL local block ("well"; G*128 == R), well_meta =
        (k_slots, wseg, tile_groups, paired)
    far_rows/cols/vals: (D, F) compact COO of the window split's far
        remainder (padding slots are (0, 0, 0.0)), None when every shard's
        is empty
    local_wellT_*, wellT_meta, farT_*: the same for the transpose of the
        local strict lower triangle (symmetric "well")
    """

    local_colind: torch.Tensor | None
    local_values: torch.Tensor | None
    remote_colind: torch.Tensor
    remote_values: torch.Tensor
    diagonal: torch.Tensor | None
    jacobi_diag: torch.Tensor
    plan: CommPlan
    nrows_global: int
    ncols_global: int
    row_pad: int
    symmetric: bool
    nnz_global: int
    local_format: str = "ell"
    local_dia_data: torch.Tensor | None = None
    dia_offsets: tuple[int, ...] = ()
    local_well_values: torch.Tensor | None = None
    local_well_pos: torch.Tensor | None = None
    local_well_w0: torch.Tensor | None = None
    well_meta: tuple = ()
    far_rows: torch.Tensor | None = None
    far_cols: torch.Tensor | None = None
    far_vals: torch.Tensor | None = None
    well_far_nnz: int = 0
    local_wellT_values: torch.Tensor | None = None
    local_wellT_pos: torch.Tensor | None = None
    local_wellT_w0: torch.Tensor | None = None
    wellT_meta: tuple = ()
    farT_rows: torch.Tensor | None = None
    farT_cols: torch.Tensor | None = None
    farT_vals: torch.Tensor | None = None
    well_farT_nnz: int = 0

    @property
    def n_devices(self) -> int:
        """Number of stacked shards."""
        return self.plan.n_devices

    @property
    def col_pad(self) -> int:
        """Per-shard padded input (column-side) vector length."""
        return self.plan.nlocal_pad

    @property
    def dtype(self) -> torch.dtype:
        return self.remote_values.dtype

    @property
    def device(self) -> torch.device:
        return self.remote_values.device

    def format_size_bytes(self) -> int:
        """Device bytes held by the matrix's arrays (the plan tables and the
        Jacobi diagonal excluded, as in the reference)."""
        return sum(
            t.numel() * t.element_size()
            for name, t in vars(self).items()
            if isinstance(t, torch.Tensor) and name != "jacobi_diag")

    @property
    def row_lane_rows(self) -> int:
        """Per-shard output-vector rows in the (rows, 128) lane layout."""
        return self.row_pad // LANES

    # ----- vector layout (square: the row and column sides coincide) -----
    def to_dist(self, x_global: np.ndarray) -> torch.Tensor:
        """Scatter a host global vector into the stacked lane layout
        (D*pad/128, 128) on this matrix's device."""
        ranges = owner_ranges(self.nrows_global, self.n_devices)
        out = np.zeros((self.n_devices, self.row_pad), dtype=x_global.dtype)
        for s in range(self.n_devices):
            r0, r1 = int(ranges[s]), int(ranges[s + 1])
            out[s, : r1 - r0] = x_global[r0:r1]
        arr = out.reshape(self.n_devices * self.row_lane_rows, LANES)
        return torch.as_tensor(arr, device=self.device)

    def from_dist(self, x: torch.Tensor) -> np.ndarray:
        """Gather the stacked lane layout back to a host global vector."""
        ranges = owner_ranges(self.nrows_global, self.n_devices)
        mat = x.detach().cpu().numpy().reshape(self.n_devices, self.row_pad)
        return np.concatenate(
            [mat[s, : int(ranges[s + 1] - ranges[s])] for s in range(self.n_devices)]
        )

    # ----- distributed SpMV -----
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: x and y in the stacked lane layout (D*pad/128, 128)."""
        return _stacked_mult(self, x)

    def as_linear_operator(self):
        """Closure for solvers: matvec on the stacked padded layout."""
        return lambda p: self.matvec(p)

    def jacobi_preconditioner(self):
        """z = r / diag(A) closure for cg(preconditioner=...). Zero diagonal
        entries (and padding slots) pass through unscaled."""
        d2 = self.jacobi_diag.reshape(self.n_devices * self.row_lane_rows, LANES)
        nz = d2 != 0
        safe = torch.where(nz, d2, torch.ones_like(d2))

        def apply(r):
            return torch.where(nz, r / safe, r)

        return apply


def _stacked_mult(A: DistMatrix, x2: torch.Tensor) -> torch.Tensor:
    """All shards' y = A_s @ x at once (the reference's ``_shard_mult``,
    ell and dia branches, run over the stacked shard axis)."""
    nd, plan = A.n_devices, A.plan
    x = x2.reshape(nd, A.col_pad)
    have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
    if have_ghosts:
        ghosts = halo_gather(x, plan.send_idx, plan.recv_pos, plan.rounds,
                             plan.nghost_pad)
    if A.local_format == "dia":
        # symmetric: the DIA block stores offsets <= 0 (incl. the diagonal)
        # and applies L + D + L^T of the local block itself
        y = spmv_dia_stacked(A.local_dia_data, x2, A.dia_offsets,
                             A.symmetric).reshape(nd, A.row_pad)
    elif A.local_format == "well":
        y = spmv_well_stacked(A.local_well_values, A.local_well_pos,
                              A.local_well_w0, x2,
                              A.well_meta[2]).reshape(nd, A.row_pad)
        if A.far_rows is not None:
            far_add(y, A.far_rows, A.far_cols, A.far_vals, x)
    else:
        y = _ell_apply(A.local_colind, A.local_values, x)
    if have_ghosts:
        y = y + _ell_apply(A.remote_colind, A.remote_values, ghosts)
    if A.symmetric:
        if A.local_format == "well":
            # dual-WELL: the local transpose term L^T x is a second gather
            # launch over the pre-built transpose stack
            y = y + spmv_well_stacked(A.local_wellT_values, A.local_wellT_pos,
                                      A.local_wellT_w0, x2,
                                      A.wellT_meta[2]).reshape(nd, A.row_pad)
            y = y + A.diagonal * x
            if A.farT_rows is not None:
                far_add(y, A.farT_rows, A.farT_cols, A.farT_vals, x)
        elif A.local_format != "dia":
            y = y + A.diagonal * x
            # transpose contributions to owned columns
            contrib = A.local_values * x[:, :, None]
            y = y.scatter_add(1, A.local_colind.reshape(nd, -1),
                              contrib.reshape(nd, -1))
        if have_ghosts:
            # contributions to ghost columns -> reverse exchange to owners
            gcontrib = A.remote_values * x[:, :, None]
            gz = x.new_zeros((nd, plan.nghost_pad)).scatter_add(
                1, A.remote_colind.reshape(nd, -1), gcontrib.reshape(nd, -1))
            y = halo_scatter_add(gz, y, plan.send_idx, plan.recv_pos,
                                 plan.rounds)
    return y.reshape(nd * A.row_lane_rows, LANES)


def _ell_apply(colind: torch.Tensor, values: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """Per-shard ELL product: colind/values (D, R, K), src (D, n) -> (D, R)."""
    nd, r, k = colind.shape
    g = torch.gather(src, 1, colind.reshape(nd, r * k)).reshape(nd, r, k)
    return (values * g).sum(-1)


def _assemble(
    shards: list[ShardCSR],
    col_ranges: np.ndarray,
    nrows_global: int,
    ncols_global: int,
    nnz_global: int,
    symmetric: bool,
    dtype,
    row_align: int,
    local_format: str,
    device,
) -> DistMatrix:
    """Compile the (column-side) CommPlan, stack the ELL/DIA/WELL blocks on
    the host, and move everything to ``device`` once."""
    nd = len(shards)
    well = None
    if local_format == "well":
        well = _stack_well(shards, symmetric, dtype)
        # the shared per-shard pad is exactly the WELL geometry's G*128
        row_align = well["gt"] * LANES
    plan = compile_plan(col_ranges, [s.ghosts for s in shards],
                        row_align=row_align, device=device)
    row_pad = max(
        _round_up(max(s.row_range[1] - s.row_range[0] for s in shards), row_align),
        row_align,
    )
    r = row_pad

    dia_data = None
    dia_offsets: tuple[int, ...] = ()
    if local_format == "dia":
        # union of diagonal offsets across shards; per-shard data stacked to
        # (D, Kd, R) with absent diagonals all-zero
        per_shard = []
        all_offs = []
        for sh in shards:
            loc = sh.local
            lens = loc.row_nnz()
            rows = np.repeat(np.arange(loc.nrows, dtype=np.int64), lens)
            offs = loc.colind.astype(np.int64) - rows
            vals = loc.values
            if symmetric:
                # symmetric shards keep the diagonal separately; fold it in
                # as offset 0 so the symmetric DIA block holds offsets <= 0
                drows = np.arange(sh.nlocal, dtype=np.int64)
                rows = np.concatenate([rows, drows])
                offs = np.concatenate([offs, np.zeros_like(drows)])
                vals = np.concatenate([vals, sh.diagonal])
            per_shard.append((rows, offs, vals))
            all_offs.append(np.unique(offs))
        union = np.unique(np.concatenate(all_offs)) if all_offs else np.array([0])
        if len(union) > MAX_DIAGS:
            raise ValueError(
                f"local blocks have {len(union)} distinct diagonals "
                f"(> {MAX_DIAGS}, the DIA kernels' limit); local_format='dia' "
                "is for banded/stencil operators"
            )
        kd = max(len(union), 1)
        dd = np.zeros((nd, kd, r), dtype=dtype or shards[0].local.dtype)
        for s, (rows, offs, vals) in enumerate(per_shard):
            if len(rows) == 0:
                continue
            dsel = np.searchsorted(union, offs)
            flat = dsel * np.int64(r) + rows
            acc = np.bincount(flat, weights=vals, minlength=kd * r)
            dd[s] += acc.reshape(kd, r).astype(dd.dtype)
        # row-interleaved device layout (see DiaMatrix.data)
        dia_data = (dd.reshape(nd, kd, r // LANES, LANES)
                    .transpose(0, 2, 1, 3)
                    .reshape(nd, r // LANES, kd * LANES))
        dia_offsets = tuple(int(o) for o in union)

    kl = max(max((int(s.local.row_nnz().max()) if s.local.nnz else 0) for s in shards), 1)
    kr = max(max((int(s.remote.row_nnz().max()) if s.remote.nnz else 0) for s in shards), 1)
    # hard ELL memory ceiling: a degree-skewed matrix inflates every row of
    # a stacked (D, R, K) ELL block to the max row nnz — fail loudly
    itemsize = np.dtype(dtype or shards[0].local.dtype).itemsize
    for tag, k, used in (("local", kl, local_format == "ell"),
                         ("remote", kr, True)):
        nbytes = float(nd) * r * k * (itemsize + 4)
        if used and nbytes > ELL_BYTES_CAP:
            raise ValueError(
                f"stacked {tag} ELL block would allocate {nbytes/1e9:.1f} GB "
                f"(K={k} slots x {nd}x{r} rows) > {ELL_BYTES_CAP/1e9:.1f} GB "
                "— the matrix is degree-skewed for row-uniform storage"
            )
    lci = lv = None
    if local_format == "ell":
        lci, lv = _stack_ell([s.local for s in shards], r, kl, dtype=dtype)
    rci, rv = _stack_ell([s.remote for s in shards], r, kr, dtype=dtype)
    vdtype = rv.dtype

    diag = None
    if symmetric:
        diag = np.zeros((nd, r), dtype=vdtype)
        for s, sh in enumerate(shards):
            diag[s, : sh.nlocal] = sh.diagonal

    # dense diagonal for Jacobi preconditioning (vanilla storage keeps the
    # diagonal inside the local block; extract it once, host-side)
    jd = np.zeros((nd, r), dtype=vdtype)
    if symmetric:
        jd[:] = diag
    else:
        for s, sh in enumerate(shards):
            loc = sh.local
            rows = np.repeat(np.arange(loc.nrows), loc.row_nnz())
            on_diag = loc.colind == rows
            jd[s, rows[on_diag]] = loc.values[on_diag]

    def put(arr, dt=None):
        return None if arr is None else torch.as_tensor(
            np.ascontiguousarray(arr), dtype=dt, device=device)

    well_fields = {}
    if well is not None:
        for tag in ("", "T"):
            if f"well{tag}" not in well:
                continue
            v, p, w0, meta = well[f"well{tag}"]
            rows, cols, vals, nnz = well[f"far{tag}"]
            well_fields.update({
                f"local_well{tag}_values": put(v),
                f"local_well{tag}_pos": put(p),
                f"local_well{tag}_w0": put(w0),
                f"well{tag}_meta": meta,
                f"far{tag}_rows": put(rows, torch.int64),
                f"far{tag}_cols": put(cols, torch.int64),
                f"far{tag}_vals": put(vals),
                f"well_far{tag}_nnz": nnz,
            })

    return DistMatrix(
        local_colind=put(lci, torch.int64),
        local_values=put(lv),
        remote_colind=put(rci, torch.int64),
        remote_values=put(rv),
        diagonal=put(diag),
        jacobi_diag=put(jd),
        plan=plan,
        nrows_global=nrows_global,
        ncols_global=ncols_global,
        row_pad=row_pad,
        symmetric=symmetric,
        nnz_global=nnz_global,
        local_format=local_format,
        local_dia_data=put(dia_data),
        dia_offsets=dia_offsets,
        **well_fields,
    )


def _far_coo_stack(blocks: list[CSRHost], dtype):
    """Per-shard far remainders as (D, F) compact COO (rows, cols, vals,
    F = the largest shard's far nnz); all None when every one is empty."""
    fmax = max((b.nnz for b in blocks), default=0)
    if fmax == 0:
        return None, None, None, 0
    nd = len(blocks)
    rows = np.zeros((nd, fmax), dtype=np.int32)
    cols = np.zeros((nd, fmax), dtype=np.int32)
    vals = np.zeros((nd, fmax), dtype=dtype or blocks[0].dtype)
    for s, b in enumerate(blocks):
        if b.nnz == 0:
            continue
        rows[s, : b.nnz] = np.repeat(np.arange(b.nrows, dtype=np.int32),
                                     b.row_nnz())
        cols[s, : b.nnz] = b.colind
        vals[s, : b.nnz] = b.values
        # padding slots stay (row 0, col 0, val 0): they add 0.0
    return rows, cols, vals, fmax


def _stack_well(shards: list[ShardCSR], symmetric: bool, dtype) -> dict:
    """The WELL branch of the reference's ``_assemble`` (plain "well"):
    per shard, split the local block into its near window and far
    remainder, pack the near part, and stack every shard on one padded
    geometry (D, K, G, 128); symmetric also packs and stacks the local
    block's transpose. Returns {"gt": G, "well": (values, pos, w0, meta),
    "far": (rows, cols, vals, F)} plus "wellT"/"farT" when symmetric."""
    nd = len(shards)
    max_groups = max(-(-(s.row_range[1] - s.row_range[0]) // LANES)
                     for s in shards)
    tg = next(t for t in (64, 32, 16, 8, 4, 2, 1) if t <= max_groups)
    blocks = {"": [s.local for s in shards]}
    if symmetric:
        blocks["T"] = [s.local.transpose() for s in shards]
    # K*tg <= 1024 is the reference's TPU VMEM envelope (its kernel holds a
    # K*tg-row gather temporary); kept only so the stacked arrays equal the
    # reference's: high-K matrices repack at a smaller tile until they fit
    while True:
        packed = {}
        for tag, bl in blocks.items():
            splits = [split_window(b, tile_groups=tg, wseg_cap=WELL_WSEG_CAP)
                      for b in bl]
            packed[tag] = ([_build_arrays(near, tg, WELL_MAX_K, dtype)
                            for near, _ in splits],
                           [far for _, far in splits])
        k_all = max(v.shape[0] for ws, _ in packed.values() for v, *_ in ws)
        if k_all * tg <= 1024 or tg <= 1:
            break
        tg = max(tg // 2, 1)
    # one padded geometry for every shard: groups cover the rows, every
    # window (w0 + wseg) and the owned column span (x and y share the
    # per-shard padded length), for both stacks when symmetric
    need = max(-(-(s.col_range[1] - s.col_range[0]) // LANES) for s in shards)
    for ws, _ in packed.values():
        wseg = max(w[3] for w in ws)
        need = max(need, max(w[0].shape[1] for w in ws),
                   max((int(w[2].max()) if len(w[2]) else 0) for w in ws) + wseg)
    gt = -(-need // tg) * tg
    out = {"gt": gt}
    for tag, (ws, fars) in packed.items():
        k = max(w[0].shape[0] for w in ws)
        sv = np.zeros((nd, k, gt, LANES), dtype=ws[0][0].dtype)
        sp = np.zeros((nd, k, gt, LANES), dtype=np.int32)
        s0 = np.zeros((nd, gt // tg), dtype=np.int32)
        for s, (v, p, w0, _, _, _) in enumerate(ws):
            sv[s, : v.shape[0], : v.shape[1]] = v
            sp[s, : p.shape[0], : p.shape[1]] = p
            s0[s, : len(w0)] = w0
        meta = (k, max(w[3] for w in ws), tg, any(w[5] for w in ws))
        out[f"well{tag}"] = (sv, sp, s0, meta)
        out[f"far{tag}"] = _far_coo_stack(fars, dtype)
    return out


def _hub_split(a: CSRHost) -> CSRHost:
    """The reference's ``hub_cap="auto"`` degree-skew decision
    (``_hub_split``): rows whose nnz exceeds the cap would leave the
    row-uniform formats. The hub block is not ported yet, so a matrix that
    would split raises; near-uniform degrees (every Laplacian) never split
    and pass through unchanged."""
    if a.nnz == 0:
        return a
    d = a.row_nnz()
    kmax = int(d.max())
    p99 = float(np.percentile(d, 99)) if a.nrows else 0.0
    if kmax <= max(64, 4 * p99):
        return a
    # past this gate the reference's cost model always finds a cap below
    # kmax (its smallest candidate is 8), so it splits
    raise NotImplementedError(
        f"a row with {kmax} nonzeros would move to a hub block, which is not "
        "ported yet (ROADMAP.md); pass hub_cap=None to keep every row in the "
        "row-uniform format")


def _wants_ds(a: CSRHost, dtype) -> bool:
    """float64 values (asked for, or the CSR's own): the reference's auto
    choice routes them to the double-single formats."""
    return np.dtype(dtype if dtype is not None else a.values.dtype) == np.float64


def select_local_format(a: CSRHost, symmetric: bool = False,
                        dtype=None) -> str:
    """The reference's automatic local-format choice (numpy gate):

      dia  — banded/stencil operators (at most 64 distinct diagonals);
      well — general sparsity whose columns stay window-local (the far
             remainder at most a quarter of the entries, occupancy at least
             0.02, K <= 64, and WELL storage at most 8x the ELL fallback's
             and 4 GB); symmetric matrices use the dual-WELL form;
      ell  — everything else.

    float64 input routes to the double-single variants ``dia_ds`` (vanilla
    banded) and ``well_ds``, as in the reference; ``build_dist_matrix``
    raises for those, since they are not ported yet.
    """
    dtype = host_dtype(dtype)
    want_ds = _wants_ds(a, dtype)
    if a.nnz == 0:
        return "ell"
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    offs = a.colind.astype(np.int64) - rows
    if a.nrows == a.ncols and len(np.unique(offs)) <= MAX_DIAGS:
        return "dia_ds" if want_ds and not symmetric else "dia"
    try:
        near, far = split_window(a, tile_groups=8, wseg_cap=WELL_WSEG_CAP)
        if far.nnz > 0.25 * a.nnz:
            return "ell"
        g_, k_, _, _, _, _ = _pack(near, 8, dry_run=True)
        occupancy = near.nnz / max(g_ * k_ * LANES, 1)
        if occupancy < 0.02:
            return "ell"
        itemsize = 8 if want_ds else np.dtype(dtype or np.float32).itemsize
        well_bytes = g_ * k_ * LANES * (itemsize + 2)  # values + int16 pos
        ell_bytes = a.nrows * int(a.row_nnz().max()) * (itemsize + 4)
        if k_ <= WELL_MAX_K and well_bytes <= 8 * ell_bytes and well_bytes <= 4e9:
            return "well_ds" if want_ds else "well"
        warnings.warn(
            f"WELL packing would store {well_bytes/1e6:.0f} MB vs "
            f"{ell_bytes/1e6:.0f} MB for ELL (occupancy {occupancy:.3f}); "
            "falling back to ELL — consider RCM reordering "
            "(spmv_torch.reorder) to raise occupancy", stacklevel=2)
    except ValueError:
        pass
    return "ell"


def _dia_row_align(local_format: str, max_rows_per_shard: int) -> int:
    # distributed vectors live in the (rows, 128) lane layout
    if local_format != "dia":
        return LANES
    # the reference's TPU tile constraints; kept so the padded layout (and
    # every stacked array) matches the reference's
    return 1024 * LANES if max_rows_per_shard > 1_000_000 else 1024


def build_dist_matrix(
    a: CSRHost,
    n_devices: int = 1,
    symmetric: bool = False,
    dtype=None,
    local_format: str = "ell",
    hub_cap="auto",
    *,
    device="cuda",
) -> DistMatrix:
    """Assemble a DistMatrix from a global host CSR: partition rows into
    ``n_devices`` shards, classify local/remote(/diagonal) entries, compile
    the halo plan, and move the stacked blocks to ``device`` (the card
    unless the caller asks for another).

    ``local_format``: "ell", "dia" (square only), "well" (square only) or
    "auto" (``select_local_format``; float64 input selects the
    double-single formats, which raise NotImplementedError). ``dtype``:
    value dtype (numpy or torch), default the CSR's. ``hub_cap="auto"``
    runs the reference's degree-skew decision and raises where it would
    split (not ported); ``None`` keeps every row in the row-uniform format.
    """
    if local_format not in LOCAL_FORMATS:
        raise ValueError(
            f"local_format {local_format!r} is not ported yet (ported: "
            f"{', '.join(LOCAL_FORMATS)}); see ROADMAP.md")
    if hub_cap not in ("auto", None):
        raise ValueError(f"hub_cap must be 'auto' or None, got {hub_cap!r}")
    dtype = host_dtype(dtype)
    if (hub_cap == "auto" and not symmetric
            and (local_format != "auto" or not _wants_ds(a, dtype))):
        a = _hub_split(a)
    if local_format == "auto":
        local_format = select_local_format(a, symmetric=symmetric, dtype=dtype)
        if local_format in DS_FORMATS:
            raise NotImplementedError(
                f"local_format='auto' selects {local_format!r} for float64 "
                "input, as the reference does; the double-single formats are "
                "not ported yet (ROADMAP.md). Pass local_format='well', "
                "'dia' or 'ell' to run float64 in a plain format")
    if local_format == "dia" and a.nrows != a.ncols:
        raise ValueError("local_format='dia' requires a square matrix")
    if a.nrows != a.ncols:
        raise NotImplementedError("rectangular operators are not ported yet "
                                  "(ROADMAP.md)")
    row_align = _dia_row_align(local_format, -(-a.nrows // n_devices))
    shards = partition_csr(a, n_devices, symmetric=symmetric)
    return _assemble(
        shards, owner_ranges(a.nrows, n_devices), a.nrows, a.ncols, a.nnz,
        symmetric, dtype, row_align, local_format, device,
    )
