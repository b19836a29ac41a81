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
as a second WELL stack, and one launch applies both stacks and the
diagonal. The WELL kernels, single-RHS and block, read each
stack's warp-sliced row lists (``formats/well.pack_rows``); the WELL
arrays they are derived from stay on the host.

No term sums with atomics, so an apply gives the same bits on every run:
the far remainders, the symmetric transpose of the local ELL block and
the ghost-column contributions are ELL rectangles built on the host and
applied as gathers, and the reverse exchange places each round's values
(its owned indices are unique) before one dense add.

``matmat`` / ``matmat_ds`` apply a block of nrhs vectors in the SpMM lane
layout (D*pad/128, nrhs*128): the local block runs a block kernel that
reads the matrix once for the whole block, and the halo moves the block
whole, one gather (and one reverse set) per round for every column.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from spmv_torch.ds import ds_add, ds_from_f64, ds_mul_f32
from spmv_torch.formats.csr import CSRHost, coo_ell, ell_transpose
from spmv_torch.formats.dia import LANES, host_dtype, shift_transpose
from spmv_torch.formats.well import _build_arrays, _pack, pack_rows, split_window
from spmv_torch.ops.spmm_dia import spmm_from_layout, to_lanes
from spmv_torch.ops.spmm_dia_cuda import spmm_dia_stacked
from spmv_torch.ops.spmm_well_cuda import spmm_well_ds_stacked, spmm_well_stacked
from spmv_torch.ops.spmv_dia_cuda import spmv_dia_stacked
from spmv_torch.ops.spmv_dia_ds_cuda import MAX_DIAGS as DS_MAX_DIAGS
from spmv_torch.ops.spmv_dia_ds_cuda import spmm_dia_ds_stacked, spmv_dia_ds_stacked
from spmv_torch.ops.spmv_well_cuda import spmv_well_stacked, spmv_well_sym_stacked
from spmv_torch.ops.spmv_well_ds_cuda import spmv_well_ds_stacked
from spmv_torch.parallel.comm_plan import (
    CommPlan,
    compile_plan,
    expand_index,
    halo_gather,
    halo_scatter_add,
    halo_scatter_add_ds,
)
from spmv_torch.parallel.partition import ShardCSR, owner_ranges, partition_csr
from spmv_torch.utils.profiling import profile_region

# "dia_ds" and "well_ds" are the double-single (float64-class) formats,
# which "auto" picks for float64 input
LOCAL_FORMATS = ("ell", "dia", "dia_ds", "well", "well_ds", "auto")
# a stacked (D, R, K) ELL block larger than this means a degree-skewed
# matrix that row-uniform storage cannot hold; assembly raises instead
ELL_BYTES_CAP = 4e9
# WELL: entries outside each tile's best window of this many 128-wide
# segments form the far remainder; a group may hold at most this many slots
WELL_WSEG_CAP = 512
WELL_MAX_K = 64
# "auto" picks DIA for at most this many distinct diagonals
DIA_MAX_DIAGS = 64
# hub rows are summed in chunks of this many entries (``_attach_hubs``)
HUB_CHUNK = 64

# host seconds of assembly, by phase, summed over the process's builds:
# "partition" (partition_csr, compile_plan), "pack" (the stacked host
# arrays: DIA/WELL/ELL blocks, transposes, diagonals), "upload" (the
# copies to the device)
build_seconds = {"partition": 0.0, "pack": 0.0, "upload": 0.0}
# the bytes one ``matvec`` of the newest assembled operator reads, under its
# local format (one key): its device arrays, the halo plan's tables where
# it exchanges, x once and y once (``_layout_bytes``)
layout_bytes: dict = {}


def _lap(phase: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``phase``; returns now."""
    t = time.perf_counter()
    build_seconds[phase] += t - t0
    return t


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
    localT_colind/localT_values: (D, R, Kt) ELL of the local block's
        transpose (symmetric "ell"), the gather form of its transpose term
    local_well_*: (D, Kw, G, 128) values and int32 pos, (D, G/tg) int32 w0
        of the stacked WELL local block ("well"; G*128 == R), well_meta =
        (k_slots, wseg, tile_groups, paired); values and pos stay on the
        host (the kernels read the row lists)
    far_rows/cols/vals: (D, F) compact COO of the window split's far
        remainder (padding slots are (0, 0, 0.0)), None when every shard's
        is empty; far_ell_colind/far_ell_values: the same entries as a
        (D, R, Kf) ELL rectangle, which the apply reads
    local_wellT_*, wellT_meta, farT_*: the same for the transpose of the
        local strict lower triangle (symmetric "well")
    local_rows_values/pos/ptr, local_rowsT_*: the row lists of the two WELL
        stacks (formats/well.pack_rows), (D, E) values and int16/int32 pos,
        (D, G*4 + 1) int64 slice pointers; the WELL kernels read them
    remoteT_colind/remoteT_vals: (D, nghost_pad, Kg) ELL of the remote
        block's transpose over the ghost slots (every symmetric operator
        with ghosts), the gather form of the ghost-column contributions

    hub_colind/hub_values: (D, Cn, Kc) ELL over chunks of at most
        HUB_CHUNK entries of the hub rows (rows with more nonzeros than the
        hub cap, split out of the row-uniform formats), columns in the
        padded-global input numbering (shard*col_pad + local column);
        hub_chunks: (D, H, C) int64 each hub row's chunks (pad = Cn);
        hub_slot: (D, R) int64 row -> hub-row slot (H = none); hub_nnz
        counts the hub entries

    Rectangular operators ("ell" only) partition columns by
    ``owner_ranges(ncols, D)``: x has ``col_pad`` entries per shard and y
    ``row_pad``.

    Double-single ("dia_ds", "well_ds"): every value array above holds the
    float32 hi plane and ``<name>_lo`` the lo plane. "well_ds" keeps its
    far remainders as ELL rectangles: local_colind/local_values (D, R, Kf)
    and farT_cols/farT_vals (D, R, KfT); its remoteT_vals carry a lo plane.
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
    far_ell_colind: torch.Tensor | None = None
    far_ell_values: torch.Tensor | None = None
    farT_ell_colind: torch.Tensor | None = None
    farT_ell_values: torch.Tensor | None = None
    localT_colind: torch.Tensor | None = None
    localT_values: torch.Tensor | None = None
    local_rows_values: torch.Tensor | None = None
    local_rows_pos: torch.Tensor | None = None
    local_rows_ptr: torch.Tensor | None = None
    local_rowsT_values: torch.Tensor | None = None
    local_rowsT_pos: torch.Tensor | None = None
    local_rowsT_ptr: torch.Tensor | None = None
    # double-single lo planes ("dia_ds", "well_ds"; the fields above hold
    # the hi planes), and the symmetric "well_ds" transposed-remote ELL
    local_dia_data_lo: torch.Tensor | None = None
    remote_values_lo: torch.Tensor | None = None
    local_well_values_lo: torch.Tensor | None = None
    local_values_lo: torch.Tensor | None = None
    local_wellT_values_lo: torch.Tensor | None = None
    local_rows_values_lo: torch.Tensor | None = None
    local_rowsT_values_lo: torch.Tensor | None = None
    farT_vals_lo: torch.Tensor | None = None
    diagonal_lo: torch.Tensor | None = None
    remoteT_colind: torch.Tensor | None = None
    remoteT_vals: torch.Tensor | None = None
    remoteT_vals_lo: torch.Tensor | None = None
    hub_slot: torch.Tensor | None = None
    hub_chunks: torch.Tensor | None = None
    hub_colind: torch.Tensor | None = None
    hub_values: torch.Tensor | None = None
    hub_nnz: int = 0

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
        Jacobi diagonal excluded, as in the reference; the WELL arrays
        that stay on the host too)."""
        return sum(
            t.numel() * t.element_size()
            for name, t in vars(self).items()
            if isinstance(t, torch.Tensor) and name != "jacobi_diag"
            and name not in HOST_FIELDS)

    @property
    def row_lane_rows(self) -> int:
        """Per-shard output-vector rows in the (rows, 128) lane layout."""
        return self.row_pad // LANES

    @property
    def lane_rows(self) -> int:
        """Per-shard input-vector rows in the (rows, 128) lane layout."""
        return self.col_pad // LANES

    # ----- vector layout: matvec reads the column side, writes the row side -----
    def _side(self, side: str) -> tuple[int, int]:
        if side == "col":
            return self.ncols_global, self.col_pad
        if side == "row":
            return self.nrows_global, self.row_pad
        raise ValueError(f"side must be 'row' or 'col', got {side!r}")

    def to_dist(self, x_global: np.ndarray, side: str = "col") -> torch.Tensor:
        """Scatter a host global vector into the stacked lane layout
        (D*pad/128, 128) on this matrix's device: ``side="col"`` (default)
        makes a matvec input, ``"row"`` an output-side vector."""
        n_glob, pad = self._side(side)
        ranges = owner_ranges(n_glob, self.n_devices)
        out = np.zeros((self.n_devices, pad), dtype=x_global.dtype)
        for s in range(self.n_devices):
            r0, r1 = int(ranges[s]), int(ranges[s + 1])
            out[s, : r1 - r0] = x_global[r0:r1]
        arr = out.reshape(self.n_devices * (pad // LANES), LANES)
        return torch.as_tensor(arr, device=self.device)

    def from_dist(self, x: torch.Tensor, side: str = "row") -> np.ndarray:
        """Gather the stacked lane layout back to a host global vector:
        ``side="row"`` (default) reads a matvec output, ``"col"`` an
        input-side vector."""
        n_glob, pad = self._side(side)
        ranges = owner_ranges(n_glob, self.n_devices)
        mat = x.detach().cpu().numpy().reshape(self.n_devices, pad)
        return np.concatenate(
            [mat[s, : int(ranges[s + 1] - ranges[s])] for s in range(self.n_devices)]
        )

    # ----- distributed SpMV -----
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: x in the stacked lane layout (D*col_pad/128, 128), y
        in (D*row_pad/128, 128).

        A double-single operator takes a float64 x: it is split into an
        error-free hi/lo float32 pair, applied through ``matvec_ds`` and
        recombined, so operators that "auto" picks for float64 input stay
        drop-in. Loops that keep pairs call ``matvec_ds`` directly."""
        with profile_region("spmv_torch.apply"):
            if self.local_format.endswith("_ds"):
                if x.dtype != torch.float64:
                    raise ValueError(
                        "double-single operators apply via matvec_ds (hi/lo "
                        f"pair vectors) or a float64 x, got {x.dtype}; build "
                        "a separate float32 operator for a plain float32 "
                        "matvec")
                xh = x.to(torch.float32)
                xl = (x - xh.to(torch.float64)).to(torch.float32)
                yh, yl = self.matvec_ds(xh, xl)
                return yh.to(torch.float64) + yl.to(torch.float64)
            y = _stacked_mult(self, x)
            if self.hub_nnz > 0:
                y = y + _hub_apply(self, x)
            return y

    def matvec_ds(self, xh: torch.Tensor, xl: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Double-single SpMV ("dia_ds", "well_ds"): (xh, xl) float32 pairs
        in the stacked lane layout -> (yh, yl). Both planes ride the same
        halo plan; the local block runs the DS kernel, the far, remote and
        reverse-exchange terms error-free float32 arithmetic
        (``spmv_torch.ds``)."""
        if not self.local_format.endswith("_ds"):
            raise ValueError("matvec_ds requires local_format 'dia_ds' or "
                             "'well_ds'")
        return _stacked_mult_ds(self, xh, xl)

    # ----- block (multi-RHS) layout and apply -----
    def to_dist_block(self, x_global: np.ndarray, side: str = "col") -> torch.Tensor:
        """Scatter a host (n, nrhs) column block into the stacked SpMM lane
        layout (D*pad/128, nrhs*128) on this matrix's device: element
        (i, r*128 + j) is flat element i*128 + j of column r on the owning
        shard (``side`` as in ``to_dist``)."""
        n, nrhs = x_global.shape
        n_glob, pad = self._side(side)
        ranges = owner_ranges(n_glob, self.n_devices)
        out = np.zeros((self.n_devices, pad, nrhs), dtype=x_global.dtype)
        for s in range(self.n_devices):
            r0, r1 = int(ranges[s]), int(ranges[s + 1])
            out[s, : r1 - r0] = x_global[r0:r1]
        return _block_to_lanes(torch.as_tensor(out, device=self.device))

    def from_dist_block(self, x: torch.Tensor, side: str = "row") -> np.ndarray:
        """Gather the stacked SpMM lane layout back to a host (n, nrhs)
        block (``side`` as in ``from_dist``)."""
        nrhs = x.shape[1] // LANES
        ranges = owner_ranges(self._side(side)[0], self.n_devices)
        mat = _lanes_to_block(x.detach(), self.n_devices, nrhs).cpu().numpy()
        return np.concatenate(
            [mat[s, : int(ranges[s + 1] - ranges[s])] for s in range(self.n_devices)]
        )

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A X for a block of nrhs vectors: x and y in the stacked SpMM
        lane layout (D*pad/128, nrhs*128). The local block runs a block
        kernel, which reads the matrix once for the whole block ("dia":
        ``dia_spmm``, symmetric ``dia_sym_spmm``; "well": ``well_spmm``,
        twice for the symmetric dual-WELL form); "ell" applies its local
        ELL to every column. The halo moves the block whole (one gather per
        round, and one reverse set for symmetric operators), and the
        remote, far and diagonal terms take every column at once."""
        if self.local_format.endswith("_ds"):
            raise ValueError("double-single operators apply blocks via "
                             "matmat_ds (hi/lo pair blocks)")
        y = _stacked_matmat(self, x)
        if self.hub_nnz > 0:
            nd, nrhs = self.n_devices, x.shape[1] // LANES
            y = y + _block_to_lanes(_hub_apply(self, _lanes_to_block(x, nd, nrhs)))
        return y

    def matmat_ds(self, xh: torch.Tensor, xl: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Double-single block apply ("dia_ds", vanilla "well_ds"): (xh, xl)
        float32 pair blocks in the stacked SpMM lane layout -> (yh, yl).
        The local DS block kernel reads both matrix planes once for the
        block; the halo moves each plane as one block gather per round; the
        far and remote chains run error-free float32 arithmetic on every
        column."""
        if self.local_format not in ("dia_ds", "well_ds"):
            raise ValueError(
                "matmat_ds requires local_format 'dia_ds' or 'well_ds'")
        if self.local_format == "well_ds" and self.symmetric:
            raise ValueError(
                "matmat_ds: symmetric well_ds blocks apply per column via "
                "matvec_ds; build the operator non-symmetric for block "
                "refinement")
        return _stacked_matmat_ds(self, xh, xl)

    # ----- the transpose -----
    def transposed(self) -> "DistMatrix":
        """A^T as an operator of its own, built once and cached: one host
        rebuild (``build_dist_matrix`` of the kept host matrix's transpose,
        with the keyword arguments A was built with) whose ``matvec`` is the
        transpose product at full kernel speed. ``A.transposed()`` returns
        the same object on every call and ``A.transposed().transposed()`` is
        A; a symmetric operator is its own transpose. Only operators from
        ``build_dist_matrix`` keep the host matrix."""
        if self.symmetric:
            return self
        cached = getattr(self, "_transposed_cache", None)
        if cached is not None:
            return cached
        host = getattr(self, "_host_csr", None)
        if host is None:
            raise ValueError(
                "transposed() needs the assembly-time host matrix, which only "
                "build_dist_matrix keeps; rebuild the operator or use "
                "matvec_transpose")
        kw = dict(self._rebuild_kwargs)
        at = host.transpose()
        if kw["local_format"] in ("dia", "dia_ds") and at.nrows != at.ncols:
            kw["local_format"] = "ell"
        At = build_dist_matrix(at, **kw)
        At._transposed_cache = self
        self._transposed_cache = At
        return At

    def matvec_transpose(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x: x in the row-side lane layout (D*row_pad/128, 128),
        y in the column side (D*col_pad/128, 128).

        A^T's rows owned by shard s are A's columns owned by s. Each term
        of A has its transpose, built at first use from what the operator
        keeps and cached on it (``_transpose_terms``): the DIA local block
        as shifted data with negated offsets, applied by the same
        ``dia_spmv`` kernel; the WELL local block as a WELL stack of its
        own (its row lists, applied by ``well_spmv``, and an ELL far
        remainder); the ELL local block, the remote block and the hub rows
        as gathers over host-built tables. The remote block's
        contributions land on ghost columns and go back to their owners by
        the reverse exchange. No term sums with atomics. For many applies
        of the same operator, ``transposed()`` pays one rebuild and
        applies A^T as a forward operator."""
        if self.symmetric:
            return self.matvec(x)
        if self.local_format.endswith("_ds"):
            raise NotImplementedError(
                f"matvec_transpose has no {self.local_format!r} branch (the "
                "reference has none either); transposed() rebuilds A^T in "
                "the same double-single format")
        return _stacked_mult_transpose(self, x)

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


def relayout(x: torch.Tensor, pad_out: int, nd: int) -> torch.Tensor:
    """A stacked lane-layout vector (D*pad_in/128, 128) in the layout of
    ``pad_out`` entries a shard: each shard's row zero-padded or truncated.
    Operators on the same partition differ only in their padding (DIA pads
    shards to 1024 rows, ELL to 128, WELL to its groups); truncation drops
    only structural padding, since every layout keeps a shard's real
    entries in [0, nlocal). Returns x itself where the pads agree."""
    pad_in = x.shape[0] // nd * LANES
    if pad_in == pad_out:
        return x
    v = x.reshape(nd, pad_in)
    v = (torch.nn.functional.pad(v, (0, pad_out - pad_in)) if pad_out > pad_in
         else v[:, :pad_out])
    return v.reshape(nd * pad_out // LANES, LANES)


def _well_rows(A: DistMatrix, tag: str) -> tuple:
    """(values, pos, slice_ptr, w0, tile_groups) of the local WELL stack's
    row lists ("") or of its transpose's ("T")."""
    return (getattr(A, f"local_rows{tag}_values"), getattr(A, f"local_rows{tag}_pos"),
            getattr(A, f"local_rows{tag}_ptr"), getattr(A, f"local_well{tag}_w0"),
            getattr(A, f"well{tag}_meta")[2])


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
        if A.symmetric:
            # dual-WELL: L x, L^T x (gathered from the transpose stack) and
            # the diagonal product in one launch
            y = spmv_well_sym_stacked(_well_rows(A, ""), _well_rows(A, "T"),
                                      A.diagonal, x2)
        else:
            y = spmv_well_stacked(A.local_rows_values, A.local_rows_pos,
                                  A.local_rows_ptr, A.local_well_w0, x2,
                                  A.well_meta[2])
        y = y.reshape(nd, A.row_pad)
        if A.far_ell_colind is not None:
            y = y + _ell_apply(A.far_ell_colind, A.far_ell_values, x)
    else:
        y = _ell_apply(A.local_colind, A.local_values, x)
    if have_ghosts:
        y = y + _ell_apply(A.remote_colind, A.remote_values, ghosts)
    if A.symmetric:
        if A.local_format == "well":
            if A.farT_ell_colind is not None:
                y = y + _ell_apply(A.farT_ell_colind, A.farT_ell_values, x)
        elif A.local_format != "dia":
            y = y + A.diagonal * x
            # transpose contributions to owned columns
            y = y + _ell_apply(A.localT_colind, A.localT_values, x)
        if have_ghosts:
            # contributions to ghost columns -> reverse exchange to owners
            gz = _ell_apply(A.remoteT_colind, A.remoteT_vals, x)
            y = halo_scatter_add(gz, y, plan.send_idx, plan.recv_pos,
                                 plan.rounds)
    return y.reshape(nd * A.row_lane_rows, LANES)


def _layout_bytes(A: DistMatrix) -> int:
    """The bytes of ``layout_bytes``: the arrays one ``matvec`` reads on the
    route that ``_stacked_mult`` (or ``_stacked_mult_ds``) and
    ``_hub_apply`` take, each double-single array with its lo plane, the
    halo plan's tables where the apply exchanges, x once and y once (a
    double-single apply reads and writes both planes)."""
    fmt = A.local_format
    ghosts = A.plan.nghost_pad > 0 and len(A.plan.rounds) > 0
    names = []
    if fmt in ("dia", "dia_ds"):
        names.append("local_dia_data")
    elif fmt in ("well", "well_ds"):
        tags = ("", "T") if A.symmetric else ("",)
        names += [f"local_rows{t}_{f}" for t in tags
                  for f in ("values", "pos", "ptr")]
        names += [f"local_well{t}_w0" for t in tags]
        if fmt == "well":
            names += ["far_ell_colind", "far_ell_values", "farT_ell_colind",
                      "farT_ell_values"]
        else:
            if A.well_far_nnz > 0:
                names += ["local_colind", "local_values"]
            names += ["farT_cols", "farT_vals"]
    else:
        names += ["local_colind", "local_values"]
        if A.symmetric:
            names += ["localT_colind", "localT_values"]
    if A.symmetric and fmt != "dia":
        names.append("diagonal")
    if ghosts:
        names += ["remote_colind", "remote_values"]
        if A.symmetric:
            names += ["remoteT_colind", "remoteT_vals"]
    if A.hub_nnz > 0:
        names += ["hub_slot", "hub_chunks", "hub_colind", "hub_values"]
    if fmt.endswith("_ds"):
        names += [f"{n}_lo" for n in names]
    arrays = [t for t in (getattr(A, n, None) for n in names) if t is not None]
    if ghosts:
        arrays += [A.plan.send_idx, A.plan.recv_pos]
    itemsize = 8 if fmt.endswith("_ds") else A.dtype.itemsize
    vectors = A.n_devices * (A.col_pad + A.row_pad) * itemsize
    return sum(t.numel() * t.element_size() for t in arrays) + vectors


def _stacked_mult_transpose(A: DistMatrix, x2: torch.Tensor) -> torch.Tensor:
    """All shards' y = A_s^T @ x at once (the reference's
    ``matvec_transpose``): the local block's transpose, the far remainder's
    (WELL), the reverse exchange of the remote block's ghost-column
    contributions, then the hub rows'."""
    nd, plan = A.n_devices, A.plan
    t = _transpose_terms(A)
    x = x2.reshape(nd, A.row_pad)
    if A.local_format == "dia":
        y = spmv_dia_stacked(t["dia_data"], x2, t["dia_offsets"],
                             False).reshape(nd, A.col_pad)
    elif A.local_format == "well":
        y = spmv_well_stacked(t["rows_values"], t["rows_pos"], t["rows_ptr"],
                              t["w0"], x2, t["tile_groups"]).reshape(nd, A.col_pad)
        if t["far_colind"] is not None:
            y = y + _ell_apply(t["far_colind"], t["far_values"], x)
    else:
        y = _ell_apply(t["local_colind"], t["local_values"], x)
    if plan.nghost_pad > 0 and len(plan.rounds) > 0:
        gz = _ell_apply(t["remote_colind"], t["remote_values"], x)
        y = halo_scatter_add(gz, y, plan.send_idx, plan.recv_pos, plan.rounds)
    y = y.reshape(nd * A.lane_rows, LANES)
    if A.hub_nnz > 0:
        y = y + _hub_gather(t["hub"], x2, nd, A.row_pad, A.lane_rows)
    return y


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _transpose_terms(A: DistMatrix) -> dict:
    """The tables ``matvec_transpose`` applies, built on the first call and
    kept on the operator (``_transpose_cache``): "dia_data"/"dia_offsets"
    (the DIA local block shifted by ``formats.dia.shift_transpose``, on the
    device); the WELL local block's transpose as row lists
    (``_well_transpose``); "local_colind"/"local_values" ("ell", the local
    block's transpose as an ELL rectangle); "remote_colind"/"remote_values"
    (the remote block's transpose over the ghost slots); "hub" (the hub
    block's transpose as ``_hub_tables``, outputs on the column side)."""
    cached = getattr(A, "_transpose_cache", None)
    if cached is not None:
        return cached
    nd, dev = A.n_devices, A.device
    t: dict = {}

    def put(arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=dev)

    if A.local_format == "dia":
        k = len(A.dia_offsets)
        lr = A.local_dia_data.shape[1]
        flat = (A.local_dia_data.reshape(nd, lr, k, LANES).permute(0, 2, 1, 3)
                .reshape(nd, k, lr * LANES))
        flat_t, t["dia_offsets"] = shift_transpose(flat, A.dia_offsets)
        t["dia_data"] = (flat_t.reshape(nd, k, lr, LANES).permute(0, 2, 1, 3)
                         .reshape(nd, lr, k * LANES).contiguous())
    elif A.local_format == "well":
        t.update(_well_transpose(A))
    else:
        ci, v = ell_transpose(_host(A.local_colind), _host(A.local_values), A.col_pad)
        t["local_colind"], t["local_values"] = put(ci), put(v)
    if A.plan.nghost_pad > 0 and len(A.plan.rounds) > 0:
        ci, v = ell_transpose(_host(A.remote_colind), _host(A.remote_values),
                              A.plan.nghost_pad)
        t["remote_colind"], t["remote_values"] = put(ci), put(v)
    if A.hub_nnz > 0:
        rows_g, cols_g, vals = A._hubs
        t["hub"] = _hub_tables(cols_g, rows_g, vals.astype(_host(A.hub_values).dtype),
                               owner_ranges(A.ncols_global, nd),
                               owner_ranges(A.nrows_global, nd), A.col_pad, A.row_pad,
                               dev)
    A._transpose_cache = t
    return t


def _well_transpose(A: DistMatrix) -> dict:
    """The transpose of a vanilla "well" operator's local block, packed as
    a WELL stack of its own on the forward stack's geometry (G groups of
    128 rows, ``tile_groups``), read by ``well_spmv`` through its row lists
    (``pack_rows``). Each shard's block is read back from the WELL arrays
    the operator keeps on the host (entry (128g + j, w0*128 + pos) of every
    nonzero slot) and from its far remainder, transposed, and split and
    packed as ``_stack_well`` packs a forward block (no slot cap: the
    row lists store only the occupied slots); what falls outside the
    windows is an ELL far remainder."""
    nd, dev = A.n_devices, A.device
    k_slots, _, tg, _ = A.well_meta
    values, pos = _host(A.local_well_values), _host(A.local_well_pos).astype(np.int64)
    w0 = _host(A.local_well_w0).astype(np.int64)
    g = values.shape[2]
    far = (None if A.far_rows is None else
           tuple(_host(f) for f in (A.far_rows, A.far_cols, A.far_vals)))
    near_t, far_t = [], []
    for s in range(nd):
        kk, gg, lane = np.nonzero(values[s])
        rows = gg * LANES + lane
        cols = w0[s, gg // tg] * LANES + pos[s, kk, gg, lane]
        vals = values[s, kk, gg, lane]
        if far is not None:
            keep = far[2][s] != 0
            rows = np.concatenate([rows, far[0][s][keep]])
            cols = np.concatenate([cols, far[1][s][keep]])
            vals = np.concatenate([vals, far[2][s][keep]])
        bt = CSRHost.from_coo(cols, rows, vals, A.col_pad, A.row_pad)
        near, fr = split_window(bt, tile_groups=tg, wseg_cap=WELL_WSEG_CAP)
        near_t.append(_build_arrays(near, tg, max(bt.nnz, 1), values.dtype))
        far_t.append(fr)
    k = max(w[0].shape[0] for w in near_t)
    wseg = max(w[3] for w in near_t)
    sv = np.zeros((nd, k, g, LANES), dtype=values.dtype)
    sp = np.zeros((nd, k, g, LANES), dtype=np.int32)
    s0 = np.zeros((nd, g // tg), dtype=np.int32)
    for s, (v, p, w, *_rest) in enumerate(near_t):
        sv[s, : v.shape[0]], sp[s, : p.shape[0]], s0[s] = v, p, w
    rows = pack_rows(sv, sp, wseg)
    out = {"rows_values": rows.values, "rows_pos": rows.pos, "rows_ptr": rows.slice_ptr,
           "w0": s0}
    out = {key: torch.as_tensor(np.ascontiguousarray(v), device=dev)
           for key, v in out.items()}
    out["tile_groups"] = tg
    coo = _far_coo_stack(far_t, values.dtype)
    out["far_colind"], out["far_values"] = (
        (None, None) if coo[0] is None else
        tuple(torch.as_tensor(v, device=dev) for v in coo_ell(*coo, A.col_pad)))
    return out


def _stacked_mult_ds(A: DistMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """All shards' (yh, yl) = A_s @ (xh, xl) at once (the reference's
    ``matvec_ds``), its terms in the reference's order: the local kernel,
    the far chain, the transpose kernel, the diagonal, the farT chain, the
    remote chain, then the error-free reverse exchange."""
    nd, plan, rp = A.n_devices, A.plan, A.row_pad
    xh, xl = xh2.reshape(nd, A.col_pad), xl2.reshape(nd, A.col_pad)
    have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
    if have_ghosts:
        gh = halo_gather(xh, plan.send_idx, plan.recv_pos, plan.rounds,
                         plan.nghost_pad)
        gl = halo_gather(xl, plan.send_idx, plan.recv_pos, plan.rounds,
                         plan.nghost_pad)

    def add(acc, term):
        return ds_add(*acc, *(t.reshape(nd, rp) for t in term))

    if A.local_format == "well_ds":
        y = spmv_well_ds_stacked(A.local_rows_values, A.local_rows_values_lo,
                                 A.local_rows_pos, A.local_rows_ptr,
                                 A.local_well_w0, xh2, xl2, A.well_meta[2])
        y = tuple(t.reshape(nd, rp) for t in y)
        if A.well_far_nnz > 0:
            y = add(y, _ell_ds_term(A.local_colind, A.local_values,
                                    A.local_values_lo, xh, xl))
        if A.symmetric:
            # dual-WELL in DS: the local L^T term is a second DS gather
            # launch, then the DS diagonal product and the farT chain
            y = add(y, spmv_well_ds_stacked(
                A.local_rowsT_values, A.local_rowsT_values_lo,
                A.local_rowsT_pos, A.local_rowsT_ptr, A.local_wellT_w0, xh2,
                xl2, A.wellT_meta[2]))
            y = add(y, ds_mul_f32(A.diagonal, A.diagonal_lo, xh, xl))
            if A.farT_cols is not None:
                y = add(y, _ell_ds_term(A.farT_cols, A.farT_vals,
                                        A.farT_vals_lo, xh, xl))
    else:
        y = spmv_dia_ds_stacked(A.local_dia_data, A.local_dia_data_lo, xh2,
                                xl2, A.dia_offsets)
        y = tuple(t.reshape(nd, rp) for t in y)
    if have_ghosts:
        y = add(y, _ell_ds_term(A.remote_colind, A.remote_values,
                                A.remote_values_lo, gh, gl))
        if A.remoteT_colind is not None:
            # transpose contributions to ghost columns, exactly: the
            # per-ghost DS chain over the transposed remote block, then the
            # error-free reverse exchange
            gz = _ell_ds_term(A.remoteT_colind, A.remoteT_vals,
                              A.remoteT_vals_lo, xh, xl)
            zero = xh.new_zeros((nd, rp))
            y = add(y, halo_scatter_add_ds(*gz, zero, zero, plan.send_idx,
                                           plan.recv_pos, plan.rounds))
    return tuple(t.reshape(nd * A.row_lane_rows, LANES) for t in y)


def _lanes_to_block(x2: torch.Tensor, nd: int, nrhs: int) -> torch.Tensor:
    """The stacked SpMM lane layout (D*n/128, nrhs*128) -> per-shard
    columns (D, n, nrhs)."""
    return spmm_from_layout(x2, nrhs).reshape(nd, -1, nrhs)


def _block_to_lanes(y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_lanes_to_block``: (D, n, nrhs) -> (D*n/128, nrhs*128)."""
    return to_lanes(y.reshape(-1, y.shape[2]))


def _stacked_matmat(A: DistMatrix, x2: torch.Tensor) -> torch.Tensor:
    """All shards' Y = A_s @ X at once (the reference's ``matmat``), its
    terms in ``_stacked_mult``'s order. Every term past the local kernel
    works on the (D, pad, nrhs) column view; a block with no such term (one
    shard, no far remainder, vanilla or symmetric DIA) is the kernel's
    output as it is."""
    nd, plan = A.n_devices, A.plan
    nrhs = x2.shape[1] // LANES
    have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
    if A.local_format == "dia":
        y2 = spmm_dia_stacked(A.local_dia_data, x2, A.dia_offsets, A.symmetric)
    elif A.local_format == "well":
        y2 = spmm_well_stacked(A.local_rows_values, A.local_rows_pos,
                               A.local_rows_ptr, A.local_well_w0, x2,
                               A.well_meta[2])
    else:
        y2 = None
    if y2 is not None and not (have_ghosts or A.far_ell_colind is not None
                               or (A.symmetric and A.local_format == "well")):
        return y2
    x = _lanes_to_block(x2, nd, nrhs)
    if y2 is None:
        y = _ell_apply(A.local_colind, A.local_values, x)
    else:
        y = _lanes_to_block(y2, nd, nrhs)
    if A.far_ell_colind is not None:
        y = y + _ell_apply(A.far_ell_colind, A.far_ell_values, x)
    if have_ghosts:
        # the block halo: one gather per round for every column
        ghosts = halo_gather(x, plan.send_idx, plan.recv_pos, plan.rounds,
                             plan.nghost_pad)
        y = y + _ell_apply(A.remote_colind, A.remote_values, ghosts)
    if A.symmetric:
        if A.local_format == "well":
            # dual-WELL: a second block launch over the transpose stack
            y = y + _lanes_to_block(spmm_well_stacked(
                A.local_rowsT_values, A.local_rowsT_pos, A.local_rowsT_ptr,
                A.local_wellT_w0, x2, A.wellT_meta[2]), nd, nrhs)
            y = y + A.diagonal[:, :, None] * x
            if A.farT_ell_colind is not None:
                y = y + _ell_apply(A.farT_ell_colind, A.farT_ell_values, x)
        elif A.local_format != "dia":
            y = y + A.diagonal[:, :, None] * x
            y = y + _ell_apply(A.localT_colind, A.localT_values, x)
        if have_ghosts:
            # ghost-column contributions of every column, one reverse set
            gz = _ell_apply(A.remoteT_colind, A.remoteT_vals, x)
            y = halo_scatter_add(gz, y, plan.send_idx, plan.recv_pos, plan.rounds)
    return _block_to_lanes(y)


def _stacked_matmat_ds(A: DistMatrix, xh2: torch.Tensor, xl2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """All shards' (Yh, Yl) = A_s @ (Xh, Xl) at once (the reference's
    ``matmat_ds``): the DS block kernel, then (well_ds) the far chain and
    the remote chain, each error-free on every column, in
    ``_stacked_mult_ds``'s order, so column r equals ``matvec_ds`` of
    column r bit for bit."""
    nd, plan = A.n_devices, A.plan
    nrhs = xh2.shape[1] // LANES
    have_ghosts = plan.nghost_pad > 0 and len(plan.rounds) > 0
    if A.local_format == "well_ds":
        y = spmm_well_ds_stacked(A.local_rows_values, A.local_rows_values_lo,
                                 A.local_rows_pos, A.local_rows_ptr,
                                 A.local_well_w0, xh2, xl2, A.well_meta[2])
    else:
        y = spmm_dia_ds_stacked(A.local_dia_data, A.local_dia_data_lo, xh2, xl2,
                                A.dia_offsets)
    has_far = A.local_format == "well_ds" and A.well_far_nnz > 0
    if not (have_ghosts or has_far):
        return y
    xh, xl = (_lanes_to_block(t, nd, nrhs) for t in (xh2, xl2))
    y = tuple(_lanes_to_block(t, nd, nrhs) for t in y)
    if has_far:
        y = ds_add(*y, *_ell_ds_term(A.local_colind, A.local_values,
                                     A.local_values_lo, xh, xl))
    if have_ghosts:
        # the block halo per plane: one gather per round for every column
        gh, gl = (halo_gather(t, plan.send_idx, plan.recv_pos, plan.rounds,
                              plan.nghost_pad) for t in (xh, xl))
        y = ds_add(*y, *_ell_ds_term(A.remote_colind, A.remote_values,
                                     A.remote_values_lo, gh, gl))
    return tuple(_block_to_lanes(t) for t in y)


def _ell_ds_term(colind: torch.Tensor, vh: torch.Tensor, vl: torch.Tensor,
                 src_h: torch.Tensor, src_l: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard ELL product in DS arithmetic: colind/values (D, R, K),
    src (D, n) -> (D, R) pair, accumulated slot by slot from (0, 0); a
    block src (D, n, nrhs) gives (D, R, nrhs), each column the same chain."""
    nd, r, k = colind.shape
    tail = src_h.shape[2:]
    idx = expand_index(colind.reshape(nd, r * k), src_h)
    gh = torch.gather(src_h, 1, idx).reshape(nd, r, k, *tail)
    gl = torch.gather(src_l, 1, idx).reshape(nd, r, k, *tail)
    if tail:
        vh, vl = vh[..., None], vl[..., None]
    acc = (src_h.new_zeros((nd, r, *tail)), src_h.new_zeros((nd, r, *tail)))
    for kk in range(k):
        acc = ds_add(*acc, *ds_mul_f32(vh[:, :, kk], vl[:, :, kk],
                                       gh[:, :, kk], gl[:, :, kk]))
    return acc


def _ell_apply(colind: torch.Tensor, values: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """Per-shard ELL product: colind/values (D, R, K), src (D, n) -> (D, R);
    a block src (D, n, nrhs) gives (D, R, nrhs)."""
    nd, r, k = colind.shape
    tail = src.shape[2:]
    g = torch.gather(src, 1, expand_index(colind.reshape(nd, r * k), src))
    g = g.reshape(nd, r, k, *tail)
    if tail:
        return (values[..., None] * g).sum(2)
    return (values * g).sum(-1)


def _hub_apply(A: DistMatrix, x2: torch.Tensor) -> torch.Tensor:
    """The hub-row term y_hub = H x (the reference's ``_hub_apply``): every
    shard's hub rows read the whole input vector (all shards' x,
    flattened). Three gathers and no scatter-add (``_hub_gather``). x2 is a
    vector (D*col_pad/128, 128) or a column block (D, col_pad, nrhs); the
    result has y's shape."""
    return _hub_gather((A.hub_slot, A.hub_chunks, A.hub_colind, A.hub_values),
                       x2, A.n_devices, A.col_pad, A.row_lane_rows)


def _hub_gather(tables, x2: torch.Tensor, nd: int, in_pad: int,
                out_lane_rows: int) -> torch.Tensor:
    """Apply hub tables (``_hub_tables``) to x2, whose shards hold
    ``in_pad`` entries each: the chunk ELL sums ``HUB_CHUNK``-long pieces
    of the hub rows, ``chunks`` sums each hub row's chunks, and ``slot``
    hands each output row its hub row's sum (rows with no hub entry read a
    zero). A vector gives (D*out_lane_rows, 128); a column block
    (D, in_pad, nrhs) gives (D, out rows, nrhs)."""
    slot, chunks, colind, values = tables
    block = x2.dim() == 3
    tail = x2.shape[2:] if block else ()
    xg = x2.reshape(1, nd * in_pad, *tail).expand(nd, -1, *tail)

    def with_zero(v):  # a zero slot at the end, where padding indices point
        return torch.cat([v, v.new_zeros((nd, 1, *tail))], dim=1)

    yc = with_zero(_ell_apply(colind, values, xg))                # chunk sums
    nh, kc = chunks.shape[1:]
    yh = torch.gather(yc, 1, expand_index(chunks.reshape(nd, nh * kc), yc))
    yh = with_zero(yh.reshape(nd, nh, kc, *tail).sum(2))          # hub-row sums
    y = torch.gather(yh, 1, expand_index(slot, yh))               # (D, R[, nrhs])
    return y if block else y.reshape(nd * out_lane_rows, LANES)


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
    dia_max_diags: int = DIA_MAX_DIAGS,
    well_max_k: int = WELL_MAX_K,
) -> DistMatrix:
    """Compile the (column-side) CommPlan, stack the ELL/DIA/WELL blocks on
    the host, and move everything to ``device`` once, except the WELL
    arrays the row lists are derived from (``HOST_FIELDS``). The double-single
    formats pack in float64 and store every value array as a float32 hi
    plane under its own name plus a lo plane under ``<name>_lo``."""
    nd = len(shards)
    ds = local_format.endswith("_ds")
    pack_dtype = np.float64 if ds else dtype
    host: dict = {}  # DistMatrix field -> host array or static metadata

    def planes(name: str, arr: np.ndarray, split: bool = ds) -> None:
        if split:
            host[name], host[f"{name}_lo"] = ds_from_f64(arr)
        else:
            host[name] = arr

    t = time.perf_counter()
    well = None
    if local_format in ("well", "well_ds"):
        well = _stack_well(shards, symmetric, pack_dtype, well_max_k)
        # the shared per-shard pad is exactly the WELL geometry's G*128
        row_align = well["gt"] * LANES
    t = _lap("pack", t)
    plan = compile_plan(col_ranges, [s.ghosts for s in shards],
                        row_align=row_align, device=device)
    t = _lap("partition", t)
    row_pad = max(
        _round_up(max(s.row_range[1] - s.row_range[0] for s in shards), row_align),
        row_align,
    )
    r = row_pad

    if local_format in ("dia", "dia_ds"):
        data, host["dia_offsets"] = _stack_dia(
            shards, symmetric, r, pack_dtype or shards[0].local.dtype,
            DS_MAX_DIAGS if ds else dia_max_diags)
        planes("local_dia_data", data)

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
    if local_format == "ell":
        host["local_colind"], host["local_values"] = _stack_ell(
            [s.local for s in shards], r, kl, dtype=dtype)
        if symmetric:
            host["localT_colind"], host["localT_values"] = ell_transpose(
                host["local_colind"], host["local_values"], r)

    if well is not None:
        for tag in ("", "T"):
            if f"well{tag}" not in well:
                continue
            v, p, w0, meta = well[f"well{tag}"]
            planes(f"local_well{tag}_values", v)
            host.update({f"local_well{tag}_pos": p, f"local_well{tag}_w0": w0,
                         f"well{tag}_meta": meta})
            host.update(_rows_fields(tag, pack_rows(
                host[f"local_well{tag}_values"], p, meta[1],
                host.get(f"local_well{tag}_values_lo"))))
            fars = well[f"far{tag}"]
            host[f"well_far{tag}_nnz"] = max((b.nnz for b in fars), default=0)
            if not ds:
                coo = _far_coo_stack(fars, dtype)
                host[f"far{tag}_rows"], host[f"far{tag}_cols"], host[f"far{tag}_vals"] = coo
                if coo[0] is not None:
                    (host[f"far{tag}_ell_colind"],
                     host[f"far{tag}_ell_values"]) = coo_ell(*coo, r)
                continue
            # double-single far remainders stay ELL rectangles (the DS
            # chain accumulates per output row, slot by slot, error-free):
            # the local block's in the local ELL fields, kept even when
            # empty as the reference keeps it; the transpose's only when
            # non-empty
            if tag == "T" and host["well_farT_nnz"] == 0:
                continue
            kf = max(max((int(b.row_nnz().max()) if b.nnz else 0) for b in fars), 1)
            ci, v64 = _stack_ell(fars, r, kf, dtype=np.float64)
            if tag == "":
                host["local_colind"] = ci
                planes("local_values", v64)
            else:
                host["farT_cols"] = ci
                planes("farT_vals", v64)

    rci, rv = _stack_ell([s.remote for s in shards], r, kr, dtype=pack_dtype)
    host["remote_colind"] = rci
    planes("remote_values", rv)
    if symmetric and plan.nghost_pad > 0:
        # transposed-remote ELL over ghost slots: each ghost's contribution
        # as a gather (no scatter), slot by slot in DS
        host["remoteT_colind"], vt = ell_transpose(rci, rv, plan.nghost_pad)
        planes("remoteT_vals", vt)
    vdtype = host["remote_values"].dtype  # float32 (the hi plane) for DS

    if symmetric:
        dg = np.zeros((nd, r), dtype=np.float64 if ds else vdtype)
        for s, sh in enumerate(shards):
            dg[s, : sh.nlocal] = sh.diagonal
        planes("diagonal", dg)

    # dense diagonal for Jacobi preconditioning (vanilla storage keeps the
    # diagonal inside the local block; extract it once, host-side)
    jd = np.zeros((nd, r), dtype=vdtype)
    if symmetric:
        jd[:] = host["diagonal"]
    else:
        for s, sh in enumerate(shards):
            loc = sh.local
            rows = np.repeat(np.arange(loc.nrows), loc.row_nnz())
            on_diag = loc.colind == rows
            jd[s, rows[on_diag]] = loc.values[on_diag]
    host["jacobi_diag"] = jd

    def put(name, arr):
        if not isinstance(arr, np.ndarray):
            return arr  # static metadata
        dt = torch.int64 if name in _INDEX_FIELDS else None
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dt,
                               device="cpu" if name in HOST_FIELDS else device)

    t = _lap("pack", t)
    fields = dict(local_colind=None, local_values=None, diagonal=None)
    fields.update({name: put(name, arr) for name, arr in host.items()})
    _lap("upload", t)
    return DistMatrix(plan=plan, nrows_global=nrows_global,
                      ncols_global=ncols_global, row_pad=row_pad,
                      symmetric=symmetric, nnz_global=nnz_global,
                      local_format=local_format, **fields)


def _rows_fields(tag: str, rows) -> dict:
    """DistMatrix fields of one stack's row lists (``pack_rows``); the lo
    plane only for a double-single stack."""
    out = {f"local_rows{tag}_values": rows.values, f"local_rows{tag}_pos": rows.pos,
           f"local_rows{tag}_ptr": rows.slice_ptr}
    if rows.values_lo is not None:
        out[f"local_rows{tag}_values_lo"] = rows.values_lo
    return out


# index arrays, int64 on the device (torch.gather and scatter take int64)
_INDEX_FIELDS = ("local_colind", "remote_colind", "remoteT_colind", "far_rows",
                 "far_cols", "farT_rows", "farT_cols", "localT_colind",
                 "far_ell_colind", "farT_ell_colind")
# the WELL arrays the row lists are derived from: no kernel reads them, so
# they stay on the host (the reference's fields, kept for comparison)
HOST_FIELDS = tuple(f"local_well{t}_{f}" for t in ("", "T")
                    for f in ("values", "pos", "values_lo"))



def _stack_dia(shards: list[ShardCSR], symmetric: bool, r: int, dtype,
               max_diags: int) -> tuple[np.ndarray, tuple[int, ...]]:
    """The union of the shards' diagonal offsets and the local blocks
    stacked on it, (D, R/128, Kd*128) in the interleaved DIA layout (absent
    diagonals all-zero); raises past ``max_diags`` distinct offsets.
    Symmetric shards keep the diagonal separately; it is folded in as
    offset 0, so the block holds offsets <= 0."""
    nd = len(shards)
    per_shard = []
    all_offs = []
    for sh in shards:
        loc = sh.local
        lens = loc.row_nnz()
        rows = np.repeat(np.arange(loc.nrows, dtype=np.int64), lens)
        offs = loc.colind.astype(np.int64) - rows
        vals = loc.values
        if symmetric:
            drows = np.arange(sh.nlocal, dtype=np.int64)
            rows = np.concatenate([rows, drows])
            offs = np.concatenate([offs, np.zeros_like(drows)])
            vals = np.concatenate([vals, sh.diagonal])
        per_shard.append((rows, offs, vals))
        all_offs.append(np.unique(offs))
    union = np.unique(np.concatenate(all_offs)) if all_offs else np.array([0])
    if len(union) > max_diags:
        raise ValueError(
            f"local blocks have {len(union)} distinct diagonals "
            f"(> dia_max_diags={max_diags}); local_format='dia' is for "
            "banded/stencil operators — raise dia_max_diags only when the "
            "band is dense (storage is ndiags * nrows)"
        )
    kd = max(len(union), 1)
    dd = np.zeros((nd, kd, r), dtype=dtype)
    for s, (rows, offs, vals) in enumerate(per_shard):
        if len(rows) == 0:
            continue
        dsel = np.searchsorted(union, offs)
        flat = dsel * np.int64(r) + rows
        acc = np.bincount(flat, weights=vals, minlength=kd * r)
        dd[s] += acc.reshape(kd, r).astype(dd.dtype)
    # row-interleaved device layout (see DiaMatrix.data)
    data = (dd.reshape(nd, kd, r // LANES, LANES)
            .transpose(0, 2, 1, 3)
            .reshape(nd, r // LANES, kd * LANES))
    return data, tuple(int(o) for o in union)


def _far_coo_stack(blocks: list[CSRHost], dtype):
    """Per-shard far remainders as (D, F) compact COO (rows, cols, vals,
    F = the largest shard's far nnz); all None when every one is empty."""
    fmax = max((b.nnz for b in blocks), default=0)
    if fmax == 0:
        return None, None, None
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
        # padding slots stay (row 0, col 0, val 0); coo_ell drops them
    return rows, cols, vals


def _stack_well(shards: list[ShardCSR], symmetric: bool, dtype,
                max_k: int = WELL_MAX_K) -> dict:
    """The WELL branch of the reference's ``_assemble`` (plain "well"):
    per shard, split the local block into its near window and far
    remainder, pack the near part, and stack every shard on one padded
    geometry (D, K, G, 128); symmetric also packs and stacks the local
    block's transpose. Returns {"gt": G, "well": (values, pos, w0, meta),
    "far": the per-shard far CSR blocks} plus "wellT"/"farT" when
    symmetric."""
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
            packed[tag] = ([_build_arrays(near, tg, max_k, dtype)
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
        out[f"far{tag}"] = fars
    return out


def _hub_split(a: CSRHost, hub_cap):
    """Whole-row degree-skew split (the reference's ``_hub_split``): rows
    whose nnz exceeds the cap leave ``a`` entirely; their entries return as
    global COO. Returns (body, hubs) with hubs = (rows_g, cols_g, vals) or
    None. ``hub_cap="auto"`` skips near-uniform degree distributions
    (kmax <= max(64, 4*p99)) and otherwise picks the power-of-two cap that
    minimizes nrows*cap body slots plus 2*hub_nnz hub elements; an int is
    the cap itself."""
    if a.nnz == 0:
        return a, None
    d = a.row_nnz()
    kmax = int(d.max())
    if hub_cap == "auto":
        p99 = float(np.percentile(d, 99)) if a.nrows else 0.0
        if kmax <= max(64, 4 * p99):
            return a, None
        # hub_nnz(c) for every candidate in one histogram pass
        hist = np.bincount(np.minimum(d, 1 << 20))
        nnz_le = np.cumsum(hist * np.arange(len(hist), dtype=np.int64))
        best_cost, cap = None, None
        for c in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
            if c >= kmax:
                break
            hub_nnz = a.nnz - int(nnz_le[min(c, len(nnz_le) - 1)])
            cost = a.nrows * c + 2 * hub_nnz
            if best_cost is None or cost < best_cost:
                best_cost, cap = cost, c
        if cap is None:
            return a, None
    else:
        cap = int(hub_cap)
        if kmax <= cap:
            return a, None
    hub_row = d > cap
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), d)
    m = hub_row[rows_g]
    body = CSRHost.from_coo(rows_g[~m], a.colind[~m].astype(np.int64),
                            a.values[~m], a.nrows, a.ncols,
                            sum_duplicates=False)
    return body, (rows_g[m], a.colind[m].astype(np.int64), a.values[m])


def _attach_hubs(A: DistMatrix, hubs, dtype) -> DistMatrix:
    """Stack the hub COO per shard for ``_hub_apply`` (``_hub_tables``) and
    fold hub diagonal entries into ``jacobi_diag`` (square operators), as
    the reference's ``_attach_hubs`` does."""
    rows_g, cols_g, vals = hubs
    nd, cp, rp = A.n_devices, A.col_pad, A.row_pad
    row_ranges = owner_ranges(A.nrows_global, nd)
    col_ranges = owner_ranges(A.ncols_global, nd)
    A.hub_slot, A.hub_chunks, A.hub_colind, A.hub_values = _hub_tables(
        rows_g, cols_g, vals.astype(dtype or vals.dtype, copy=False), row_ranges,
        col_ranges, rp, cp, A.device)
    A.hub_nnz = int(len(rows_g))
    A.nnz_global += int(len(rows_g))
    if A.nrows_global == A.ncols_global:
        on_diag = rows_g == cols_g
        if on_diag.any():
            rshard = np.searchsorted(row_ranges, rows_g, side="right") - 1
            lrow = rows_g - row_ranges[rshard]
            jd = A.jacobi_diag.cpu().numpy().copy()
            np.add.at(jd, (rshard[on_diag], lrow[on_diag]),
                      vals[on_diag].astype(jd.dtype))
            A.jacobi_diag = torch.as_tensor(jd, device=A.device)
    return A


def _hub_tables(out_g, in_g, vals, out_ranges, in_ranges, out_pad: int,
                in_pad: int, device):
    """The gather tables of a hub block given as global COO (out_g, in_g,
    vals): each output row's entries, in their COO order, are cut into
    chunks of ``HUB_CHUNK``, stored as an ELL over the chunks (inputs in
    the padded-global numbering, shard*in_pad + local index). Returns
    (slot (D, out_pad) each output row's hub slot, H = none; chunks
    (D, H, C) each hub row's chunks, padding one past the last chunk;
    colind, values (D, Cn, Kc)) on ``device``. Chunks bound the padding of
    rows of very different lengths: storage is about nnz + H * (HUB_CHUNK
    + C) per shard. The forward hub term takes rows as outputs, its
    transpose columns."""
    nd = len(out_ranges) - 1
    ishard = np.searchsorted(in_ranges, in_g, side="right") - 1
    pg_in = ishard * np.int64(in_pad) + (in_g - in_ranges[ishard])
    oshard = np.searchsorted(out_ranges, out_g, side="right") - 1
    lout = out_g - out_ranges[oshard]
    per_shard = []
    for s in range(nd):
        sel = np.flatnonzero(oshard == s)
        hub_rows, slot = np.unique(lout[sel], return_inverse=True)
        order = np.argsort(slot, kind="stable")       # by hub row, COO order
        sel, slot = sel[order], slot[order]
        counts = np.bincount(slot, minlength=len(hub_rows))
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(sel)) - first[slot]
        nchunk = -(-counts // HUB_CHUNK)
        chunk0 = np.concatenate([[0], np.cumsum(nchunk)[:-1]])
        per_shard.append((hub_rows, sel, chunk0[slot] + rank // HUB_CHUNK,
                          nchunk, chunk0))
    nh = max(max(len(p[0]) for p in per_shard), 1)
    ncm = max(max(int(p[3].sum()) for p in per_shard), 1)
    cmax = max(max((int(p[3].max()) if len(p[3]) else 0) for p in per_shard), 1)
    f_max = max(max(len(p[1]) for p in per_shard), 1)
    crow = np.zeros((nd, f_max), np.int64)
    ccol = np.zeros((nd, f_max), np.int64)
    cval = np.zeros((nd, f_max), vals.dtype)
    slot_map = np.full((nd, out_pad), nh, dtype=np.int64)
    chunks = np.full((nd, nh, cmax), ncm, dtype=np.int64)
    for s, (hub_rows, sel, chunk, nchunk, chunk0) in enumerate(per_shard):
        ns = len(sel)
        crow[s, :ns], ccol[s, :ns], cval[s, :ns] = chunk, pg_in[sel], vals[sel]
        slot_map[s, hub_rows] = np.arange(len(hub_rows))
        owner = np.repeat(np.arange(len(hub_rows)), nchunk)  # each chunk's row
        c = np.arange(len(owner))
        chunks[s, owner, c - chunk0[owner]] = c
    # padding entries (value 0) are dropped by coo_ell
    ci, cv = coo_ell(crow, ccol, cval, ncm)
    return tuple(torch.as_tensor(t, device=device) for t in (slot_map, chunks, ci, cv))


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
    banded) and ``well_ds``, as in the reference; symmetric banded float64
    stays ``dia``.
    """
    dtype = host_dtype(dtype)
    want_ds = _wants_ds(a, dtype)
    if a.nnz == 0:
        return "ell"
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    offs = a.colind.astype(np.int64) - rows
    if a.nrows == a.ncols and len(np.unique(offs)) <= DIA_MAX_DIAGS:
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
    if local_format not in ("dia", "dia_ds"):
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
    dia_max_diags: int = DIA_MAX_DIAGS,
    well_max_k: int = WELL_MAX_K,
    device="cuda",
) -> DistMatrix:
    """Assemble a DistMatrix from a global host CSR: partition rows (and,
    for a rectangular matrix, columns) into ``n_devices`` shards, classify
    local/remote(/diagonal) entries, compile the halo plan, and move the
    stacked blocks to ``device`` (the card unless the caller asks for
    another).

    ``local_format``: "ell" (square or rectangular), "dia" (square only),
    "well" (square only), their double-single variants "dia_ds" (vanilla
    only) and "well_ds" (float64-class values as hi/lo float32 planes,
    applied by ``matvec_ds``), or "auto" (``select_local_format``; float64
    input selects the double-single formats). ``dtype``: value dtype (numpy
    or torch), default the CSR's; the double-single formats ignore it.
    ``dia_max_diags`` caps the distinct diagonals a DIA block may store and
    ``well_max_k`` the slots of a WELL group; past either, assembly raises
    ValueError, as the reference's does. ``hub_cap`` (vanilla real
    "ell"/"dia"/"well", and "auto" on float32 input): rows with more
    nonzeros than the cap leave the row-uniform format for a hub block
    applied as a gather over the whole input vector; "auto" picks the cap
    and skips near-uniform degrees, an int is the cap, None keeps every row
    in the row-uniform format.
    """
    if local_format not in LOCAL_FORMATS:
        raise ValueError(f"unknown local_format {local_format!r} (one of "
                         f"{', '.join(LOCAL_FORMATS)})")
    if hub_cap is not None and hub_cap != "auto" and not isinstance(
            hub_cap, (int, np.integer)):
        raise ValueError(f"hub_cap must be 'auto', None or an int, got {hub_cap!r}")
    dtype = host_dtype(dtype)
    hubs = None
    # the double-single formats keep every row in their own format, as in
    # the reference
    if (hub_cap is not None and not symmetric
            and (local_format in ("ell", "dia", "well")
                 or (local_format == "auto" and not _wants_ds(a, dtype)))):
        a, hubs = _hub_split(a, hub_cap)
    if local_format == "auto":
        local_format = select_local_format(a, symmetric=symmetric, dtype=dtype)
    if local_format in ("dia", "dia_ds") and a.nrows != a.ncols:
        raise ValueError(f"local_format={local_format!r} requires a square matrix")
    if local_format == "dia_ds" and symmetric:
        raise ValueError("local_format='dia_ds' stores the full matrix (no "
                         "symmetric lower-triangle variant)")
    if a.nrows != a.ncols and local_format != "ell":
        # the reference's rectangular WELL is not ported; a ValueError, so
        # that AMG's per-level ELL fallback (solvers/amg._build_op) fires
        raise ValueError(f"rectangular operators take local_format='ell' "
                         f"here, got {local_format!r}")
    if a.nrows != a.ncols and symmetric:
        raise ValueError("symmetric storage requires a square matrix")
    row_align = _dia_row_align(local_format, -(-a.nrows // n_devices))
    t = time.perf_counter()
    shards = partition_csr(a, n_devices, symmetric=symmetric)
    _lap("partition", t)
    A = _assemble(
        shards, owner_ranges(a.ncols, n_devices), a.nrows, a.ncols, a.nnz,
        symmetric, dtype, row_align, local_format, device, dia_max_diags,
        well_max_k,
    )
    if hubs is not None:
        A = _attach_hubs(A, hubs, dtype)
    layout_bytes.clear()
    layout_bytes[local_format] = _layout_bytes(A)
    # what transposed() and the preconditioner setups rebuild from (plain
    # attributes, as in the reference): the host matrix, whole (hub rows
    # stitched back in), and the keyword arguments, never symmetric=True
    A._host_csr = a
    A._hubs = hubs
    A._rebuild_kwargs = dict(
        n_devices=n_devices, dtype=dtype, local_format=local_format,
        hub_cap=hub_cap, dia_max_diags=dia_max_diags, well_max_k=well_max_k,
        device=device)
    if hubs is not None:
        hr, hc, hv = hubs
        rows_b = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
        A._host_csr = CSRHost.from_coo(
            np.concatenate([rows_b, hr]),
            np.concatenate([a.colind.astype(np.int64), hc]),
            np.concatenate([a.values, hv]), a.nrows, a.ncols,
            sum_duplicates=False)
        A._rebuild_kwargs["local_format"] = "auto"  # A^T's body may differ
    return A
