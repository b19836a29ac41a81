"""Checkpoint and resume for distributed solves.

Counterpart of ``spmv_tpu.io.checkpoint`` (``save_dist_matrix`` :42,
``load_dist_matrix`` :134, ``_dia_to_interleaved`` :284,
``save_solver_state``/``load_solver_state`` :294-313), in the reference's
file format: one ``.npz`` of arrays and a ``.meta.json`` sidecar of static
metadata, with the same keys. The port loads a file the reference wrote,
and a file the port writes loads in the port.

- ``save_dist_matrix`` writes the fields the reference's operator holds
  under their names (index arrays as int32, as the reference stores them),
  the one-tier plan tables as ``plan_*`` and the hub rows in the
  reference's compact layout (``hub_rownum``, ``hub_colind``,
  ``hub_values``). What the port derives from those (the WELL row lists,
  the far remainders' and transpose terms' ELL gathers, the hub gather
  tables) is not written.
- ``load_dist_matrix`` builds the operator through
  ``convert.dist_matrix_from_numpy``, which derives the rest. Two-tier
  plans (``"type": "two_tier"``) raise ``NotImplementedError`` (ROADMAP.md
  queue 1, the two-tier slice); a device count other than the saved one
  raises ``ValueError``, as the reference does for a mesh of another size.
- ``save_solver_state`` / ``load_solver_state``: x and any other vectors
  mid-solve, in the global host layout; ``cg(resume=...)`` continues the
  Krylov sequence from saved (x, r, p, rnorm0).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from spmv_torch.convert import dist_matrix_from_numpy
from spmv_torch.parallel.dist_matrix import DistMatrix, _hub_tables
from spmv_torch.parallel.partition import owner_ranges

# the reference's DistMatrix array fields, in its order, less the plan and
# the hub rows (both written under keys of their own)
FIELDS = (
    "local_colind", "local_values", "remote_colind", "remote_values",
    "diagonal", "jacobi_diag", "local_dia_data",
    "local_dia_data_lo", "remote_values_lo",
    "local_well_values", "local_well_pos", "local_well_w0",
    "local_well_values_lo", "local_values_lo",
    "far_rows", "far_cols", "far_vals",
    "local_wellT_values", "local_wellT_pos", "local_wellT_w0",
    "farT_rows", "farT_cols", "farT_vals",
    "local_wellT_values_lo", "farT_vals_lo", "diagonal_lo",
    "remoteT_colind", "remoteT_vals", "remoteT_vals_lo",
)
PLAN_FIELDS = ("send_idx", "recv_pos", "nlocal", "nghosts")
# the remote block's transpose is stored only by the symmetric "well_ds"
# operator; the other formats derive it at load
DS_ONLY = ("remoteT_colind", "remoteT_vals", "remoteT_vals_lo")


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' where it is absent and np.load does not:
    normalize once in save and in load, so that the sidecar's name follows."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(t) -> np.ndarray:
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return arr.astype(np.int32) if arr.dtype == np.int64 else arr


def _hub_arrays(a: DistMatrix) -> dict:
    """The hub rows in the reference's compact per-shard layout: local row,
    padded-global column (shard * col_pad + local column) and value per
    entry, padded with (0, 0, 0)."""
    hubs = getattr(a, "_hubs", None)
    if hubs is None:
        raise ValueError("save_dist_matrix: this operator's hub rows were not "
                         "kept (only build_dist_matrix keeps them)")
    rows_g, cols_g, vals = hubs
    nd, cp = a.n_devices, a.col_pad
    row_ranges = owner_ranges(a.nrows_global, nd)
    col_ranges = owner_ranges(a.ncols_global, nd)
    cshard = np.searchsorted(col_ranges, cols_g, side="right") - 1
    pg_cols = cshard * np.int64(cp) + (cols_g - col_ranges[cshard])
    rshard = np.searchsorted(row_ranges, rows_g, side="right") - 1
    f_max = max(int(np.bincount(rshard, minlength=nd).max()) if len(rshard) else 0, 1)
    rownum = np.zeros((nd, f_max), dtype=np.int32)
    colind = np.zeros((nd, f_max), dtype=np.int32)
    values = np.zeros((nd, f_max), dtype=_host(a.remote_values).dtype)
    for s in range(nd):
        sel = rshard == s
        ns = int(sel.sum())
        rownum[s, :ns] = rows_g[sel] - row_ranges[s]
        colind[s, :ns] = pg_cols[sel]
        values[s, :ns] = vals[sel]
    return dict(hub_rownum=rownum, hub_colind=colind, hub_values=values)


def save_dist_matrix(path: str, a: DistMatrix) -> None:
    """Persist the assembled operator in the reference's format (module
    docstring). One-tier plans only: the port has no other."""
    path = _npz_path(path)
    arrays = {f"plan_{name}": _host(getattr(a.plan, name)) for name in PLAN_FIELDS}
    for name in FIELDS:
        v = getattr(a, name, None)
        if v is not None and (name not in DS_ONLY or a.local_format.endswith("_ds")):
            arrays[name] = _host(v)
    if a.local_colind is None:
        # the reference keeps an all-zero (D, R, 1) local ELL beside the
        # DIA and WELL blocks, and its loader reads it
        arrays["local_colind"] = np.zeros((a.n_devices, a.row_pad, 1), np.int32)
        arrays["local_values"] = np.zeros((a.n_devices, a.row_pad, 1),
                                          arrays["remote_values"].dtype)
    if a.hub_nnz > 0:
        arrays.update(_hub_arrays(a))
    np.savez_compressed(path, **arrays)
    meta = {
        "version": 2,
        "nrows_global": a.nrows_global,
        "ncols_global": a.ncols_global,
        "row_pad": a.row_pad,
        "symmetric": a.symmetric,
        "nnz_global": a.nnz_global,
        "axis_name": "shards",
        "local_format": a.local_format,
        "dia_offsets": list(a.dia_offsets),
        "well_meta": list(a.well_meta),
        "well_far_nnz": a.well_far_nnz,
        "wellT_meta": list(a.wellT_meta),
        "well_farT_nnz": a.well_farT_nnz,
        "hub_nnz": a.hub_nnz,
        "dia_layout": "interleaved",
        "plan": {
            "type": "one_tier",
            "rounds": list(a.plan.rounds),
            "n_devices": a.plan.n_devices,
            "nlocal_pad": a.plan.nlocal_pad,
            "nghost_pad": a.plan.nghost_pad,
        },
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def _dia_to_interleaved(arr: np.ndarray, layout) -> np.ndarray:
    """Early reference checkpoints stored (D, K, R/128, 128) per-diagonal
    planes; the device layout is row-interleaved (D, R/128, K*128)."""
    if layout == "interleaved":
        return arr
    d, k, lr, _ = arr.shape
    return arr.transpose(0, 2, 1, 3).reshape(d, lr, k * 128)


def _attach_saved_hubs(A: DistMatrix, z, hub_nnz: int) -> None:
    """The hub gather tables from the reference's compact hub layout. The
    saved jacobi_diag and nnz_global already count the hub entries."""
    rownum, colind, vals = (np.asarray(z[k]) for k in ("hub_rownum", "hub_colind",
                                                       "hub_values"))
    nd, cp = A.n_devices, A.col_pad
    row_ranges = owner_ranges(A.nrows_global, nd)
    col_ranges = owner_ranges(A.ncols_global, nd)
    keep = vals != 0   # padding entries (row 0, column 0, value 0)
    shard = np.broadcast_to(np.arange(nd, dtype=np.int64)[:, None], rownum.shape)[keep]
    rows_g = row_ranges[shard] + rownum[keep].astype(np.int64)
    pg = colind[keep].astype(np.int64)
    cols_g = col_ranges[pg // cp] + pg % cp
    vals = vals[keep]
    A.hub_slot, A.hub_chunks, A.hub_colind, A.hub_values = _hub_tables(
        rows_g, cols_g, vals, row_ranges, col_ranges, A.row_pad, cp, A.device)
    A.hub_nnz = int(hub_nnz)
    A._hubs = (rows_g, cols_g, vals)


def load_dist_matrix(path: str, n_devices: int | None = None, *, device="cuda"
                     ) -> DistMatrix:
    """Load an operator saved by ``save_dist_matrix`` (the reference's or
    the port's) onto ``device`` (the card unless the caller asks for
    another), its shards stacked there. ``n_devices``: the shard count the
    caller expects; another than the saved one raises ``ValueError``
    (re-sharding needs re-assembly from the source matrix)."""
    path = _npz_path(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    pm = meta["plan"]
    if pm.get("type", "one_tier") == "two_tier":
        raise NotImplementedError(
            "load_dist_matrix: two-tier (CommPlan2) checkpoints are not ported "
            "yet; see ROADMAP.md queue 1, the two-tier slice")
    if n_devices is not None and int(n_devices) != int(pm["n_devices"]):
        raise ValueError(
            f"checkpoint has {pm['n_devices']} shards; asked for {n_devices} "
            "devices (re-sharding to a different device count requires "
            "re-assembly from the source matrix)")
    z = np.load(path)
    arrays = {name: z[f"plan_{name}"] for name in PLAN_FIELDS}
    for name in FIELDS:
        if name in z.files:
            arrays[name] = z[name]
    if "local_dia_data" in arrays:
        arrays["local_dia_data"] = _dia_to_interleaved(arrays["local_dia_data"],
                                                       meta.get("dia_layout"))
    if "local_dia_data_lo" in arrays:
        arrays["local_dia_data_lo"] = _dia_to_interleaved(arrays["local_dia_data_lo"],
                                                          meta.get("dia_layout"))
    info = dict(
        nrows_global=meta["nrows_global"],
        ncols_global=meta.get("ncols_global", meta["nrows_global"]),
        row_pad=meta.get("row_pad", pm["nlocal_pad"]),
        symmetric=meta["symmetric"],
        nnz_global=meta["nnz_global"],
        local_format=meta.get("local_format", "ell"),
        dia_offsets=meta.get("dia_offsets", []),
        well_meta=meta.get("well_meta", []),
        well_far_nnz=meta.get("well_far_nnz", 0),
        wellT_meta=meta.get("wellT_meta", []),
        well_farT_nnz=meta.get("well_farT_nnz", 0),
        rounds=pm["rounds"],
        n_devices=pm["n_devices"],
        nlocal_pad=pm["nlocal_pad"],
        nghost_pad=pm["nghost_pad"],
    )
    A = dist_matrix_from_numpy(arrays, info, device=device)
    if meta.get("hub_nnz", 0) > 0:
        _attach_saved_hubs(A, z, meta["hub_nnz"])
    return A


def save_solver_state(path: str, a: DistMatrix, x: torch.Tensor, iteration: int = 0,
                      **extra_vectors) -> None:
    """Persist a mid-solve state (global host layout, independent of the
    shard count): ``x`` and any named vectors, and the iteration."""
    path = _npz_path(path)
    arrays = {"x": a.from_dist(x)}
    for name, v in extra_vectors.items():
        arrays[name] = a.from_dist(v)
    np.savez_compressed(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump({"version": 1, "iteration": int(iteration)}, f)


def load_solver_state(path: str, a: DistMatrix) -> tuple[dict, int]:
    """Returns (vectors: {name: tensor in a's stacked layout}, iteration)."""
    path = _npz_path(path)
    z = np.load(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    return {name: a.to_dist(z[name]) for name in z.files}, meta["iteration"]
