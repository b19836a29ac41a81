"""Carry the reference's state across as numpy arrays.

``spmv_tpu`` objects hold jax arrays; callers turn their fields into numpy
(``np.asarray``) and hand them here, so this module never sees jax.
"""
from __future__ import annotations

import numpy as np
import torch

from spmv_torch.formats.csr import coo_ell, ell_transpose
from spmv_torch.formats.dia import DiaMatrix
from spmv_torch.formats.well import pack_rows
from spmv_torch.parallel.comm_plan import CommPlan
from spmv_torch.parallel.dist_matrix import HOST_FIELDS, DistMatrix, _rows_fields


def _put(arr, device, dtype=None):
    """A tensor on ``device`` holding a copy of ``arr`` (the caller's array
    may be a read-only view of a jax buffer)."""
    if arr is None:
        return None
    return torch.as_tensor(np.array(arr), dtype=dtype, device=device)


def dia_from_numpy(data: np.ndarray, offsets, nrows: int, ncols: int,
                   symmetric: bool, *, device) -> DiaMatrix:
    """A port DiaMatrix from a reference DiaMatrix's interleaved
    (npad/128, K*128) data and its offsets."""
    data = np.asarray(data)
    return DiaMatrix(data=_put(data, device), offsets=tuple(int(o) for o in offsets),
                     nrows=int(nrows), ncols=int(ncols), symmetric=bool(symmetric),
                     _nnz=int(np.count_nonzero(data)))


def dist_matrix_from_numpy(arrays: dict[str, np.ndarray], meta: dict, *,
                           device) -> DistMatrix:
    """A port DistMatrix from a reference DistMatrix's fields.

    ``arrays``: remote_colind, remote_values, jacobi_diag, send_idx,
    recv_pos, nlocal, nghosts; local_colind/local_values ("ell"),
    local_dia_data ("dia"), diagonal (symmetric); for "well"
    local_well_values/pos/w0 and, when present, far_rows/cols/vals, plus
    local_wellT_* and farT_* when symmetric. The double-single formats
    add the lo planes (``<name>_lo``); "dia_ds" takes local_dia_data(_lo),
    "well_ds" its far ELL local_colind/local_values(_lo) and, symmetric,
    farT_cols/farT_vals(_lo), diagonal_lo and remoteT_colind/vals(_lo).
    ``meta``: nrows_global, ncols_global, row_pad, symmetric, nnz_global,
    local_format, dia_offsets, rounds, n_devices, nlocal_pad, nghost_pad;
    for "well"/"well_ds" well_meta, well_far_nnz (and wellT_meta,
    well_farT_nnz). What the port's apply reads and the reference does
    not store is derived here: the row lists the WELL kernels read, from
    the WELL arrays (``formats/well.pack_rows``), which stay on the host;
    the far remainders' ELL rectangles from their COO ("well"); the local
    block's transpose (symmetric "ell") and the remote block's transpose
    over the ghost slots (symmetric, ghosts) from the ELL blocks.
    """
    fmt = meta["local_format"]
    if fmt not in ("ell", "dia", "dia_ds", "well", "well_ds"):
        raise ValueError(f"unknown local_format {fmt!r}")
    plan = CommPlan(
        send_idx=_put(arrays["send_idx"], device, torch.int64),
        recv_pos=_put(arrays["recv_pos"], device, torch.int64),
        nlocal=_put(arrays["nlocal"], device, torch.int32),
        nghosts=_put(arrays["nghosts"], device, torch.int32),
        rounds=tuple(int(r) for r in meta["rounds"]),
        n_devices=int(meta["n_devices"]),
        nlocal_pad=int(meta["nlocal_pad"]),
        nghost_pad=int(meta["nghost_pad"]),
    )
    has_local_ell = fmt in ("ell", "well_ds")
    extra = {}
    if fmt in ("well", "well_ds"):
        for tag in ("", "T"):
            if arrays.get(f"local_well{tag}_values") is None:
                continue
            extra.update({
                f"local_well{tag}_values": _put(arrays[f"local_well{tag}_values"], "cpu"),
                f"local_well{tag}_pos": _put(arrays[f"local_well{tag}_pos"], "cpu",
                                             torch.int32),
                f"local_well{tag}_w0": _put(arrays[f"local_well{tag}_w0"], device,
                                            torch.int32),
                f"well{tag}_meta": tuple(meta[f"well{tag}_meta"]),
                f"well_far{tag}_nnz": int(meta.get(f"well_far{tag}_nnz", 0)),
                f"far{tag}_rows": _put(arrays.get(f"far{tag}_rows"), device, torch.int64),
                f"far{tag}_cols": _put(arrays.get(f"far{tag}_cols"), device, torch.int64),
                f"far{tag}_vals": _put(arrays.get(f"far{tag}_vals"), device),
            })
            lo = arrays.get(f"local_well{tag}_values_lo")
            rows = pack_rows(np.asarray(arrays[f"local_well{tag}_values"]),
                             np.asarray(arrays[f"local_well{tag}_pos"]),
                             int(meta[f"well{tag}_meta"][1]),
                             None if lo is None else np.asarray(lo))
            extra.update({name: _put(arr, device)
                          for name, arr in _rows_fields(tag, rows).items()})
            if fmt == "well" and arrays.get(f"far{tag}_rows") is not None:
                ell = coo_ell(*(np.asarray(arrays[f"far{tag}_{f}"])
                                for f in ("rows", "cols", "vals")), int(meta["row_pad"]))
                extra[f"far{tag}_ell_colind"] = _put(ell[0], device)
                extra[f"far{tag}_ell_values"] = _put(ell[1], device)
    if fmt.endswith("_ds"):
        extra.update({name: _put(arrays.get(name), "cpu" if name in HOST_FIELDS
                                 else device) for name in (
            "local_dia_data_lo", "remote_values_lo", "local_well_values_lo",
            "local_values_lo", "local_wellT_values_lo", "farT_vals_lo",
            "diagonal_lo", "remoteT_vals", "remoteT_vals_lo")})
        extra["remoteT_colind"] = _put(arrays.get("remoteT_colind"), device, torch.int64)
    elif meta["symmetric"] and int(meta["nghost_pad"]) > 0:
        ell = ell_transpose(np.asarray(arrays["remote_colind"]),
                            np.asarray(arrays["remote_values"]), int(meta["nghost_pad"]))
        extra["remoteT_colind"], extra["remoteT_vals"] = (_put(t, device) for t in ell)
    if fmt == "ell" and meta["symmetric"]:
        ell = ell_transpose(np.asarray(arrays["local_colind"]),
                            np.asarray(arrays["local_values"]), int(meta["row_pad"]))
        extra["localT_colind"], extra["localT_values"] = (_put(t, device) for t in ell)
    return DistMatrix(
        local_colind=(_put(arrays["local_colind"], device, torch.int64)
                      if has_local_ell else None),
        local_values=_put(arrays["local_values"], device) if has_local_ell else None,
        remote_colind=_put(arrays["remote_colind"], device, torch.int64),
        remote_values=_put(arrays["remote_values"], device),
        diagonal=_put(arrays.get("diagonal"), device),
        jacobi_diag=_put(arrays["jacobi_diag"], device),
        plan=plan,
        nrows_global=int(meta["nrows_global"]),
        ncols_global=int(meta["ncols_global"]),
        row_pad=int(meta["row_pad"]),
        symmetric=bool(meta["symmetric"]),
        nnz_global=int(meta["nnz_global"]),
        local_format=fmt,
        local_dia_data=_put(arrays.get("local_dia_data"), device),
        dia_offsets=tuple(int(o) for o in meta.get("dia_offsets", ())),
        **extra,
    )
