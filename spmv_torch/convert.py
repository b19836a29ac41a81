"""Carry the reference's state across as numpy arrays.

``spmv_tpu`` objects hold jax arrays; callers turn their fields into numpy
(``np.asarray``) and hand them here, so this module never sees jax.
"""
from __future__ import annotations

import numpy as np
import torch

from spmv_torch.formats.dia import DiaMatrix
from spmv_torch.parallel.comm_plan import CommPlan
from spmv_torch.parallel.dist_matrix import DistMatrix


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
    local_wellT_* and farT_* when symmetric.
    ``meta``: nrows_global, ncols_global, row_pad, symmetric, nnz_global,
    local_format, dia_offsets, rounds, n_devices, nlocal_pad, nghost_pad;
    for "well" well_meta, well_far_nnz (and wellT_meta, well_farT_nnz).
    """
    fmt = meta["local_format"]
    if fmt not in ("ell", "dia", "well"):
        raise ValueError(f"local_format {fmt!r} is not ported yet (ROADMAP.md)")
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
    is_ell = fmt == "ell"
    well = {}
    if fmt == "well":
        for tag in ("", "T"):
            if arrays.get(f"local_well{tag}_values") is None:
                continue
            well.update({
                f"local_well{tag}_values": _put(arrays[f"local_well{tag}_values"], device),
                f"local_well{tag}_pos": _put(arrays[f"local_well{tag}_pos"], device,
                                             torch.int32),
                f"local_well{tag}_w0": _put(arrays[f"local_well{tag}_w0"], device,
                                            torch.int32),
                f"well{tag}_meta": tuple(meta[f"well{tag}_meta"]),
                f"well_far{tag}_nnz": int(meta.get(f"well_far{tag}_nnz", 0)),
                f"far{tag}_rows": _put(arrays.get(f"far{tag}_rows"), device, torch.int64),
                f"far{tag}_cols": _put(arrays.get(f"far{tag}_cols"), device, torch.int64),
                f"far{tag}_vals": _put(arrays.get(f"far{tag}_vals"), device),
            })
    return DistMatrix(
        local_colind=_put(arrays["local_colind"], device, torch.int64) if is_ell else None,
        local_values=_put(arrays["local_values"], device) if is_ell else None,
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
        **well,
    )
