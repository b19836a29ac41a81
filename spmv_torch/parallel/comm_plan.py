"""CommPlan — the compiled halo-exchange schedule, over shards stacked on
one device.

Counterpart of ``spmv_tpu.parallel.comm_plan``. ``compile_plan`` builds the
same numpy tables as the reference (per-round send indices and receive
positions, padded to static per-round maxima; padding receive slots hold
the out-of-bounds sentinel ``OOB``) and only then makes tensors.

The reference runs one ``ppermute`` per round over a device mesh axis,
src -> (src + d) % D. Here every shard lives on the leading axis of one
tensor (as the reference stores them, ``dist_matrix.py:3-8``), so a round
is ``torch.roll(buf, d, dims=0)`` and the reverse round rolls by -d.
torch has no drop/fill scatter mode, so padding slots are redirected to a
spare column before each scatter or gather and dropped afterwards.
``halo_gather`` and ``halo_scatter_add`` also move a block of nrhs columns
(a trailing axis) in one set per round, as the reference's
``_plan_gather`` / ``_plan_scatter_add`` do for ``matmat``.
``halo_scatter_add_ds`` is the error-free double-single reverse exchange
of the symmetric "well_ds" operator. Neither reverse exchange sums with
atomics: each round's owned indices are unique, so a round is a
placement and a dense add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_torch.ds import ds_add
from spmv_torch.parallel.partition import owner_of

OOB = np.int32(2**31 - 1)  # receive-position sentinel of padding slots


@dataclasses.dataclass
class CommPlan:
    """Static halo-exchange schedule, stacked over the shard axis:
      send_idx: (D, R, S) int64 — owned-local indices each shard gathers to
                send in round r (pad = 0; dropped at the receiver)
      recv_pos: (D, R, S) int64 — ghost-buffer positions where round r's
                received values land (pad = OOB)
      nlocal:   (D,) logical owned size per shard
      nghosts:  (D,) logical ghost count per shard
    Static: rounds (ring offsets d, src -> (src+d) % D), n_devices (number
    of stacked shards), nlocal_pad, nghost_pad.
    """

    send_idx: torch.Tensor
    recv_pos: torch.Tensor
    nlocal: torch.Tensor
    nghosts: torch.Tensor
    rounds: tuple[int, ...]
    n_devices: int
    nlocal_pad: int
    nghost_pad: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def compile_plan(
    ranges: np.ndarray,
    ghost_lists: list[np.ndarray],
    row_align: int = 8,
    *,
    device,
) -> CommPlan:
    """Compile ghost index lists into a CommPlan on ``device``.

    ranges: (D+1,) ownership prefix array (partition.owner_ranges)
    ghost_lists[s]: sorted global indices shard s needs but does not own
    """
    n = len(ghost_lists)
    assert len(ranges) == n + 1
    # requirements[(owner, dest)] = global indices dest needs from owner
    reqs: dict[tuple[int, int], np.ndarray] = {}
    for s, ghosts in enumerate(ghost_lists):
        ghosts = np.asarray(ghosts, dtype=np.int64)
        if len(ghosts) == 0:
            continue
        if np.any((ghosts >= ranges[s]) & (ghosts < ranges[s + 1])):
            raise ValueError(f"shard {s}: ghost index inside owned range")
        if np.any(ghosts < 0) or np.any(ghosts >= ranges[-1]):
            raise ValueError(f"shard {s}: ghost index outside global range")
        owners = owner_of(ranges, ghosts)
        for o in np.unique(owners):
            reqs[(int(o), s)] = ghosts[owners == o]

    # rounds: distinct ring offsets present in the (owner -> dest) graph
    rounds = sorted({(d - o) % n for (o, d) in reqs})
    nlocal = np.diff(ranges).astype(np.int32)
    nghosts = np.array([len(g) for g in ghost_lists], dtype=np.int32)
    nlocal_pad = max(_round_up(int(nlocal.max()), row_align), row_align)
    nghost_pad = max(_round_up(int(nghosts.max()), row_align), row_align) if nghosts.max() else 0

    max_send = {
        r: max(
            (len(v) for (o, d), v in reqs.items() if (d - o) % n == r), default=0
        )
        for r in rounds
    }
    nr = len(rounds)
    smax = max(max_send.values(), default=0)
    send_idx = np.zeros((n, nr, smax), dtype=np.int32)
    recv_pos = np.full((n, nr, smax), OOB, dtype=np.int32)
    for (o, d), glob in reqs.items():
        r = rounds.index((d - o) % n)
        c = len(glob)
        send_idx[o, r, :c] = (glob - ranges[o]).astype(np.int32)
        # receiver scatters into its ghost buffer at the ghost-list position
        gpos = np.searchsorted(ghost_lists[d], glob)
        recv_pos[d, r, :c] = gpos.astype(np.int32)

    def tensor(arr, dtype):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    return CommPlan(
        send_idx=tensor(send_idx, torch.int64),
        recv_pos=tensor(recv_pos, torch.int64),
        nlocal=tensor(nlocal, torch.int32),
        nghosts=tensor(nghosts, torch.int32),
        rounds=tuple(rounds),
        n_devices=n,
        nlocal_pad=nlocal_pad,
        nghost_pad=nghost_pad,
    )


def _spare_slot(pos: torch.Tensor, nghost_pad: int) -> torch.Tensor:
    """Receive positions with padding (OOB) redirected to the spare ghost
    column ``nghost_pad``."""
    return torch.where(pos == int(OOB), nghost_pad, pos)


def expand_index(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (D, S) index broadcast over ``like``'s trailing axes (the nrhs
    axis of a block), as torch.gather / scatter want it; unchanged for
    (D, n) vectors."""
    tail = like.shape[2:]
    if not tail:
        return idx
    return idx.reshape(*idx.shape, *(1,) * len(tail)).expand(*idx.shape, *tail)


def halo_gather(
    x: torch.Tensor,         # (D, nlocal_pad[, nrhs]) owned values, stacked shards
    send_idx: torch.Tensor,  # (D, R, S)
    recv_pos: torch.Tensor,  # (D, R, S)
    rounds: tuple[int, ...],
    nghost_pad: int,
) -> torch.Tensor:
    """Forward halo exchange: build every shard's ghost buffer from the
    owners. Per round, each shard gathers its send values, the buffer rolls
    by d along the shard axis (shard src's values reach (src+d) % D), and
    the receiver places them at its ghost positions. Returns (D, nghost_pad)
    for a vector; a block x (D, nlocal_pad, nrhs) moves whole, one gather
    per round for every column, and gives (D, nghost_pad, nrhs).
    """
    nd = x.shape[0]
    g = torch.zeros((nd, nghost_pad + 1, *x.shape[2:]), dtype=x.dtype,
                    device=x.device)
    for i, d in enumerate(rounds):
        buf = torch.gather(x, 1, expand_index(send_idx[:, i], x))
        buf = torch.roll(buf, d, dims=0)
        g.scatter_(1, expand_index(_spare_slot(recv_pos[:, i], nghost_pad), x), buf)
    return g[:, :nghost_pad]


def _reverse_rounds(planes, nlocal_pad: int, send_idx: torch.Tensor,
                    recv_pos: torch.Tensor, rounds: tuple[int, ...]):
    """Per round of the reverse exchange, each ghost-contribution plane
    (D, nghost_pad[, nrhs]) routed back to its owners and placed into
    zeros (D, nlocal_pad[, nrhs]). Within one round each shard receives
    from exactly one peer, whose ghost list has no duplicates, so the
    round's owned indices are unique and the placement is a plain scatter
    with no atomics; padding slots (OOB receive positions, owned index 0)
    are redirected to a spare column on both sides and dropped with it."""
    nd, nghost_pad = planes[0].shape[:2]
    tail = planes[0].shape[2:]
    ext = [torch.cat([g, g.new_zeros((nd, 1, *tail))], dim=1) for g in planes]
    for i, d in enumerate(rounds):
        pos = expand_index(_spare_slot(recv_pos[:, i], nghost_pad), planes[0])
        # the owner's slots line up with its receiver's: padding where the
        # receiver's position is OOB
        pad = torch.roll(recv_pos[:, i], -d, dims=0) == int(OOB)
        dst = expand_index(torch.where(pad, nlocal_pad, send_idx[:, i]), planes[0])
        yield [g.new_zeros((nd, nlocal_pad + 1, *tail))
               .scatter_(1, dst, torch.roll(torch.gather(g, 1, pos), -d, dims=0))
               [:, :nlocal_pad] for g in ext]


def halo_scatter_add(
    gz: torch.Tensor,        # (D, nghost_pad[, nrhs]) ghost-slot contributions
    y: torch.Tensor,         # (D, nlocal_pad[, nrhs]) owned accumulator
    send_idx: torch.Tensor,
    recv_pos: torch.Tensor,
    rounds: tuple[int, ...],
) -> torch.Tensor:
    """Reverse halo exchange: route ghost-slot contributions back to their
    owners and add them to the owned entries, one placement and one dense
    add per round (``_reverse_rounds``); a block moves whole, one set per
    round. No atomics, so the sum's order is fixed and the bits are the
    same on every run."""
    for (placed,) in _reverse_rounds((gz,), y.shape[1], send_idx, recv_pos, rounds):
        y = y + placed
    return y


def halo_scatter_add_ds(
    gzh: torch.Tensor,       # (D, nghost_pad) ghost-slot contributions, hi
    gzl: torch.Tensor,       # lo plane
    acc_h: torch.Tensor,     # (D, nlocal_pad) owned DS accumulator, hi
    acc_l: torch.Tensor,
    send_idx: torch.Tensor,
    recv_pos: torch.Tensor,
    rounds: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-free double-single reverse halo exchange: each round's
    placement (``_reverse_rounds``) of both planes, followed by one dense
    ``ds_add``. Padding slots add an exact (0, 0) and leave the
    accumulator's bits unchanged."""
    for placed in _reverse_rounds((gzh, gzl), acc_h.shape[1], send_idx, recv_pos,
                                  rounds):
        acc_h, acc_l = ds_add(acc_h, acc_l, *placed)
    return acc_h, acc_l
