"""DIA SpMV in plain torch: y = alpha * A @ x + beta * y.

The plain version of both CUDA kernels in ``ops/spmv_dia_cuda.py``: the
path every CPU tensor takes, and the oracle the kernels are held against on
the card. Counterpart of the XLA formulation in ``spmv_tpu.ops.spmv_dia``:
shifted slices of a zero-padded x, summed in the reference's order (offsets
ascending, each o < 0 transpose term right after its forward term).
"""
from __future__ import annotations

import dataclasses

import torch

from spmv_torch.formats.dia import LANES, DiaMatrix


def spmv_dia(
    a: DiaMatrix,
    x: torch.Tensor,
    alpha=1.0,
    beta=0.0,
    y: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a DIA matrix. x must have length >= a.ncols. Returns length
    a.nrows_pad (rows >= a.nrows zero-padded).

    Symmetric storage adds the transpose of each stored o < 0 diagonal as a
    gather: y[i] += d_o[i-o] * x[i-o], zero where i-o >= nrows_pad.
    bfloat16 storage accumulates in float32 and returns x's dtype, as the
    kernels do.
    """
    if torch.bfloat16 in (a.data.dtype, x.dtype):
        a32 = dataclasses.replace(a, data=a.data.to(torch.float32))
        y32 = None if y is None else y.to(torch.float32)
        return spmv_dia(a32, x.to(torch.float32), alpha, beta, y32).to(x.dtype)
    npad = a.nrows_pad
    nr = npad // LANES
    omin = min(min(a.offsets), 0)
    # symmetric storage implies the mirrored (positive) offsets too
    omax = max(max(a.offsets), (-omin) if a.symmetric else 0)
    # window of x covering every diagonal's reach, zero outside the domain
    xw = torch.zeros(npad + omax - omin, dtype=x.dtype, device=x.device)
    take = min(x.shape[0], a.ncols)
    xw[-omin : -omin + take] = x[:take]
    x_al = xw[-omin : -omin + npad].view(nr, LANES)
    # (R, K, 128) view: diagonal k is the strided (R, 128) slice [:, k, :]
    d3 = a.data.view(nr, a.ndiags, LANES)
    out = None
    for k, off in enumerate(a.offsets):
        dk = d3[:, k, :]
        term = dk * xw[off - omin : off - omin + npad].view(nr, LANES)
        out = term if out is None else out + term
        if a.symmetric and off < 0:
            # y[i] += d_o[i+s] * x[i+s], s = -o: the aligned product shifted
            s = -off
            prod = (dk * x_al).reshape(-1)
            out.view(-1)[: npad - s] += prod[s:]
    out = out.reshape(npad)
    if y is None:
        return out if alpha == 1.0 else alpha * out
    yp = y[:npad] if y.shape[0] >= npad else torch.nn.functional.pad(
        y, (0, npad - y.shape[0]))
    return alpha * out + beta * yp


def spmv_dia_stacked_plain(
    data: torch.Tensor,
    x2: torch.Tensor,
    offsets: tuple[int, ...],
    symmetric: bool,
) -> torch.Tensor:
    """Stacked-shard lane-layout apply: data (D, R, K*128), x2 (D*R, 128)
    -> y2 (D*R, 128). Shard s reads only its own R*128 entries of x; x is
    zero outside them. The plain version of ``spmv_dia_stacked``."""
    nd, nr = data.shape[0], data.shape[1]
    npad = nr * LANES
    xs = x2.view(nd, npad)
    ys = [
        spmv_dia(DiaMatrix(data=data[s], offsets=tuple(offsets), nrows=npad,
                           ncols=npad, symmetric=symmetric), xs[s])
        for s in range(nd)
    ]
    return torch.stack(ys).view(nd * nr, LANES)
