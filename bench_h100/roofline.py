"""The least bytes an operator apply must move, and the published peak.

The count is the configuration's matrix alone, never the program's
objects, so it reads the same work whatever format implements the apply:
the stored values once at the configuration's itemsize (the lower triangle
with the diagonal for symmetric storage, every nonzero otherwise), x read
once and y written once. No index or padding bytes: a DIA apply needs
none. SpMV's operations are far under the card's fp64 peak, so bytes bound
it.
"""
from __future__ import annotations

import numpy as np

from bench_h100.reference.csr import CSR

# NVIDIA H100 SXM5 80GB HBM3, NVIDIA's data sheet, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12


def apply_bytes(a: CSR, symmetric: bool, dtype: str) -> int:
    itemsize = np.dtype(dtype).itemsize
    stored = a.lower_nnz() if symmetric else a.nnz
    return (stored + a.ncols + a.nrows) * itemsize


def apply_seconds(a: CSR, symmetric: bool, dtype: str) -> float:
    """The apply's time at the peak bandwidth."""
    return apply_bytes(a, symmetric, dtype) / PEAK_BYTES_PER_S


def matvec_share(run) -> float | None:
    """Percent of the roofline reached by the device time per apply of the
    kernels launched inside the ``matvec`` spans of the traced slice."""
    t = run.trace
    if (t is None or t.unlinked or not t.spans.get("matvec")
            or not t.device_s.get("matvec")):
        return None
    return 100.0 * run.roofline_s / (t.device_s["matvec"] / t.spans["matvec"])
