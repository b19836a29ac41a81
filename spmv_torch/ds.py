"""Double-single (two-float32) arithmetic building blocks.

Counterpart of ``spmv_tpu.ds``. A double-single (DS) value is a pair of
float32 numbers v = hi + lo with |lo| <= ulp(hi)/2: about 48 significand
bits at float32 storage. The error-free transformations below (Knuth's
two_sum, Dekker's split and two_prod) run as plain float32 tensor ops: each
torch op rounds once, and eager torch never fuses two of them, so the plain
path performs the reference's exact operation sequence. Never wrap these in
``torch.compile``: a fused multiply-add breaks the error terms.

The CUDA kernels (``csrc/spmv_dia_ds.cu``, ``csrc/spmv_well_ds.cu``) carry
the same sequence, with two_prod's error term as one exact fma.
"""
from __future__ import annotations

import numpy as np

# 2^12 + 1 (float32 has 24 significand bits)
_SPLITTER = 4097.0


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 bits, so
    products hi*hi are exact in float32."""
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, ~17 flops)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_add(ah, al, bh, bl):
    """(ah+al) + (bh+bl) as a normalized double-single (sloppy variant:
    error O(2^-48) relative, 11 flops)."""
    sh, se = two_sum(ah, bh)
    se = se + (al + bl)
    return fast_two_sum(sh, se)


def ds_mul_f32(ah, al, bh, bl):
    """(ah+al) * (bh+bl) as a normalized double-single. Drops the al*bl
    term (O(2^-48) relative)."""
    ph, pe = two_prod(ah, bh)
    pe = pe + (ah * bl + al * bh)
    return fast_two_sum(ph, pe)


# ---------------------------------------------------------------------------
# host-side conversions (numpy)
# ---------------------------------------------------------------------------


def ds_from_f64(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 array -> (hi, lo) float32 pair with hi + lo == v to ~2^-48."""
    hi = np.asarray(v, dtype=np.float32)
    lo = np.asarray(v - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


def ds_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
