"""Newton s-step basis from Leja-ordered Ritz shifts — the off-axis
companion to the shifted-Chebyshev basis.

Counterpart of ``spmv_tpu.solvers.newton_basis``: host numpy, copied as it
is (``modified_leja`` :75, ``newton_basis_ops`` :127,
``newton_recurrence_matrix`` :186 give the reference's arrays bit for
bit); ``newton_shifts_from_operator`` (:207) runs over the port's
``arnoldi_ritz``.

``gmres_sstep``'s default basis is shifted-Chebyshev on a REAL interval.
That is the right conditioning tool when the spectrum hugs the real axis
(SPD, convection-diffusion), but Chebyshev polynomials on a real interval
grow like cosh along the imaginary direction, so a spectrum with large
imaginary extent (skew-dominant transport, wave operators) makes the
block basis condition number explode geometrically in s — measured on a
gamma*I + rho*skew operator with spectrum 2 +/- 10i: Chebyshev block
kappa 4.6e6 at s=8 where the Newton basis below sits at 33 (see
``tests/test_newton_basis.py``).

The classical CA-GMRES fix (Hoemmen '10 ch. 7; Bai-Hu-Reichel '94 for
the real Newton recurrence; Philippe-Reichel '12 for Leja points) is a
NEWTON basis on shifts theta_0..theta_{s-1} taken from the operator's
own Ritz values:

    v_{j+1} = (A - theta_j I) v_j / sigma_j

Three practical ingredients, all host-side static data:

1. **Modified Leja ordering**: shifts are greedily ordered to maximize
   the product of distances to all previously chosen shifts (log-space),
   which bounds the growth of the Newton polynomials between shift
   applications. For REAL operators the Ritz set is closed under
   conjugation; selection runs over upper-half-plane representatives and
   emits each complex shift together with its conjugate as an adjacent
   PAIR — splitting a pair destroys both the ordering's growth bound and
   the real-arithmetic recurrence below. (Getting this wrong is
   catastrophic, not cosmetic: greedily selecting from the full
   conjugate-closed set picks theta and conj(theta) independently and
   then applies each QUADRATIC twice — measured kappa 1e25 where the
   paired ordering gives 33.)

2. **Real pair recurrence**: a conjugate pair theta = alpha +/- i beta
   is applied in real arithmetic over two steps,

       v_{j+1} = (A - alpha) v_j / sigma_j
       v_{j+2} = ((A - alpha) v_{j+1} + (beta^2 / sigma_j) v_j) / sigma_{j+1}

   whose composition is the real quadratic ((A-alpha)^2 + beta^2) v_j /
   (sigma_j sigma_{j+1}) — no complex vectors anywhere.

3. **Capacity scaling**: sigma_j is the geometric mean of the distances
   from shift j to shifts 0..j-1 (sigma_0 = |theta_0|), the standard
   capacity estimate that keeps the basis column norms O(1) instead of
   capacity(spectrum)^j.

The recurrence is summarized EXACTLY by a small (s+1, s) matrix B with
``A V[:, :s] = V @ B`` (``newton_recurrence_matrix``), which is all
``gmres_sstep`` needs for its Hessenberg recovery — the Newton basis
drops into the same 4-reductions-per-s-steps block algebra as the
Chebyshev one, and into the same one-halo-exchange matrix-powers kernel
(``spmv_torch.parallel.powers.newton_powers_basis``).

Shifts are STATIC host data (get them from ``arnoldi_ritz`` — a one-time
m-step Arnoldi run — or from known spectral structure), plain floats that
every apply reads as scalars. The reference library has no nonsymmetric solver at
all (its only solver is CG, reference spmv/cg.cpp:21-98); this module
has no counterpart there.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "modified_leja",
    "newton_basis_ops",
    "newton_recurrence_matrix",
    "newton_shifts_from_operator",
]


def modified_leja(values, max_points: int | None = None) -> np.ndarray:
    """Order complex shift candidates by the modified Leja rule, keeping
    conjugate pairs adjacent (module docstring item 1).

    ``values``: complex array-like, closed under conjugation up to noise
    (Ritz values of a real operator are). Near-duplicate points (within
    1e-10 of the spectral scale) are dropped — repeated Newton roots
    waste basis slots without improving conditioning. Returns the ordered
    complex ndarray; each entry with positive imaginary part is
    immediately followed by its conjugate. ``max_points`` truncates the
    ordering once at least that many points are placed (a trailing
    conjugate may make the result one longer)."""
    v = np.asarray(values, dtype=complex).reshape(-1)
    v = v[np.isfinite(v)]
    if v.size == 0:
        raise ValueError("modified_leja needs at least one finite shift")
    scale = max(float(np.max(np.abs(v))), np.finfo(float).tiny)
    # upper-half-plane representatives (real axis included), deduplicated
    reps_all = v[v.imag >= -1e-12 * scale]
    if reps_all.size == 0:  # pathological input: all strictly lower-half
        reps_all = np.conj(v)
    order = np.argsort(-np.abs(reps_all))
    reps: list[complex] = []
    for p in reps_all[order]:
        if all(abs(p - q) > 1e-10 * scale for q in reps):
            reps.append(complex(p))
    chosen: list[complex] = []
    used = np.zeros(len(reps), bool)
    # max_points=None places EVERY representative (a pair emits two
    # entries, so the emitted length exceeds len(reps))
    target = float("inf") if max_points is None else max_points
    while len(chosen) < target and not used.all():
        if not chosen:
            i = int(np.argmax(np.where(used, -np.inf, np.abs(reps))))
        else:
            cp = np.array(chosen)
            score = np.full(len(reps), -np.inf)
            for k, p in enumerate(reps):
                if not used[k]:
                    score[k] = float(np.sum(np.log(np.maximum(
                        np.abs(p - cp), 1e-300))))
            i = int(np.argmax(score))
        th = reps[i]
        used[i] = True
        if abs(th.imag) <= 1e-12 * scale:
            chosen.append(complex(th.real))
        else:
            chosen.append(th)
            chosen.append(th.conjugate())
    return np.array(chosen, dtype=complex)


def newton_basis_ops(shifts, s: int) -> tuple:
    """Compile ``shifts`` into the static per-step Newton recurrence ops
    for an s-step basis: a tuple of s triples ``(alpha, gamma, sigma)``
    meaning

        v_{j+1} = (A v_j - alpha_j v_j + gamma_j v_{j-1}) / sigma_j

    with ``gamma_j != 0`` exactly on the SECOND step of a conjugate pair
    (gamma_j = beta^2 / sigma_{j-1}). Shifts are modified-Leja-ordered
    first; if fewer than ``s`` distinct shifts are supplied the ordered
    sequence repeats cyclically (the standard CA-GMRES practice when the
    Ritz harvest is shorter than the basis). A conjugate pair whose first
    step would land on the LAST slot is demoted to its real part — a pair
    cannot straddle the block boundary. sigma_j is the capacity estimate
    of module-docstring item 3. All values are Python floats — static
    data every apply reads as scalars."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    ordered = modified_leja(shifts)
    # expand the ordered representatives into s slots
    seq: list[tuple[str, float, float]] = []  # (kind, alpha, |beta|)
    k = 0
    scale = max(float(np.max(np.abs(ordered))), np.finfo(float).tiny)
    reps = [p for p in ordered if p.imag >= -1e-12 * scale]
    while len(seq) < s:
        p = reps[k % len(reps)]
        if abs(p.imag) <= 1e-12 * scale or len(seq) == s - 1:
            seq.append(("r", float(p.real), 0.0))
        else:
            seq.append(("p1", float(p.real), float(abs(p.imag))))
            seq.append(("p2", float(p.real), float(abs(p.imag))))
        k += 1
    seq = seq[:s]
    # capacity sigmas over the actual point sequence (conjugate on p2).
    # Coincident points (cyclic repetition when the shift harvest is
    # shorter than s) are EXCLUDED from the geometric mean — flooring
    # them instead collapses sigma to ~1e-12*scale and the basis column
    # norms explode as (1/sigma)^j (advisor round-3 finding; covered by
    # tests/test_newton_basis.py repeated-shift cases). A point whose
    # predecessors all coincide with it reuses the previous sigma.
    zp = np.array([a + 1j * b if kind == "p1"
                   else a - 1j * b if kind == "p2"
                   else a + 0j for kind, a, b in seq])
    floor = scale * 1e-12
    sig = [max(abs(zp[0]), floor)]
    for j in range(1, s):
        d = np.abs(zp[:j] - zp[j])
        d = d[d > 1e-10 * scale]
        if d.size == 0:
            sig.append(sig[-1])
        else:
            sig.append(max(float(np.exp(np.mean(np.log(d)))), floor))
    ops = []
    for j, (kind, a, b) in enumerate(seq):
        gamma = (b * b / sig[j - 1]) if kind == "p2" else 0.0
        ops.append((float(a), float(gamma), float(sig[j])))
    return tuple(ops)


def newton_recurrence_matrix(ops, dtype) -> np.ndarray:
    """The (s+1, s) matrix B with ``A V[:, :s] = V @ B`` for the Newton
    basis generated by ``ops`` (``newton_basis_ops``). Column j:
    ``A v_j = alpha_j v_j + sigma_j v_{j+1} - gamma_j v_{j-1}``."""
    s = len(ops)
    if s and ops[0][1] != 0.0:
        # gamma couples v_{j-1}; at j=0 there is no previous vector and
        # B[-1, 0] would silently wrap to the LAST row. newton_basis_ops
        # never emits this, but ops is public API.
        raise ValueError("ops[0] must have gamma == 0 (a conjugate pair "
                         "cannot START the recurrence); got "
                         f"gamma={ops[0][1]!r}")
    B = np.zeros((s + 1, s), dtype=np.float64)
    for j, (alpha, gamma, sigma) in enumerate(ops):
        B[j, j] = alpha
        B[j + 1, j] = sigma
        if gamma != 0.0:
            B[j - 1, j] = -gamma
    return B.astype(dtype)


def newton_shifts_from_operator(matvec, b, m: int = 48) -> np.ndarray:
    """One-stop Ritz harvest for the Newton basis: run an m-step Arnoldi
    on the operator (``solvers/arnoldi.arnoldi_ritz``) started at ``b``
    and return its Ritz values — pass the result to
    ``gmres_sstep(..., shifts=...)``. The m applies run on the vectors'
    device, the Hessenberg eigenproblem on the host;
    do this ONCE at setup like ``fsai_setup``. The m matvecs are the
    price of a third of one restart cycle and buy every later cycle a
    conditioned basis."""
    from spmv_torch.solvers.arnoldi import arnoldi_ritz

    return arnoldi_ritz(matvec, b, m=m).values
