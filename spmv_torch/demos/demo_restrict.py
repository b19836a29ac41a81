#!/usr/bin/env python
"""demo_restrict — the multigrid restriction/prolongation cycle (PyTorch/CUDA
port).

Counterpart of ``spmv_tpu/demos/demo_restrict.py``: build the 1-D
full-weighting restriction R (fine n -> coarse n/2) as a rectangular ELL
``DistMatrix`` (rows partitioned over the coarse grid, columns over the
fine grid, ``--devices`` stacked shards), restrict a fine vector, prolongate
it back with R^T by ``matvec_transpose`` (its ghost-column terms return to
their owners by the reverse exchange) and by the cached ``transposed()``
operator, check both and the Galerkin product R R^T against the host CSR,
and run the reference's 8-step damped prolongation loop through the
pre-built R^T. The reference's one-device path goes through its ELL format
ops, which are not ported; here every ``--devices`` count, 1 included,
runs the distributed operator.

Usage:
  python -m spmv_torch.demos.demo_restrict --n 4194304 --devices 4
  python -m spmv_torch.demos.demo_restrict --n 1024 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

TOL = 1e-12  # float64 applies vs the host CSR, relative to the oracle's max


def restriction_1d(n_fine: int):
    """Full weighting: coarse i <- [1/4, 1/2, 1/4] at fine 2i."""
    from spmv_torch.formats.csr import CSRHost

    n_coarse = n_fine // 2
    rows, cols, vals = [], [], []
    for w, off in ((0.25, -1), (0.5, 0), (0.25, 1)):
        i = np.arange(n_coarse, dtype=np.int64)
        j = 2 * i + off
        ok = (j >= 0) & (j < n_fine)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(np.full(ok.sum(), w))
    return CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        n_coarse, n_fine,
    )


def _check(name: str, got: np.ndarray, want: np.ndarray) -> float:
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))
    if not err <= TOL:
        raise SystemExit(f"demo_restrict: {name} is {err:.3e} from the host "
                         f"oracle (tolerance {TOL:.0e})")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1024, help="fine grid size")
    ap.add_argument("--devices", type=int, default=1,
                    help="number of stacked shards (default 1)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the operator and vectors live (default cuda)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass --device "
                 "cpu to run on the CPU)")
    from spmv_torch.gen import gaussian_bump
    from spmv_torch.parallel.dist_matrix import build_dist_matrix

    r = restriction_1d(args.n)
    rt = r.transpose()
    A = build_dist_matrix(r, n_devices=args.devices, dtype=np.float64,
                          device=torch.device(args.device))
    fine = gaussian_bump(args.n)

    q = A.matvec(A.to_dist(fine))                      # restrict
    coarse = A.from_dist(q)
    back = A.from_dist(A.matvec_transpose(q), side="col")  # prolongate
    Rt = A.transposed()
    if A.transposed() is not Rt or Rt.transposed() is not A:
        raise SystemExit("demo_restrict: transposed() is not cached")
    if Rt.col_pad != A.row_pad:
        raise SystemExit("demo_restrict: R and R^T layouts do not compose")
    back_t = Rt.from_dist(Rt.matvec(q))
    # the Galerkin product R R^T on the coarse vector
    galerkin = A.from_dist(A.matvec(Rt.matvec(q)))

    errs = dict(restrict=_check("R f", coarse, r.matvec(fine)),
                prolong=_check("R^T q (matvec_transpose)", back, rt.matvec(coarse)),
                prolong_transposed=_check("R^T q (transposed())", back_t,
                                          rt.matvec(coarse)),
                galerkin=_check("R R^T q", galerkin, r.matvec(rt.matvec(coarse))))
    print(f"devices={args.devices}  fine n={args.n}  coarse n={r.nrows}  "
          f"nnz(R)={r.nnz}  ghost rounds={A.plan.rounds}")
    print(f"|fine|   = {np.linalg.norm(fine):.12e}")
    print(f"|R f|    = {np.linalg.norm(coarse):.12e}")
    print(f"|R^T R f|= {np.linalg.norm(back):.12e}")
    print(f"|R R^T R f|= {np.linalg.norm(galerkin):.12e}")
    print("max rel err vs host CSR: " + "  ".join(f"{k}={v:.3e}" for k, v in errs.items()))

    # the hot-loop form: 8 damped prolongation steps through the pre-built R^T
    v = A.to_dist(fine)
    vv = fine.copy()
    for _ in range(8):
        v = 0.5 * v + 0.5 * Rt.matvec(A.matvec(v))
        vv = 0.5 * vv + 0.5 * rt.matvec(r.matvec(vv))
    loop_err = _check("the 8-step loop", A.from_dist(v, side="col"), vv)
    print(f"8-step prolongation loop via transposed(): max rel err {loop_err:.3e}")
    print("restrict/prolongate verified against the host CSR")
    return 0


if __name__ == "__main__":
    sys.exit(main())
