"""Run one cell of the benchmark once and print its result line.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(read from a profiled slice of the window). The last line of standard
output is the result (JSON); the last lines of standard error are the
numbers that decided ``correct``, each beside its limit. Exits non-zero,
with no result, where there is no CUDA card (or fewer than the cell asks
for), or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # a library that would load JAX by itself must not (transformers)
    os.environ.setdefault("USE_FLAX", "0")
    # the root, not this folder, whose module names (trace) shadow the stdlib's
    sys.path[0] = str(ROOT)
    import torch

    from bench_h100 import harness

    chips = int(harness.read_spec(ROOT, args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
