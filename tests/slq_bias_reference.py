"""The reference's SLQ log-determinant bias on the 2-D Laplacian, on the CPU.

Runs ``spmv_tpu.solvers.funm.slq_logdet`` (16 Rademacher probes, m = 32
Lanczos steps, ``demo_eig --logdet 32 --probes 16``'s settings) on the
vanilla DIA operator of the g x g Laplacian for several seeds, and prints
each estimate's distance from the exact log det, the sum over (i, j) of
log(4 - 2 cos(i pi/(g+1)) - 2 cos(j pi/(g+1))), in its standard errors.
A mean distance above one standard error over the seeds is the m-step
quadrature's bias; ``chip_smoke.py`` phase 21c gates the port's estimate
against the exact value only where this bias stays under one.

    python tests/slq_bias_reference.py 512 4     # grid, seeds
"""
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spmv_tpu.gen import create_laplace_2d  # noqa: E402
from spmv_tpu.parallel.dist_matrix import build_dist_matrix  # noqa: E402
from spmv_tpu.solvers.funm import slq_logdet  # noqa: E402


def main() -> int:
    g, seeds = int(sys.argv[1]), int(sys.argv[2])
    a = create_laplace_2d(g, g)
    A = build_dist_matrix(a, n_devices=1, local_format="dia")
    tmpl = A.to_dist(np.ones(a.nrows))
    c = 2.0 * np.cos(np.arange(1, g + 1) * np.pi / (g + 1))
    exact = float(np.sum(np.log(4.0 - c[:, None] - c[None, :])))
    est = jax.jit(lambda A_, t, k: slq_logdet(A_.as_linear_operator(), t, k,
                                              n_probes=16, m=32))
    devs = []
    for seed in range(seeds):
        t0 = time.time()
        mean, se = est(A, tmpl, jax.random.key(seed))
        devs.append((float(mean) - exact) / float(se))
        print(f"g={g} seed={seed} logdet={float(mean):.9e} stderr={float(se):.3e} "
              f"exact={exact:.9e} distance={devs[-1]:+.3f} sigma ({time.time() - t0:.1f} s)",
              flush=True)
    print(f"mean distance over {seeds} seeds: {np.mean(devs):+.3f} sigma")
    return 0


if __name__ == "__main__":
    sys.exit(main())
