"""Solves back to back, one at a time, each from the next right-hand side
of a pool of seeded loads; the solve in progress when the window's
seconds run out is finished. ``solve_s`` is the whole timed span over the
solves completed in it. A sample of ``keep`` solutions, drawn uniformly
from the window's solves by the run's seed (a reservoir), is judged
afterwards against the reference's CG from the same load.

Traffic parameters: ``pool`` (right-hand sides made per run, uniform on
[-1, 1), used in turn), ``warmup_solves`` (whole solves in
set-up), ``keep`` (the sample's size), ``trace`` (``skip`` and ``count`` of
the applies traced).
"""
from __future__ import annotations

import time

from bench_h100 import inputs
from bench_h100.reference import checks
from bench_h100.system import sync


class Loop:
    def __init__(self, cell):
        t = cell.traffic
        self.cell = cell
        self.rhs = inputs.uniform_vectors(cell.matrix.nrows, int(t["pool"]),
                                          cell.rng)
        self.pool = [cell.system.to_port(b) for b in self.rhs]
        self.solve = cell.method.make_solver(cell.system, cell.config["solver"],
                                             cell.tracer)
        for k in range(int(t["warmup_solves"])):
            self.solve(self.pool[k % len(self.pool)])
        sync(cell.device)
        self.keep = int(t["keep"])
        self.kept = []

    def window(self, seconds: float) -> tuple[dict, dict]:
        pool, solve, rng, kept, keep = (self.pool, self.solve, self.cell.rng,
                                        self.kept, self.keep)
        its = []
        t0 = time.perf_counter()
        while True:
            n = len(its)
            j = n % len(pool)
            x, k = solve(pool[j])
            its.append(k)
            if n < keep:
                kept.append((j, x))
            else:
                i = int(rng.integers(n + 1))
                if i < keep:
                    kept[i] = (j, x)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.cell.device)
        span = time.perf_counter() - t0
        n = len(its)
        return ({"solve_s": span / n},
                {"attempted": n, "cg_iterations": sum(its) / n})

    def collect(self) -> None:
        """Bring the sampled solutions to the host and drop the device's."""
        self.answers = [(j, self.cell.system.from_port(x)) for j, x in self.kept]
        self.kept = []

    def judge(self) -> dict:
        """{number: [reading per answer]}, by the reference."""
        c = self.cell
        return {"solution_error": checks.solution_errors(
            c.matrix, c.device, self.rhs, self.answers, c.config["solver"])}
