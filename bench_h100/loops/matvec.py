"""Operator applies, each to the next vector of a seeded ring, with no
dependence between applies: the host enqueues while the card runs, and
``matvec_ms`` is the whole timed span (ending in one synchronize) over the
applies in it. The last output of every ring slot is kept and judged
afterwards against the reference's apply.

Traffic parameters: ``ring`` (input vectors, uniform on [-1, 1)),
``warmup_applies``, ``trace`` (``skip`` and ``count`` of the applies
traced).
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
        n = cell.matrix.ncols
        self.xs = inputs.uniform_vectors(n, int(t["ring"]), cell.rng)
        self.ring = [cell.system.to_port(x) for x in self.xs]
        op = cell.system.A.matvec
        self.op = op if cell.tracer is None else cell.tracer.wrap(
            "matvec", op, counted=True)
        for k in range(int(t["warmup_applies"])):
            self.op(self.ring[k % len(self.ring)])
        sync(cell.device)
        self.ys = [None] * len(self.ring)

    def window(self, seconds: float) -> tuple[dict, dict]:
        ring, ys, op = self.ring, self.ys, self.op
        r = len(ring)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ys[n % r] = op(ring[n % r])
            n += 1
        sync(self.cell.device)
        span = time.perf_counter() - t0
        return {"matvec_ms": 1e3 * span / n}, {"attempted": n}

    def collect(self) -> None:
        """Bring the kept outputs to the host and drop the device's copies."""
        self.answers = [(k, self.cell.system.from_port(y))
                        for k, y in enumerate(self.ys) if y is not None]
        self.ys = [None] * len(self.ring)

    def judge(self) -> dict:
        """{number: [reading per answer]}, by the reference."""
        a = self.cell.matrix.on(self.cell.device)
        return {"apply_error": [checks.apply_error(a, self.xs[k], y)
                                for k, y in self.answers]}
