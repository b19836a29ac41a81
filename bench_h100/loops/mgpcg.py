"""HPCG's sets back to back: each a ``kmax``-iteration MG-PCG solve from
x0 = 0 of the next right-hand side of a pool of seeded loads, one at a
time; the set in progress when the window's seconds run out is finished.
``solve_s`` is the whole timed span over the sets completed in it. A
sample of ``keep`` solutions, drawn uniformly from the window's sets by
the run's seed (a reservoir), is judged afterwards against the
reference's MG-PCG from the same load (``reference/hpcg_mg.py``), run on
the benchmark's own level matrices.

The window's loop is ``loops/solve.py``'s; this one makes the multigrid's
levels (the method's ``levels``) and adds the counters its metrics read:
``mg_residual_reduction`` (the last set's |r| / |r0|) and the least bytes
of one V-cycle and of its SymGS sweeps (``roofline_mg.py``).

Traffic parameters: those of ``loops/solve.py``.
"""
from __future__ import annotations

from pathlib import Path

from bench_h100 import harness, inputs, roofline_mg
from bench_h100.reference import hpcg_mg
from bench_h100.system import sync

solve_loop = harness.load_module(Path(__file__).resolve().parents[2], "loops",
                                 "solve")


def _warm_profiler(device) -> None:
    """One profiler session around a trivial operation, so that the
    profiler's first start (seconds on the card, in its tracing library's
    set-up) falls in set-up and not inside the window's traced slice."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        sync(device)


class Loop(solve_loop.Loop):
    def __init__(self, cell):
        t = cell.traffic
        self.cell = cell
        self.levels = cell.method.levels(cell.config, cell.matrix)
        self.rhs = inputs.uniform_vectors(cell.matrix.nrows, int(t["pool"]),
                                          cell.rng)
        self.pool = [cell.system.to_port(b) for b in self.rhs]
        self.solve, self.last = cell.method.make_solver(
            cell.system, cell.config["solver"], self.levels, cell.tracer)
        for k in range(int(t["warmup_solves"])):
            self.solve(self.pool[k % len(self.pool)])
        if cell.tracer is not None:
            _warm_profiler(cell.device)
        sync(cell.device)
        self.keep = int(t["keep"])
        self.kept = []

    def window(self, seconds: float) -> tuple[dict, dict]:
        e2e, counters = super().window(seconds)
        counters["mg_residual_reduction"] = float(self.last["reduction"])
        counters.update(roofline_mg.cycle_bytes(self.levels,
                                                self.cell.config["dtype"]))
        return e2e, counters

    def collect(self) -> None:
        """The sampled solutions to the host; the program's solver, its
        levels and the pool let go."""
        self.solve = self.last = None
        self.pool = []
        super().collect()

    def judge(self) -> dict:
        """{number: [reading per answer]}, by the reference."""
        c = self.cell
        return {"solution_error": hpcg_mg.solution_errors(
            self.levels, c.device, self.rhs, self.answers, c.config["solver"])}
