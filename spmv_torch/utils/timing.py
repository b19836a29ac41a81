"""Phase timing and chained-apply benchmarks on the card.

Counterpart of ``spmv_tpu.utils.timing``. A phase is fenced by
``torch.cuda.synchronize``; kernel times come from CUDA events around a run
of chained applies (each output feeds the next input). The benchmark
helpers need a CUDA tensor: a measurement that finds no card fails instead
of timing the CPU.
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch


def device_sync(x: torch.Tensor) -> None:
    """Wait until the device that holds ``x`` has finished its queued work."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating named phase timers."""

    def __init__(self):
        self.acc: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.acc[name] = self.acc.get(name, 0.0) + seconds

    def report(self) -> str:
        total = sum(self.acc.values())
        lines = ["[------------------ Timings ------------------]",
                 f"{'Phase':<24}{'seconds':>12}"]
        for name in sorted(self.acc):
            lines.append(f"{name:<24}{self.acc[name]:>12.6f}")
        lines.append(f"{'Total':<24}{total:>12.6f}")
        return "\n".join(lines)


def bench_chained(step: Callable, x0, iters: int, warmup: int = 3) -> float:
    """Median seconds per call of a chained x -> step(x) loop, from CUDA
    events over 5 batches of ``iters // 5`` calls. ``x0`` is a tensor or a
    tuple of tensors (a double-single hi/lo pair)."""
    dev = (x0[0] if isinstance(x0, tuple) else x0).device
    if dev.type != "cuda":
        raise RuntimeError(f"bench_chained times the card; x0 is on {dev}")
    x = x0
    for _ in range(warmup):
        x = step(x)
    torch.cuda.synchronize(dev)
    batch = max(1, iters // 5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        for _ in range(batch):
            x = step(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / batch)
    return statistics.median(times)


def measure_copy_bandwidth_gbs(device, nbytes: int = 256 * 1024 * 1024) -> float:
    """Streaming bandwidth (read + write) of the card from a chained
    scale-by-one loop over ``nbytes`` of fp32 — the denominator for
    fractions of a copy measured in the same run."""
    x0 = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    sec = bench_chained(lambda v: v * 1.0000001, x0, iters=20)
    return 2 * nbytes / sec / 1e9


def spmv_traffic_bytes(format_bytes: int, n_in: int, n_out: int, itemsize: int) -> int:
    """Least device-memory traffic of one SpMV: the matrix's bytes, x read
    once and y written once."""
    return format_bytes + (n_in + n_out) * itemsize
