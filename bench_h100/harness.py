"""One run of one cell: set-up, the measured window, the check and the
result line, all driven by the names in ``BENCHMARK.json``.

A cell's parts are found by name under ``bench_h100/``: the configuration
file that ``BENCHMARK.json`` names, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the limits of the numbers that decide
``correct``), ``matrices/<generator>.py``, ``methods/<method>.py``,
``loops/<loop>.py`` and ``metrics/<quantity>.py``, the reader of every
per-layer metric whose name starts ``<quantity>`` (``matvec_roofline.solve``
and ``matvec_roofline.matvec`` share one). BENCHMARK.json is the only
registry: adding a configuration, a cell or a per-layer metric adds files
and entries; it edits no code.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from bench_h100 import roofline
from bench_h100.system import System, sync

PACKAGE = "bench_h100"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """``bench_h100/<kind>/<name>.py`` under ``root``, imported by path."""
    path = Path(root) / PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    """Everything a cell is, read from the files its names point to."""

    workload: dict      # the cell's entry in BENCHMARK.json
    config: dict        # the configuration's file
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # workloads/<cell>.json "limits"
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list


def read_spec(root: Path, cell: str) -> Spec:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if cell not in wl:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl[cell]["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in reported)]
    return Spec(
        workload=wl[cell], config=load_json(root / cfg["file"]),
        traffic=load_json(root / PACKAGE / "traffic" / f"{wl[cell]['traffic']}.json"),
        limits=load_json(root / PACKAGE / "workloads" / f"{cell}.json")["limits"],
        end_to_end=e2e, per_layer=per_layer)


@dataclasses.dataclass
class Cell:
    """What a loop works with."""

    config: dict
    traffic: dict
    matrix: object      # reference.csr.CSR, original ordering
    system: System
    method: object
    device: object
    tracer: object = None
    rng: np.random.Generator | None = None


def build(root: Path, spec: Spec, device, tracer=None, config=None) -> Cell:
    """Make the matrix and assemble the system (``config`` replaces the
    configuration's file, as the calibration's control does)."""
    config = config or spec.config
    gen = load_module(root, "matrices", config["matrix"]["generator"])
    matrix = gen.generate(config["matrix"])
    system = System(config, matrix, device)
    method = load_module(root, "methods", config["solver"]["method"])
    return Cell(config, spec.traffic, matrix, system, method, device, tracer)


@dataclasses.dataclass
class Run:
    """What the per-layer metric readers read."""

    counters: dict
    host: dict
    trace: object
    roofline_s: float


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run: set-up (from ``t_start``), the window, the check. Returns
    the result line's object."""
    import torch

    from bench_h100.trace import Tracer

    spec = read_spec(root, cell)
    tr = spec.traffic["trace"]
    tracer = Tracer(tr["skip"], tr["count"], device) if trace else None
    c = build(root, spec, device, tracer)
    c.rng = np.random.default_rng(seed % 2**64)
    loop = load_module(root, "loops", spec.traffic["loop"]).Loop(c)
    if tracer is not None:
        tracer.calls = 0
    sync(device)
    setup_s = time.perf_counter() - t_start

    # no collector pauses inside the window; the loops make no cycles
    gc.collect()
    gc.disable()
    try:
        e2e, counters = loop.window(seconds)
    finally:
        gc.enable()
    if tracer is not None:
        tracer.close()
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(spec.workload["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if cuda else 0}
    loop.collect()
    c.system.free()
    readings = loop.judge()

    checks, failed = {}, 0
    for name, values in readings.items():
        limit = float(spec.limits[name])
        failed += sum(not (v <= limit) for v in values)
        worst = max(values, key=lambda v: (v != v, v)) if values else float("nan")
        checks[name] = {"value": worst, "limit": limit}
    correct = counters["attempted"] > 0 and all(
        ch["value"] <= ch["limit"] for ch in checks.values())

    out = {"correct": bool(correct), "attempted": int(counters["attempted"]),
           "failed": failed}
    if trace:
        summary = tracer.summarize()
        run = Run(counters, {"assemble_s": c.system.assemble_s},
                  summary, roofline.apply_seconds(
                      c.matrix, c.config["storage"] == "symmetric",
                      c.config["dtype"]))
        metrics = {}
        for m in spec.per_layer:
            reader = load_module(root, "metrics", m["name"].split(".")[0])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            out["breakdown"] = {"device_ops": summary.device_ops,
                                "idle_gaps": summary.idle_gaps}
    else:
        # a metric split by cells ("solve_s.<split>") reads its base quantity
        values = {"setup_s": setup_s, **e2e}
        out["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
                          for m in spec.end_to_end}
    out["counters"] = counters
    out["device"] = dev
    out["checks"] = checks
    for name, ch in checks.items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    return out
