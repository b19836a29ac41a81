"""The benchmark is driven by data: what BENCHMARK.json names is found by
name, and a configuration, a cell and a per-layer metric are added by
adding files and entries alone."""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import torch

from bench_h100 import harness

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def test_every_name_resolves_to_its_files():
    bench = _bench(ROOT)
    for wl in bench["workloads"]:
        spec = harness.read_spec(ROOT, wl["name"])
        assert spec.config["name"] == wl["config"]
        for kind, name in (("matrices", spec.config["matrix"]["generator"]),
                           ("methods", spec.config["solver"]["method"]),
                           ("loops", spec.traffic["loop"])):
            harness.load_module(ROOT, kind, name)
        assert spec.end_to_end[0]["name"] == "setup_s"
        assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in bench["per_layer"]:
        # one reader a quantity, named by the metric's name up to its first
        # dot; BENCHMARK.json alone says where a metric reads and what it moves
        mod = harness.load_module(ROOT, "metrics", m["name"].split(".")[0])
        assert callable(mod.read)
        assert not {"NAME", "UNIT", "LAYER", "MOVES", "WORKLOADS"} & set(vars(mod))


def test_benchmark_json_keeps_the_contract_shape():
    bench = _bench(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench_h100").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_config_cell_and_metric_are_found(tiny_root):
    before = _digests(tiny_root)
    b = tiny_root / "bench_h100"
    # another deployment: the port's RCM, dual-WELL storage, Jacobi-PCG, fp32
    cfg = json.loads((b / "configs" / "lap2d_3200_sym_f64.json").read_text())
    cfg.update(name="lap2d_48_f32", dtype="float32", reorder="rcm",
               local_format="well")
    cfg["matrix"].update(nx=48, ny=48)
    cfg["solver"].update(preconditioner="jacobi", rtol=1e-5, kmax=500)
    (b / "configs" / "lap2d_48_f32.json").write_text(json.dumps(cfg))
    (b / "traffic" / "solve_wide.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "solve.json").read_text()), "pool": 3}))
    (b / "workloads" / "lap2d_48.wide.json").write_text(
        json.dumps({"limits": {"solution_error": 1e-3}}))
    (b / "metrics" / "solves_seen.py").write_text(
        'def read(run):\n    return float(run.counters["attempted"])\n')
    bench = _bench(tiny_root)
    bench["configs"].append({"name": "lap2d_48_f32", "source": "https://example.org",
                             "file": "bench_h100/configs/lap2d_48_f32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "lap2d_48.wide", "config": "lap2d_48_f32",
                               "traffic": "solve_wide", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lap2d_3200.cg" in m.get("workloads", ()):  # existing readers reused
            m["workloads"].append("lap2d_48.wide")
    bench["per_layer"].append({"name": "solves_seen", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "solver", "moves": "solve_s",
                               "workloads": ["lap2d_48.wide"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.read_spec(tiny_root, "lap2d_48.wide")
    assert spec.config["dtype"] == "float32" and spec.traffic["pool"] == 3
    out = harness.run_cell(tiny_root, "lap2d_48.wide", 2**31 + 11, 0.3, True,
                           torch.device("cpu"), 0.0)
    # on the CPU nothing runs on a device, so the device-trace readers
    # find nothing to read and their metrics are left out of the line
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"solves_seen", "cg_iterations", "assemble_s"}
    assert out["metrics"]["solves_seen"]["value"] >= 1
    assert 1 <= out["metrics"]["cg_iterations"]["value"] < 500
    out = harness.run_cell(tiny_root, "lap2d_48.wide", 7, 0.3, False,
                           torch.device("cpu"), 0.0)
    assert set(out["metrics"]) == {"setup_s", "solve_s"}
    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
