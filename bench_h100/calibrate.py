"""The readings that the limits of ``workloads/<cell>.json`` are set from.

    python bench_h100/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--control-seconds <s>]

In one process (the set-up is paid once a side): for every seed, a window
of ``--seconds`` at the cell's own load and the numbers that decide
``correct`` on the answers it produced; then the same for the control, the
program's own float32 path (the configuration's float64 stepped down once),
which the limits must fail. Prints one JSON line a seed and side, and a
summary: the largest sound reading and the smallest control reading of each
number. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONTROL_DTYPE = {"float64": "float32"}


def readings(root: Path, cell: str, seeds, seconds: float, device,
             control: bool = False):
    """[(seed, {number: [reading per answer]}, attempted)] over ``seeds``
    on one assembled system."""
    from bench_h100 import harness

    spec = harness.read_spec(root, cell)
    config = dict(spec.config)
    if control:
        config["dtype"] = CONTROL_DTYPE[config["dtype"]]
    c = harness.build(root, spec, device, config=config)
    loop_cls = harness.load_module(root, "loops", spec.traffic["loop"]).Loop
    out = []
    for seed in seeds:
        c.rng = np.random.default_rng(seed % 2**64)
        loop = loop_cls(c)
        _, counters = loop.window(seconds)
        loop.collect()
        out.append((seed, loop.judge(), counters["attempted"]))
    c.system.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default: --seconds)")
    args = ap.parse_args(argv)
    # the root, not this folder, whose module names (trace) shadow the stdlib's
    sys.path[0] = str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    summary = {}
    control_seconds = args.control_seconds or args.seconds
    for side, seeds, seconds in (("sound", args.seeds, args.seconds),
                                 ("control", args.control_seeds, control_seconds)):
        t0 = time.perf_counter()
        for seed, numbers, attempted in readings(
                ROOT, args.workload, [int(s) for s in seeds.split(",")],
                seconds, device, control=side == "control"):
            print(json.dumps({"side": side, "seed": seed, "attempted": attempted,
                              "readings": numbers}), flush=True)
            for name, values in numbers.items():
                key = f"{side}.{name}"
                pick = max if side == "sound" else min
                summary[key] = pick([summary.get(key, pick(values)), *values])
        summary[f"{side}.seconds"] = time.perf_counter() - t0
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
