"""Run a cell with the control or a planted fault in place, on the card.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--fault control|state_unchanged|half_batch|flip_one]

Each seed is one process, as a benchmark run is; each prints the numbers
compared, with `correct`, as a JSON line. The control must come out not
correct on every seed (PERF.md gives the readings the limits came from).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from port_bench import faults, spec


def one(workload: str, seed: int, seconds: float, fault: str) -> dict:
    from port_bench import device, run
    run._pin_caches(spec.ROOT)
    bench = spec.load_benchmark()
    work, _ = spec.cell(bench, workload)
    device.require_cards(work["chips"])
    hook = faults.control if fault == "control" else faults.FAULTS[fault]
    result, _ = run.execute(workload, seed, seconds, False,
                            hooks={"built": [hook]})
    return {"workload": workload, "seed": seed, "fault": fault,
            "correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"],
            "checks": {k: c["value"] for k, c in result["checks"].items()},
            "metrics": {k: m["value"] for k, m in result["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--fault", default="control")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seconds = args.seconds or spec.load_benchmark()["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.one:
        print(json.dumps(one(args.workload, seeds[0], seconds, args.fault)))
        return 0
    rc = 0
    for seed in seeds:
        proc = subprocess.run(
            [sys.executable, "-m", "port_bench.control", "--one",
             "--workload", args.workload, "--seeds", str(seed),
             "--seconds", str(seconds), "--fault", args.fault],
            capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(json.dumps({"seed": seed, "rc": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
