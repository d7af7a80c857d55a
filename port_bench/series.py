"""Run one cell several times, one process a run, and summarise the spread.

    python3 -m port_bench.series --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--trace 0|1] [--out FILE]

Each run is `python3 -m port_bench.run`, as the check runs it. Every
result line goes to --out (JSON lines), and the summary gives, for each
metric, the median and the spread: the distance between the first and
third quartiles (`statistics.quantiles(values, n=4)`) over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from port_bench import spec


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    median = statistics.median(values)
    if median == 0:
        return 0.0 if q1 == q3 else float("inf")
    return (q3 - q1) / median


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seconds = args.seconds or spec.load_benchmark()["run_seconds"]
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "port_bench.run", "--workload",
             args.workload, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall}
        # the run's notes (set-up milestones, counts) and its checks
        row["stderr_tail"] = proc.stderr[-3000:]
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, ValueError):
            print(row["stderr_tail"], file=sys.stderr, flush=True)
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")}
                         | {"correct": row.get("result", {}).get("correct"),
                            "metrics": {k: v["value"] for k, v in row.get(
                                "result", {}).get("metrics", {}).items()}}),
              flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    ok = [r["result"] for r in rows if "result" in r]
    names = sorted({k for r in ok for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        line = {"metric": name, "n": len(vals),
                "median": statistics.median(vals)}
        if len(vals) >= 2:
            line["spread"] = spread(vals)
        print(json.dumps(line), flush=True)
    return 0 if len(ok) == len(rows) and all(r["correct"] for r in ok) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
