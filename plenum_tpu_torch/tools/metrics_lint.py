"""Lint: every MetricsName must be in the telemetry snapshot schema.

The fleet view (observability/) only shows what the snapshot schema
names. A counter added to `common/metrics.MetricsName` but not to
`SNAPSHOT_SCHEMA` (or to `EXEMPT_METRICS`, with a reason) would flow
into the flushed history but silently bypass the live fleet view — the
exact post-hoc-only blind spot the telemetry plane exists to close.
This lint is wired into tier-1 (tests/test_telemetry.py), so the gap is
a test failure, not a code-review hope.

Checks:
  1. every MetricsName value is in exactly one schema section, or
     exempted with a reason;
  2. no name appears in BOTH the schema and the exemptions;
  3. the schema names no unknown metrics (a typo'd schema entry would
     otherwise "cover" nothing);
  4. no name appears in two schema sections (double-counted in the view).

    python -m plenum_tpu_torch.tools.metrics_lint [--json]
"""
from __future__ import annotations

import argparse
import json
import sys


def run_lint() -> dict:
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.observability.snapshot import (EXEMPT_METRICS,
                                                   SNAPSHOT_SCHEMA)

    declared = {
        value for attr, value in vars(MetricsName).items()
        if not attr.startswith("_") and isinstance(value, str)}
    schema_names: dict[str, list[str]] = {}
    for section, names in SNAPSHOT_SCHEMA.items():
        for name in names:
            schema_names.setdefault(name, []).append(section)

    problems = []
    for name in sorted(declared):
        covered = name in schema_names
        exempt = name in EXEMPT_METRICS
        if covered and exempt:
            problems.append(f"{name}: both in schema "
                            f"({schema_names[name]}) and exempted")
        elif not covered and not exempt:
            problems.append(
                f"{name}: not in any snapshot schema section and not "
                f"exempted — add it to observability/snapshot.py "
                f"SNAPSHOT_SCHEMA (or EXEMPT_METRICS with a reason)")
    for name, sections in sorted(schema_names.items()):
        if name not in declared:
            problems.append(f"{name}: named by schema section(s) "
                            f"{sections} but not a MetricsName")
        if len(sections) > 1:
            problems.append(f"{name}: in multiple schema sections "
                            f"{sections}")
    return {
        "check": "ok" if not problems else "FAIL",
        "metrics": len(declared),
        "covered": sum(1 for n in declared if n in schema_names),
        "exempted": sum(1 for n in declared if n in EXEMPT_METRICS),
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = run_lint()
    if args.json:
        print(json.dumps(out))
    else:
        print(f"metrics_lint: {out['check']} — {out['metrics']} metrics, "
              f"{out['covered']} in schema, {out['exempted']} exempted")
        for p in out["problems"]:
            print(f"  {p}")
    return 0 if out["check"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
