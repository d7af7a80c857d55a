"""Lint: every registered sim-fuzz kind must have a tier-1 smoke rung.

The fuzz suite's contract is that each scenario kind runs its 20+-seed
sweep under the `slow` marker AND keeps at least one always-on smoke
rung in the default (tier-1) suite. A kind that exists only in the slow
sweep is SILENT coverage loss: the default CI run would green-light a
change that breaks the scenario outright, and nobody notices until the
next manual sweep. This lint makes that gap a tier-1 test failure, the
exact discipline tools/metrics_lint.py applies to the snapshot schema.

Registered kinds are discovered from tests/test_torch_sim_fuzz.py by AST:

* every top-level ``run_*_scenario`` function (a scenario kind), and
* every top-level ``run_*_with_*`` function (a composition runner)

must be REFERENCED from at least one top-level ``test_*`` function that
is NOT decorated ``pytest.mark.slow`` (the smoke rung; lambdas inside
the test body count — the AST walk covers them).

    python -m plenum_tpu_torch.tools.fuzz_lint [--json] [--file PATH]
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys

DEFAULT_FUZZ_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "test_torch_sim_fuzz.py")


def _is_slow(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        # pytest.mark.slow / mark.slow / @slow — match on the tail name
        node = dec
        if isinstance(node, ast.Call):
            node = node.func
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        if "slow" in parts:
            return True
    return False


def _referenced_names(fn: ast.FunctionDef) -> set[str]:
    return {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}


def run_lint(path: str = DEFAULT_FUZZ_FILE) -> dict:
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)

    scenarios: list[str] = []
    fast_tests: dict[str, set[str]] = {}
    slow_tests: dict[str, set[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        name = node.name
        if name.startswith("run_") and (
                name.endswith("_scenario") or "_with_" in name):
            scenarios.append(name)
        elif name.startswith("test_"):
            (slow_tests if _is_slow(node) else fast_tests)[name] = \
                _referenced_names(node)

    problems = []
    covered = {}
    for scenario in scenarios:
        smoke = sorted(t for t, refs in fast_tests.items()
                       if scenario in refs)
        sweeps = sorted(t for t, refs in slow_tests.items()
                        if scenario in refs)
        covered[scenario] = {"smoke": smoke, "sweeps": sweeps}
        if not smoke:
            problems.append(
                f"{scenario}: no tier-1 smoke rung — only "
                f"{sweeps or 'NOTHING'} runs it; a fuzz kind that lives "
                f"only in the slow sweep is silent coverage loss (add a "
                f"non-slow test_*_smoke that calls it)")
    if not scenarios:
        problems.append(f"no run_*_scenario functions found in {path} — "
                        f"the lint's discovery rule no longer matches "
                        f"the suite's naming convention")
    return {
        "check": "ok" if not problems else "FAIL",
        "file": path,
        "scenarios": len(scenarios),
        "smoke_covered": sum(1 for v in covered.values() if v["smoke"]),
        "kinds": covered,
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--file", default=DEFAULT_FUZZ_FILE)
    args = ap.parse_args(argv)
    out = run_lint(args.file)
    if args.json:
        print(json.dumps(out))
    else:
        print(f"fuzz_lint: {out['check']} — {out['scenarios']} scenario "
              f"runners, {out['smoke_covered']} with tier-1 smoke rungs")
        for p in out["problems"]:
            print(f"  {p}")
    return 0 if out["check"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
