"""Perf-regression sentinel: the bench trajectory as a first-class ledger.

Five ``BENCH_r*.json`` files record the per-round bench results, but
nothing folds them into a TRAJECTORY — so a silent 20% TPS drop between
rounds would ship undetected, and the one real scare so far (the
config5 drop, later diagnosed as bench-host contention) had to be
triaged by hand. This tool:

* **normalizes** every ``BENCH_r*.json`` plus every appended
  ``BENCH_trajectory.jsonl`` row (bench.py writes one per run) into one
  row per round per config, provenance-tagged (``jax_source``,
  ``host_cores``, ``calib_ms``);
* **renders** the per-config trend (text sparklines, --json for tools);
* issues **variance-aware regression verdicts**: a drop only PAGES
  ("regression") when (a) it exceeds the config's observed
  interleaved-median spread and (b) the baseline round actually carried
  a spread (i.e. was a median of repeat runs). A drop past tolerance on
  a single-pass baseline stays a WARNING — the config5 false alarm was
  exactly a single-pass figure moving inside host noise, and a page an
  operator learns to ignore is worse than none. Headline figures are
  only compared when both rounds name the same ``headline_config``
  (the r01→r02 94% "drop" was the honest-baseline switch from
  in-process to TCP, not a regression — unnamed or changed headline
  configs are "not_comparable" by construction);
* **lints provenance**: a bench file with no ``jax_source`` cannot say
  whether its device numbers came from the live relay, the JAX-on-CPU
  pipeline, or the plain-CPU fallback — the sentinel reports it as a
  lint problem instead of silently folding it.

Tolerance: with an observed spread, tol = max(spread_frac, 0.15);
without one, 0.30 (~two single-pass host-noise bands — the measured
r05 interleaved spread alone is ~24%). Drops past tol/2 warn.

    python -m plenum_tpu_torch.tools.perf_sentinel [--dir .] [--json]
    python -m plenum_tpu_torch.tools.perf_sentinel --check   # tier-1 self-test

Exit: 0 clean/warnings, 2 on any "regression" verdict (--strict also
fails on provenance lint problems).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

# config label -> (value key, spread key) in a bench result dict
CONFIG_KEYS = (
    ("headline", "value", "spread"),
    ("cpu", "cpu_tps", "cpu_spread"),
    ("tcp", "tcp_tps", "tcp_spread"),
    ("tcpsvc", "tcpsvc_tps", "tcpsvc_spread"),
    ("tcpsvcjax", "tcpsvcjax_tps", None),
    ("tcp7", "tcp7_tps", None),
    ("jax", "jax_tps", None),
    ("signers", "distinct_signers_tps", None),
    ("mixed", "config2_mixed_3inst_tps", None),
    ("reads", "config3_proof_reads_per_s", None),
    ("vc_under_load", "config4_vc_under_load_tps", None),
    ("sim25", "config5_sim25_tps", None),
)

# no spread on the baseline: two independent single-pass measurements
# can sit two noise bands apart without either being wrong
NOISE_TOLERANCE = 0.30
# an interleaved-median spread tighter than this is luck, not precision
MIN_TOLERANCE = 0.15

SPARK_TICKS = "▁▂▃▄▅▆▇█"


def spread_frac(spread) -> Optional[float]:
    """(max - min) / max of an interleaved-run spread dict, or None."""
    if not isinstance(spread, dict):
        return None
    lo, hi = spread.get("min"), spread.get("max")
    if not isinstance(hi, (int, float)) or not isinstance(lo, (int, float)) \
            or hi <= 0:
        return None
    return (hi - lo) / hi


def trajectory_row(parsed: dict, label: str = "") -> dict:
    """One normalized trajectory row from a bench result dict: the
    per-config values + spreads that trend, and the provenance tags
    that make the row citable."""
    configs: dict[str, dict] = {}
    for config, value_key, spread_key in CONFIG_KEYS:
        value = parsed.get(value_key)
        if not isinstance(value, (int, float)):
            continue                # errors land as strings — not a point
        entry: dict = {"value": float(value)}
        frac = spread_frac(parsed.get(spread_key)) if spread_key else None
        if frac is not None:
            entry["spread_frac"] = round(frac, 4)
        configs[config] = entry
    row = {"label": label, "configs": configs}
    if parsed.get("headline_config"):
        row["headline_config"] = parsed["headline_config"]
    for key, src in (("jax_source", "jax_source"),
                     ("host_cores", "host_cores"),
                     ("calib_ms", "config5_calib_ms")):
        if parsed.get(src) is not None:
            row[key] = parsed[src]
    return row


def append_trajectory(parsed: dict, path: str, label: str = "") -> dict:
    """bench.py's seam: normalize `parsed` and append it to the
    append-only trajectory ledger (JSONL). Returns the row written."""
    row = trajectory_row(parsed, label=label)
    with open(path, "a") as fh:
        fh.write(json.dumps(row, sort_keys=True) + "\n")
    return row


def load_rows(bench_dir: str = ".",
              trajectory: Optional[str] = None) -> list[dict]:
    """Every BENCH_r*.json (round order) then every trajectory-ledger
    row (append order), normalized. A malformed file becomes a row with
    a `problems` list instead of being silently skipped."""
    rows: list[dict] = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "BENCH_r*.json"))):
        label = os.path.basename(path).replace("BENCH_", "") \
            .replace(".json", "")
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            rows.append({"label": label, "configs": {},
                         "problems": [f"unreadable: {e}"]})
            continue
        parsed = doc.get("parsed") if isinstance(doc, dict) else None
        if not isinstance(parsed, dict):
            rows.append({"label": label, "configs": {},
                         "problems": ["no parsed bench result"]})
            continue
        rows.append(trajectory_row(parsed, label=label))
    path = trajectory or os.path.join(bench_dir, "BENCH_trajectory.jsonl")
    if os.path.exists(path):
        with open(path) as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    rows.append({"label": f"traj{i}", "configs": {},
                                 "problems": ["unreadable trajectory row"]})
                    continue
                if "configs" not in row:     # raw bench dict appended
                    row = trajectory_row(row, label=f"traj{i}")
                row.setdefault("label", f"traj{i}")
                rows.append(row)
    return rows


def lint_provenance(rows: list[dict]) -> list[str]:
    """Provenance problems, one line per offence. jax_source is the
    hard requirement: without it a device figure is uninterpretable."""
    problems: list[str] = []
    for row in rows:
        problems.extend(f"{row['label']}: {p}"
                        for p in row.get("problems", ()))
        if not row.get("configs"):
            continue
        if row.get("jax_source") is None:
            problems.append(
                f"{row['label']}: missing jax_source provenance — cannot "
                f"tell live-relay from cpu-fallback figures")
        if row.get("host_cores") is None:
            problems.append(f"{row['label']}: missing host_cores provenance")
    return problems


def _tolerance(observed_spreads: list[float]) -> float:
    if observed_spreads:
        return max(max(observed_spreads), MIN_TOLERANCE)
    return NOISE_TOLERANCE


def verdicts(rows: list[dict]) -> list[dict]:
    """Round-over-round verdicts, one per (config, consecutive pair).

    verdict ∈ ok | warn | regression | not_comparable. "regression"
    requires BOTH gates: drop > tolerance AND a spread-carrying
    (interleaved-median) baseline; a single-pass baseline caps at
    "warn" no matter how big the drop reads — the gating policy
    docs/observability.md spells out."""
    out: list[dict] = []
    configs = sorted({c for row in rows for c in row.get("configs", {})})
    for config in configs:
        series = [(row, row["configs"][config]) for row in rows
                  if config in row.get("configs", {})]
        seen_spreads: list[float] = []
        for (prev_row, prev), (cur_row, cur) in zip(series, series[1:]):
            for entry in (prev, cur):
                if entry.get("spread_frac") is not None:
                    seen_spreads.append(entry["spread_frac"])
            v = {"config": config, "from": prev_row["label"],
                 "to": cur_row["label"], "prev": prev["value"],
                 "value": cur["value"]}
            if config == "headline":
                hc0 = prev_row.get("headline_config")
                hc1 = cur_row.get("headline_config")
                if not hc0 or not hc1 or hc0 != hc1:
                    v.update({"verdict": "not_comparable",
                              "reason": f"headline config "
                                        f"{hc0 or '?'} -> {hc1 or '?'}"})
                    out.append(v)
                    continue
            if prev["value"] <= 0:
                continue
            change = (cur["value"] - prev["value"]) / prev["value"]
            tol = _tolerance(seen_spreads)
            v["change_pct"] = round(change * 100, 1)
            v["tolerance_pct"] = round(tol * 100, 1)
            drop = -change
            if drop > tol:
                if prev.get("spread_frac") is not None:
                    v["verdict"] = "regression"
                    v["reason"] = (f"drop {drop:.1%} exceeds spread-based "
                                   f"tolerance {tol:.1%} on a median "
                                   f"baseline")
                else:
                    v["verdict"] = "warn"
                    v["reason"] = (f"drop {drop:.1%} exceeds {tol:.1%} but "
                                   f"baseline is single-pass (no spread) — "
                                   f"likely host noise, re-measure with "
                                   f"interleaved repeats")
            elif drop > tol / 2:
                v["verdict"] = "warn"
                v["reason"] = f"drop {drop:.1%} within tolerance {tol:.1%}"
            else:
                v["verdict"] = "ok"
            out.append(v)
    return out


def sparkline(values: list[float], width: int = 24) -> str:
    if not values:
        return ""
    values = values[-width:]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return SPARK_TICKS[0] * len(values)
    return "".join(
        SPARK_TICKS[min(len(SPARK_TICKS) - 1,
                        int((v - lo) / (hi - lo) * len(SPARK_TICKS)))]
        for v in values)


def report(bench_dir: str = ".", trajectory: Optional[str] = None) -> dict:
    rows = load_rows(bench_dir, trajectory)
    vs = verdicts(rows)
    return {
        "rows": rows,
        "verdicts": vs,
        "regressions": [v for v in vs if v["verdict"] == "regression"],
        "warnings": [v for v in vs if v["verdict"] == "warn"],
        "lint": lint_provenance(rows),
    }


def format_report(rep: dict) -> str:
    lines = [f"PERF TRAJECTORY  rounds={len(rep['rows'])}"]
    configs = sorted({c for row in rep["rows"]
                      for c in row.get("configs", {})})
    for config in configs:
        series = [(row["label"], row["configs"][config]["value"])
                  for row in rep["rows"]
                  if config in row.get("configs", {})]
        values = [v for _, v in series]
        lines.append(f"  {config:<14} {sparkline(values)}  "
                     f"{values[-1]:>10.1f}  ({series[0][0]}→"
                     f"{series[-1][0]}, n={len(values)})")
    for v in rep["verdicts"]:
        if v["verdict"] in ("regression", "warn", "not_comparable"):
            tag = {"regression": "REGRESSION", "warn": "warn",
                   "not_comparable": "n/c"}[v["verdict"]]
            lines.append(f"  [{tag}] {v['config']} {v['from']}→{v['to']}: "
                         f"{v.get('reason', '')}")
    for p in rep["lint"]:
        lines.append(f"  [lint] {p}")
    if not rep["regressions"]:
        lines.append("  no regressions")
    return "\n".join(lines)


# --- self test (tier-1) ------------------------------------------------------

def self_check() -> list[str]:
    """Synthetic-trajectory self-test of the verdict and lint rules."""
    problems: list[str] = []

    def mk(label, tps, spread=None, headline=380.0, hc="tcpsvc", **kw):
        parsed = {"value": headline, "headline_config": hc,
                  "tcpsvc_tps": tps, "jax_source": "live-relay",
                  "host_cores": 8, **kw}
        if spread:
            parsed["tcpsvc_spread"] = spread
            parsed["spread"] = spread
        return trajectory_row(parsed, label=label)

    # 1. a stable config inside its spread -> no regression, no warn
    rows = [mk("a", 400.0, spread={"min": 360.0, "max": 440.0, "n": 3}),
            mk("b", 390.0, spread={"min": 350.0, "max": 430.0, "n": 3})]
    vs = [v for v in verdicts(rows) if v["config"] == "tcpsvc"]
    if any(v["verdict"] != "ok" for v in vs):
        problems.append(f"stable series not ok: {vs}")

    # 2. a >spread drop on a median baseline -> exactly one regression
    rows = [mk("a", 400.0, spread={"min": 360.0, "max": 440.0, "n": 3}),
            mk("b", 250.0, spread={"min": 240.0, "max": 260.0, "n": 3})]
    vs = [v for v in verdicts(rows) if v["config"] == "tcpsvc"]
    if [v["verdict"] for v in vs] != ["regression"]:
        problems.append(f"median-baseline cliff not a regression: {vs}")

    # 3. the same cliff on a single-pass baseline stays a WARNING —
    #    the host-contention rule
    rows = [mk("a", 400.0), mk("b", 250.0)]
    vs = [v for v in verdicts(rows) if v["config"] == "tcpsvc"]
    if [v["verdict"] for v in vs] != ["warn"]:
        problems.append(f"single-pass cliff should warn, got: {vs}")

    # 4. a borderline drop (between tol/2 and tol) -> warn, not page
    rows = [mk("a", 400.0, spread={"min": 360.0, "max": 440.0, "n": 3}),
            mk("b", 350.0, spread={"min": 340.0, "max": 365.0, "n": 3})]
    vs = [v for v in verdicts(rows) if v["config"] == "tcpsvc"]
    if [v["verdict"] for v in vs] != ["warn"]:
        problems.append(f"borderline drop should warn, got: {vs}")

    # 5. headline rounds with different (or missing) headline_config are
    #    not comparable — the r01→r02 honest-baseline switch
    rows = [mk("a", 400.0, headline=4800.0, hc=None),
            mk("b", 390.0, headline=380.0)]
    vs = [v for v in verdicts(rows) if v["config"] == "headline"]
    if [v["verdict"] for v in vs] != ["not_comparable"]:
        problems.append(f"headline switch should be not_comparable: {vs}")

    # 6. missing jax_source -> provenance lint problem, never a crash
    row = trajectory_row({"value": 100.0, "tcpsvc_tps": 100.0}, label="x")
    lint = lint_provenance([row])
    if not any("jax_source" in p for p in lint):
        problems.append(f"missing jax_source not linted: {lint}")

    # 7. round-trip: append_trajectory writes a row load_rows folds back
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "BENCH_trajectory.jsonl")
        append_trajectory({"value": 380.0, "headline_config": "tcpsvc",
                           "tcpsvc_tps": 380.0, "jax_source": "live-relay",
                           "host_cores": 8}, path, label="run1")
        rows = load_rows(td, trajectory=path)
        if (len(rows) != 1 or rows[0]["label"] != "run1"
                or rows[0]["configs"]["tcpsvc"]["value"] != 380.0):
            problems.append(f"trajectory round-trip failed: {rows}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=".",
                    help="directory holding BENCH_r*.json")
    ap.add_argument("--trajectory", default=None,
                    help="trajectory ledger path "
                         "(default <dir>/BENCH_trajectory.jsonl)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on provenance lint problems")
    ap.add_argument("--check", action="store_true",
                    help="run the verdict-rule self-test and exit")
    args = ap.parse_args(argv)
    if args.check:
        problems = self_check()
        print(json.dumps({"check": "perf_sentinel",
                          "problems": problems}))
        return 0 if not problems else 1
    rep = report(args.dir, args.trajectory)
    if args.json:
        print(json.dumps(rep))
    else:
        print(format_report(rep))
    if rep["regressions"]:
        return 2
    if args.strict and rep["lint"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
