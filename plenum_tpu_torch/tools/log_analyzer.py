"""Node log analyzer: error clustering + per-view timelines for postmortems.

Reference behavior: scripts/process_logs:1 and scripts/log_stats — the
operators' postmortem loop over node logs (cluster repeated errors, lay
protocol events on a per-view timeline). The redesign here reads TWO
durable sources a node writes next to its keys:

  <base>/<node>/events.jsonl   structured protocol events (the node's
                               spylog made durable by tools/start_node:
                               view changes, catchups, suspicions,
                               VC stall phase decompositions, ...)
  <base>/<node>/node.log       python logging text (WARNING+ from the
                               transport and services)

Structured events beat regex-mining free text for timelines — the text
log is only mined for the error-clustering half, where it is the source
of truth (unexpected exceptions land there).

CLI:  python -m plenum_tpu_torch.tools.log_analyzer --base-dir DIR [--node N]
          [--json] [--last-s SECONDS]
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

# digits, hex runs, and quoted strings collapse so one template matches
# every instance of a repeated error
_NORM_PATTERNS = [
    (re.compile(r"0x[0-9a-fA-F]+"), "0x#"),
    (re.compile(r"\b[0-9a-fA-F]{8,}\b"), "#hex#"),
    (re.compile(r"\d+"), "#"),
    (re.compile(r"'[^']*'"), "'...'"),
    (re.compile(r'"[^"]*"'), '"..."'),
]

_LOG_LINE = re.compile(
    r"^(?P<ts>[\d\-T:., ]+)?(?P<level>DEBUG|INFO|WARNING|ERROR|CRITICAL)"
    r"[: ](?P<rest>.*)$")


def normalize_message(msg: str) -> str:
    for pat, repl in _NORM_PATTERNS:
        msg = pat.sub(repl, msg)
    return msg.strip()


def cluster_log_text(path: str) -> list[dict]:
    """-> clusters of WARNING+ lines (and traceback heads), most frequent
    first: {level, template, count, first_line, example}."""
    if not os.path.exists(path):
        return []
    clusters: dict[tuple, dict] = {}
    with open(path, errors="replace") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            m = _LOG_LINE.match(line)
            if m and m.group("level") in ("WARNING", "ERROR", "CRITICAL"):
                level, rest = m.group("level"), m.group("rest")
            elif line.startswith("Traceback (most recent call last)"):
                level, rest = "TRACEBACK", line
            else:
                continue
            key = (level, normalize_message(rest))
            c = clusters.get(key)
            if c is None:
                clusters[key] = {"level": level, "template": key[1],
                                 "count": 1, "first_line": lineno,
                                 "example": line[:240]}
            else:
                c["count"] += 1
    return sorted(clusters.values(), key=lambda c: -c["count"])


def read_events(path: str, last_s: Optional[float] = None) -> list[dict]:
    """events.jsonl rows {"t": wall_ts, "event": str, "data": ...};
    tolerant of torn tails (a crashing node tears its last line)."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path, errors="replace") as fh:
        for line in fh:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue   # torn line (crash mid-write): skip it alone —
                #            a restart appends more rows AFTER the tear,
                #            and a postmortem needs exactly those
    if last_s is not None and rows:
        cutoff = rows[-1].get("t", 0) - last_s
        rows = [r for r in rows if r.get("t", 0) >= cutoff]
    return rows


def read_flight_anomalies(node_dir: str,
                          last_s: Optional[float] = None) -> list[dict]:
    """Flight-recorder dumps (<node_dir>/*flight*.json, common/tracing)
    -> anomaly rows in events.jsonl shape, named `flight.<kind>` so the
    timeline distinguishes recorder-sourced rows from spylog ones.

    Times are mapped onto the wall clock when the dump carries a wall
    anchor (TCP pools); shared-clock sim dumps keep their timer times.
    Dumps overlap across a numbered series — rows are deduplicated by
    (t, kind) so a dump-per-anomaly cascade doesn't multiply counts."""
    rows: list[dict] = []
    seen: set = set()
    for path in sorted(glob.glob(os.path.join(node_dir, "*flight*.json"))):
        try:
            with open(path, errors="replace") as fh:
                dump = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        off = 0.0
        if dump.get("clock_domain") == "wall" \
                and dump.get("wall_anchor") is not None:
            off = dump["wall_anchor"] - dump["mono_anchor"]
        for ev in dump.get("events", ()):
            try:
                t, stage, _key, data = ev
            except (TypeError, ValueError):
                continue
            if not isinstance(stage, str) \
                    or not stage.startswith("anomaly."):
                continue
            kind = stage[len("anomaly."):]
            # payload is part of the identity: the frozen per-cycle clock
            # stamps two same-kind anomalies from one prod cycle with one
            # timestamp, and only the payload tells them apart — dedup
            # exists solely for the overlap across a numbered dump series
            dedup_key = (t, kind,
                         json.dumps(data, sort_keys=True, default=repr))
            if dedup_key in seen:
                continue
            seen.add(dedup_key)
            rows.append({"t": t + off, "event": f"flight.{kind}",
                         "data": data})
    rows.sort(key=lambda r: r["t"])
    if last_s is not None and rows:
        cutoff = rows[-1]["t"] - last_s
        rows = [r for r in rows if r["t"] >= cutoff]
    return rows


def view_timeline(events: list[dict]) -> list[dict]:
    """Partition events into per-view segments. A view segment opens at
    the preceding view's `view_change_complete` (view 0 opens at the
    first event) and records what happened inside it."""
    views: list[dict] = []
    cur = {"view_no": 0, "from_t": events[0]["t"] if events else None,
           "events": {}, "vc_stall": None}

    def _close(at_t):
        cur["to_t"] = at_t
        views.append(dict(cur))

    for r in events:
        ev, data = r.get("event"), r.get("data")
        if ev == "view_change_complete":
            _close(r["t"])
            cur = {"view_no": data, "from_t": r["t"], "events": {},
                   "vc_stall": None}
            continue
        cur["events"][ev] = cur["events"].get(ev, 0) + 1
        if ev == "vc_stall_phases" and isinstance(data, dict):
            # emitted just BEFORE view_change_complete, so the stall
            # record lands in the view segment the VC ended — i.e. a
            # view's vc_stall describes how that view DIED
            t0 = min(data.values())
            cur["vc_stall"] = {
                "total_s": round(max(data.values()) - t0, 3),
                "phases": {k: round(v - t0, 3)
                           for k, v in sorted(data.items(),
                                              key=lambda kv: kv[1])}}
    _close(events[-1]["t"] if events else None)
    return views


def analyze_node(node_dir: str, last_s: Optional[float] = None) -> dict:
    events = read_events(os.path.join(node_dir, "events.jsonl"), last_s)
    # flight-recorder anomalies (breaker transitions, tracer-side VC /
    # catchup / suspicion stamps) merge into the SAME per-view timeline:
    # a view segment then shows the device-plane story next to the
    # protocol one, which is exactly what a breaker-open-during-VC
    # postmortem needs in one place
    flight = read_flight_anomalies(node_dir, last_s)
    if flight:
        events = sorted(events + flight, key=lambda r: r.get("t", 0))
    counts: dict[str, int] = {}
    for r in events:
        counts[r.get("event", "?")] = counts.get(r.get("event", "?"), 0) + 1
    return {
        "node": os.path.basename(node_dir.rstrip("/")),
        "event_counts": counts,
        "flight_anomalies": len(flight),
        "views": view_timeline(events),
        "error_clusters": cluster_log_text(
            os.path.join(node_dir, "node.log")),
    }


def _print_report(rep: dict) -> None:
    print(f"== {rep['node']} ==")
    if rep["event_counts"]:
        print("  events:", ", ".join(f"{k}={v}" for k, v in
                                     sorted(rep["event_counts"].items())))
    for v in rep["views"]:
        span = ""
        if v.get("from_t") is not None and v.get("to_t") is not None:
            span = f" ({v['to_t'] - v['from_t']:.1f}s)"
        evs = ", ".join(f"{k}={n}" for k, n in sorted(v["events"].items()))
        print(f"  view {v['view_no']}{span}: {evs or '-'}")
        if v.get("vc_stall"):
            st = v["vc_stall"]
            print(f"    vc stall {st['total_s']}s: "
                  + " -> ".join(f"{k}@{t}s"
                                for k, t in st["phases"].items()))
    for c in rep["error_clusters"][:10]:
        print(f"  [{c['level']} x{c['count']}] {c['template'][:150]}")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--node", help="one node (default: every node dir)")
    ap.add_argument("--last-s", type=float, default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.node:
        dirs = [os.path.join(args.base_dir, args.node)]
    else:
        dirs = sorted(d for d in glob.glob(os.path.join(args.base_dir, "*"))
                      if os.path.isdir(d)
                      and (os.path.exists(os.path.join(d, "events.jsonl"))
                           or os.path.exists(os.path.join(d, "node.log"))
                           or glob.glob(os.path.join(d, "*flight*.json"))))
    reports = [analyze_node(d, args.last_s) for d in dirs]
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        for rep in reports:
            _print_report(rep)


if __name__ == "__main__":
    main()
