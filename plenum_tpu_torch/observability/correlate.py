"""Cross-node anomaly correlation: pool-wide incident timelines.

Each node's flight recorder holds its OWN last-seconds story (span
events + anomalies on its own clock). A pool incident — a view-change
storm, a breaker trip cascading into catchup, an SLO burn — shows up as
anomalies scattered across several rings. This module stitches them
onto ONE aligned timeline (reusing trace_report's clock-anchor +
causality alignment) and clusters them into incidents: bursts of
anomalies separated by quiet gaps.

Input: tracer snapshots/dumps (`Tracer.snapshot()` dicts or the JSON
files `Tracer.dump` writes), plus optionally a FleetAggregator's
structured alerts — alerts already carry aligned stamps (the shared
aggregation clock), so they merge in directly. Two more aligned-clock
sources join the same timeline:

* **autopilot control-ledger records** (control/ledger 101, the dicts
  `ControlRecord.to_dict()` writes) — each actuation lands as a
  ``control.<action>`` event, so an incident reads as ONE causal
  sequence: alert → the evidence that sustained it → the actuation the
  control plane took;
* **history-ring context** (observability/history.py) — each incident
  gains the N fleet rows immediately BEFORE its first event, so a
  post-mortem sees what the pool looked like walking into the incident
  (TPS trend, health, footprint) without a separate query.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common import tracing


def _aligned_anomalies(dumps: list[dict]) -> list[tuple[float, str, str, dict]]:
    """-> [(aligned_t, node, kind, data)] from every dump's ring."""
    from plenum_tpu_torch.tools.trace_report import align_offsets
    offsets = align_offsets(dumps)
    out = []
    for d in dumps:
        off = offsets[d["node"]]
        for t, stage, _key, data in d["events"]:
            if stage.startswith(tracing.ANOMALY_PREFIX):
                out.append((t + off, d["node"],
                            stage[len(tracing.ANOMALY_PREFIX):], data))
    return out


def incident_timelines(dumps: list[dict],
                       alerts: Optional[list] = None,
                       gap_s: float = 2.0,
                       control: Optional[list] = None,
                       history=None, history_n: int = 3) -> list[dict]:
    """Cluster all nodes' anomalies (+ aggregator alerts + autopilot
    control records) into incidents.

    Two consecutive events more than `gap_s` apart split incidents — the
    gap is a quiet-period heuristic, not a protocol fact, so it is a
    parameter. `control` is a list of control-ledger record dicts (or
    objects with to_dict); each joins the timeline as a
    ``control.<action>`` event on the "autopilot" pseudo-node, so the
    cluster shows alert → evidence → actuation as one sequence.
    `history` is a HistoryRecorder: each incident gains a ``history``
    key with the `history_n` fleet rows preceding its start.
    -> [{start, end, duration_s, nodes, kinds, events, history?}],
    sorted by start; `events` keeps per-event (t, node, kind, data).
    """
    rows = _aligned_anomalies(dumps)
    for a in alerts or []:
        d = a.to_dict() if hasattr(a, "to_dict") else dict(a)
        rows.append((float(d.get("t", 0.0)), "fleet",
                     f"alert.{d.get('kind', '?')}", d))
    for rec in control or []:
        d = rec.to_dict() if hasattr(rec, "to_dict") else dict(rec)
        rows.append((float(d.get("t", 0.0)), "autopilot",
                     f"control.{d.get('action', '?')}", d))
    rows.sort(key=lambda r: r[0])
    incidents: list[dict] = []
    cur: Optional[dict] = None
    for t, node, kind, data in rows:
        if cur is None or t - cur["end"] > gap_s:
            cur = {"start": t, "end": t, "nodes": set(), "kinds": {},
                   "events": []}
            incidents.append(cur)
        cur["end"] = max(cur["end"], t)
        cur["nodes"].add(node)
        cur["kinds"][kind] = cur["kinds"].get(kind, 0) + 1
        cur["events"].append((t, node, kind, data))
    for inc in incidents:
        inc["nodes"] = sorted(inc["nodes"])
        inc["duration_s"] = round(inc["end"] - inc["start"], 6)
        if history is not None:
            before = [r for r in history.window(None, inc["start"])
                      if float(r.get("t", 0.0)) < inc["start"]]
            if before:
                inc["history"] = before[-history_n:]
    return incidents


def format_incidents(incidents: list[dict], last_n: int = 5) -> list[str]:
    """Console lines for the tail of the incident list."""
    lines = []
    for inc in incidents[-last_n:]:
        kinds = ", ".join(f"{k}x{v}" for k, v in
                          sorted(inc["kinds"].items()))
        lines.append(
            f"[{inc['start']:.3f} +{inc['duration_s']:.3f}s] "
            f"{len(inc['events'])} anomalies on "
            f"{'/'.join(inc['nodes'])}: {kinds}")
        hist = inc.get("history")
        if hist:
            cells = []
            for row in hist:
                cell = f"t={row.get('t', 0):.1f} tps={row.get('tps', 0)}"
                if row.get("health_min") is not None:
                    cell += f" hmin={row['health_min']}"
                cells.append(cell)
            lines.append("  walked in from: " + " | ".join(cells))
    return lines
