"""Live fleet console: the telemetry plane's operator surface.

Reads node telemetry spools (the rotating ``<node>-telemetry-N.json``
windows ``observability/snapshot.py`` writes next to each node's data,
atomic so a live tail never sees a torn file) plus any flight-recorder
dumps, feeds a :class:`FleetAggregator`, and renders the pool-wide view:
per-node/per-shard health, ordered rates, the shard load-imbalance
index, SLO burn rates, active alerts, and cross-node incident timelines.

    python -m plenum_tpu_torch.tools.fleet_console BASE_DIR...
        [--json] [--watch SECONDS] [--last-n 5]
    python -m plenum_tpu_torch.tools.fleet_console --check   # tier-1 self-test

``--watch`` re-reads and re-renders every N seconds — the "live text
dashboard"; a one-shot run renders the spool's current window once.
``--check`` drives the aggregator through synthetic healthy / overload /
crypto-fault / hot-shard streams and asserts the judgments the tier-1
smoke rides on (zero idle alerts, the ingress burn alert, health
degrade + recovery, the imbalance flag, incident clustering).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Optional


def load_spools(paths) -> list[dict]:
    """Spool files / directories -> snapshots sorted by (t, node, seq).
    Directories are searched recursively for *-telemetry-*.json."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(glob.glob(
                os.path.join(p, "**", "*-telemetry-*.json"),
                recursive=True))
        elif p.endswith(".json"):
            files.append(p)
    snaps = []
    for f in sorted(files):
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue                 # a rotating slot mid-replace: skip
        if isinstance(d, dict) and "counters" in d and "node" in d:
            snaps.append(d)
    snaps.sort(key=lambda s: (s.get("t", 0.0), s.get("node", ""),
                              s.get("seq", 0)))
    return snaps


def load_flight_dumps(paths) -> list[dict]:
    from plenum_tpu_torch.tools.trace_report import load_dumps
    return load_dumps([p for p in paths if os.path.isdir(p)])


def build_view(paths, config=None):
    """-> (aggregator, incidents) from on-disk artifacts. The console's
    aggregator carries its own IN-MEMORY history ring (rebuilt from the
    spool window each refresh — writing slots from a reader would fight
    the pool's own on-disk ring), so TREND renders without extra I/O."""
    from plenum_tpu_torch.observability import (FleetAggregator, HistoryRecorder,
                                          incident_timelines)
    agg = FleetAggregator(config=config)
    agg.attach_history(HistoryRecorder(
        max_slots=getattr(config, "HISTORY_MAX_SLOTS", 512)))
    for snap in load_spools(paths):
        agg.ingest(snap)
    dumps = load_flight_dumps(paths)
    incidents = incident_timelines(
        dumps, alerts=agg.alerts, history=agg.history) \
        if (dumps or agg.alerts) else []
    return agg, incidents


def render(agg, incidents, last_n: int = 5) -> str:
    from plenum_tpu_torch.observability.correlate import format_incidents
    s = agg.fleet_summary()
    lines = [f"fleet @ t={s['t']:.2f}  snapshots={s['snapshots']}  "
             f"nodes={len(s['nodes'])}"]
    epochs = s.get("mapping_epochs", {})
    migrations = s.get("migrations", {})
    hdr = (f"  {'node':12} {'shard':>5} {'health':>7} {'seq':>6} "
           f"{'anchor_age':>10} {'epoch':>6} {'migration':>16}")
    lines.append(hdr)
    lines.append("  " + "-" * (len(hdr) - 2))
    for name, row in s["nodes"].items():
        h = row["health"]
        age = row["anchor_age"]
        shard = row["shard"]
        epoch = epochs.get(str(shard)) if shard is not None else None
        mig = migrations.get(str(shard)) if shard is not None else None
        mig_cell = "-"
        if mig:
            mig_cell = (f"{mig.get('role', '?')[:3]}:"
                        f"{mig.get('phase', '?')}"
                        f"@{mig.get('progress', 0.0):.0%}")
        lines.append(
            f"  {name:12} {str(shard if shard is not None else '-'):>5} "
            f"{'-' if h is None else format(h, '.2f'):>7} "
            f"{str(row['seq'] if row['seq'] is not None else '-'):>6} "
            f"{'-' if age is None else format(age, '.1f'):>10} "
            f"{str(epoch if epoch is not None else '-'):>6} "
            f"{mig_cell:>16}")
    if s["shard_health"]:
        lines.append(f"  shard health: {s['shard_health']}  "
                     f"ordered/s: {s['ordered_rates']}")
    if migrations:
        lines.append("  migrations: " + ", ".join(
            f"shard {sid}: {m.get('role')} {m.get('phase')} "
            f"{m.get('progress', 0.0):.0%}"
            for sid, m in sorted(migrations.items())))
    if s["load_imbalance"] is not None:
        hot = s["hot_shard"]
        lines.append(f"  load imbalance index: {s['load_imbalance']}"
                     + (f"  HOT SHARD: {hot}" if hot is not None else ""))
    if s.get("staleness"):
        worst = max(s["staleness"].items(), key=lambda kv: kv[1])
        lines.append(f"  anchor staleness (worst): {worst[0]}="
                     f"{worst[1]:.1f}s")
    # multi-device crypto ring: name the sick chip(s) — a lane whose
    # breaker is not closed is serving its pinned traffic on host
    # fallback while the rest of the ring keeps dispatching
    sick_lanes = []
    for name, snap in sorted(getattr(agg, "latest", {}).items()):
        pipe_state = snap.get("state", {}).get("pipeline", {})
        for dev in pipe_state.get("devices", []) or []:
            if dev.get("breaker") not in ("closed", "none"):
                sick_lanes.append(
                    f"{name}:lane{dev.get('lane')}={dev.get('breaker')}")
    if sick_lanes:
        lines.append("  SICK CHIPS: " + ", ".join(sick_lanes))
    # cross-host federation: rented remote crypto-host lanes — roster
    # size, steal traffic, ship latency, and any remote whose breaker is
    # open (that host's capacity is dark; its queue stole back local)
    remote_lines = []
    for name, snap in sorted(getattr(agg, "latest", {}).items()):
        pipe_state = snap.get("state", {}).get("pipeline", {})
        fed = pipe_state.get("federation") or {}
        remotes = [d for d in pipe_state.get("devices", []) or []
                   if d.get("remote")]
        if not fed and not remotes:
            continue
        dark = [f"{d.get('host', 'lane%s' % d.get('lane'))}="
                f"{d.get('breaker')}" for d in remotes
                if d.get("breaker") not in ("closed", "none")]
        remote_lines.append(
            f"{name}: {fed.get('remote_lanes', len(remotes))} remote, "
            f"steals={fed.get('steals', 0)}"
            f"/{fed.get('stolen_items', 0)} items, "
            f"ship_p95={fed.get('ship_ms_p95', '-')}ms"
            + (f", DARK: {', '.join(dark)}" if dark else ""))
    if remote_lines:
        lines.append("  REMOTE LANES: " + "; ".join(remote_lines))
    # autopilot control plane: what the closed loop has decided — level,
    # action/revert/hold counts, and any live lane re-pins, so an
    # operator can tell actuation from drift at a glance
    ap = getattr(agg, "autopilot", None)
    if ap:
        lines.append(
            f"  AUTOPILOT: level={ap.get('state', '?')} "
            f"decisions={ap.get('decisions', 0)} "
            f"actions={ap.get('actions', 0)} "
            f"reverts={ap.get('reverts', 0)} holds={ap.get('holds', 0)}"
            + (f" repins={ap.get('repins')}" if ap.get("repins") else ""))
    # Proof-CDN edge tier (reads/edge.py): per-region keyless-cache
    # absorption — how much read traffic never reaches the pool, and
    # at what hit rate (the autopilot's observer policy reads the same
    # number before spawning)
    ed = getattr(agg, "edge", None)
    if ed:
        cells = []
        for region, row in sorted(ed.get("regions", {}).items()):
            rate = row.get("hit_rate")
            cells.append(
                f"{region} edges={row.get('edges', 0)} "
                f"served={row.get('served', 0)} "
                f"hit={'-' if rate is None else format(rate, '.0%')}")
        lines.append(f"  EDGE: " + ", ".join(cells)
                     + f"  bytes={ed.get('bytes', 0)}")
    # fleet history plane: the TREND sparklines come from the attached
    # history ring's downsampled window; FOOTPRINT is the current
    # resource-gauge inventory with growing gauges marked — the same
    # verdicts behind the unbounded_growth alert
    hist = getattr(agg, "history", None)
    if hist is not None and getattr(hist, "rows", None):
        from plenum_tpu_torch.tools.perf_sentinel import sparkline
        rows = hist.query(max_points=24)
        tps = [float(r.get("tps", 0.0)) for r in rows]
        hmin = [float(r["health_min"]) for r in rows
                if r.get("health_min") is not None]
        lines.append(
            f"  TREND: tps {sparkline(tps)} {tps[-1]:.1f}"
            + (f"  health_min {sparkline(hmin)} {hmin[-1]:.2f}"
               if hmin else "")
            + f"  rows={len(hist.rows)}/{hist.seq}")
    fp = s.get("footprint")
    if fp:
        from plenum_tpu_torch.observability import GROWTH_EXEMPT_GAUGES
        growth = s.get("growth", {})
        cells = []
        for gauge in sorted(fp):
            mark = "↑!" if (gauge not in GROWTH_EXEMPT_GAUGES
                            and growth.get(gauge, {}).get("verdict")
                            == "growing") else ""
            cells.append(f"{gauge}={int(fp[gauge])}{mark}")
        lines.append("  FOOTPRINT: " + " ".join(cells))
        growing = sorted(g for g, v in growth.items()
                         if v.get("verdict") == "growing"
                         and g not in GROWTH_EXEMPT_GAUGES)
        if growing:
            lines.append("  UNBOUNDED GROWTH: " + ", ".join(
                f"{g} +{growth[g].get('slope_per_s', 0)}/s "
                f"(projected {growth[g].get('projected')} > "
                f"{growth[g].get('threshold')})" for g in growing))
    for kind, per_node in s["burn"].items():
        burning = {n: b for n, b in per_node.items()
                   if b["fast"] > 0 or b["slow"] > 0}
        if burning:
            lines.append(f"  burn[{kind}]: " + ", ".join(
                f"{n} fast={b['fast']} slow={b['slow']}"
                for n, b in sorted(burning.items())))
    active = s["active_alerts"]
    lines.append(f"  alerts: {len(active)} active / "
                 f"{len(s['alerts'])} recent")
    for a in active[-last_n:]:
        lines.append(f"    [{a['severity']}] {a['kind']} "
                     f"{a['subject']}: {json.dumps(a['detail'])}")
    if incidents:
        lines.append("  incidents:")
        for line in format_incidents(incidents, last_n):
            lines.append(f"    {line}")
    return "\n".join(lines)


# --- the --check self-test ---------------------------------------------------

def _snap(node, seq, t, state, tags=None):
    return {"v": 1, "node": node, "seq": seq, "t": t,
            **({"tags": tags} if tags else {}),
            "counters": {}, "sampled": {}, "state": state}


def self_check() -> int:
    """Synthetic streams through the real aggregator; asserts the
    judgments the acceptance criteria name. -> process exit code."""
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.observability import FleetAggregator, incident_timelines

    problems = []
    config = Config(SLO_BURN_FAST_WINDOW=5.0, SLO_BURN_SLOW_WINDOW=20.0)
    nodes = ["N1", "N2", "N3", "N4"]

    def healthy(node, seq, t, ordered=0, shard=None, slo=None):
        state = {"node": {"ordered_total": ordered, "view_no": 0,
                          "vc_in_progress": False, "catchup_running": False,
                          "read_only_degraded": False, "validators": 4,
                          "anchor_age": 1.0}}
        if slo is not None:
            state["ingress"] = {"queue_depth": 0, "shedding": False,
                                "slo": slo}
        return _snap(node, seq, t, state,
                     tags={"shard": shard} if shard is not None else None)

    # 1) idle healthy pool: ZERO alerts, health 1.0 everywhere
    agg = FleetAggregator(config=config)
    for i in range(30):
        for n in nodes:
            agg.ingest(healthy(n, i, i * 1.0, ordered=i,
                               slo=[0, 5]))
    if agg.alerts:
        problems.append(f"idle pool raised alerts: "
                        f"{[a.to_dict() for a in agg.alerts]}")
    if any(agg.node_health(n) != 1.0 for n in nodes):
        problems.append(f"idle pool unhealthy: "
                        f"{ {n: agg.node_health(n) for n in nodes} }")

    # 2) sustained ingress overload: the burn-rate alert fires on both
    # windows, then CLEARS after recovery
    agg2 = FleetAggregator(config=config)
    t = 0.0
    for i in range(25):
        t = i * 1.0
        agg2.ingest(healthy("N1", i, t, slo=[4, 5] if i >= 5 else [0, 5]))
    fired = [a for a in agg2.alerts if a.kind == "slo_burn.ingress"
             and a.severity == "page"]
    if not fired:
        problems.append("sustained overload never fired the ingress "
                        "burn alert")
    for i in range(25, 60):
        t = i * 1.0
        agg2.ingest(healthy("N1", i, t, slo=[0, 5]))
    cleared = [a for a in agg2.alerts if a.kind == "slo_burn.ingress"
               and a.severity == "clear"]
    if fired and not cleared:
        problems.append("ingress burn alert never cleared after recovery")

    # 3) crypto-plane fault: breaker open + front door shedding degrade
    # the health score below the floor (warn alert), then recovery clears
    agg3 = FleetAggregator(config=config)
    sick = healthy("N1", 0, 0.0)
    sick["state"]["crypto"] = {"breaker_state": "open"}
    sick["state"]["ingress"] = {"shedding": True}
    agg3.ingest(sick)
    h_sick = agg3.node_health("N1")
    if h_sick is None or h_sick >= 0.5:
        problems.append(f"breaker-open health {h_sick} not degraded")
    if not any(a.kind == "health.node" for a in agg3.alerts):
        problems.append("degraded health raised no alert")
    agg3.ingest(healthy("N1", 1, 1.0))
    if agg3.node_health("N1") != 1.0:
        problems.append("health did not recover after the fault healed")
    if not any(a.severity == "clear" and a.kind == "health.node"
               for a in agg3.alerts):
        problems.append("health alert never cleared")

    # 3b) multi-device ring: ONE sick chip lane degrades the node
    # lightly (lane penalty, not the full plane-breaker one) and the
    # console names the chip — the operator must see WHICH lane is sick
    agg3b = FleetAggregator(config=config)
    laney = healthy("N1", 0, 0.0)
    laney["state"]["pipeline"] = {
        "occupancy": 0, "dispatches": 10, "breakers_open": 1,
        "devices": [
            {"lane": 0, "breaker": "closed", "occupancy": 0,
             "dispatches": 5},
            {"lane": 2, "breaker": "open", "occupancy": 3,
             "dispatches": 5}]}
    agg3b.ingest(laney)
    h_lane = agg3b.node_health("N1")
    if h_lane is None or not (0.5 < h_lane < 1.0):
        problems.append(f"one sick lane health {h_lane}: expected a "
                        f"light ding, not full-plane or healthy")
    text = render(agg3b, [])
    if "SICK CHIPS" not in text or "N1:lane2=open" not in text:
        problems.append("console did not name the sick chip lane")
    agg3b.ingest(healthy("N1", 1, 1.0))
    if agg3b.node_health("N1") != 1.0:
        problems.append("lane health did not recover after re-admission")

    # 3c) cross-host federation: the console shows the rented remote
    # lanes (roster, steal traffic, ship latency) and names a remote
    # host whose breaker is open — dark rented capacity must be visible
    agg3c = FleetAggregator(config=config)
    feddy = healthy("N1", 0, 0.0)
    feddy["state"]["pipeline"] = {
        "occupancy": 0, "dispatches": 20, "breakers_open": 1,
        "devices": [
            {"lane": 0, "breaker": "closed", "occupancy": 0,
             "dispatches": 12},
            {"lane": 1, "breaker": "open", "occupancy": 0,
             "dispatches": 8, "remote": True, "host": "/run/ch0.sock",
             "steals_in": 2, "steals_out": 1}],
        "federation": {"remote_lanes": 1, "steals": 3,
                       "stolen_items": 96, "remote_breakers_open": 1,
                       "ship_ms_p95": 4.2}}
    agg3c.ingest(feddy)
    text = render(agg3c, [])
    if "REMOTE LANES" not in text:
        problems.append("console did not show the federated remote lanes")
    elif "/run/ch0.sock=open" not in text or "steals=3" not in text:
        problems.append("console did not name the dark remote host "
                        "or its steal traffic")

    # 3d) autopilot seam: when the control plane published a summary,
    # the console renders the AUTOPILOT line (level + counts + repins)
    agg3d = FleetAggregator(config=config)
    agg3d.ingest(healthy("N1", 0, 0.0))
    agg3d.autopilot = {"level": 1, "state": "shed_harder",
                       "decisions": 12, "actions": 3, "reverts": 1,
                       "holds": 2, "repins": {0: {"prev": 0, "sick": 2}}}
    text = render(agg3d, [])
    if "AUTOPILOT: level=shed_harder" not in text \
            or "actions=3" not in text or "repins=" not in text:
        problems.append("console did not render the autopilot line")

    # 3e) edge tier seam: windows fed through note_edge render the EDGE
    # line (per-region fleet size + served volume + windowed hit rate),
    # and the windowed fold exposes the hit rate the autopilot reads
    agg3e = FleetAggregator(config=config)
    agg3e.ingest(healthy("N1", 0, 0.0))
    agg3e.note_edge("r0", hits=90, served=100, edges=2,
                    bytes_served=4096, now=1.0)
    agg3e.note_edge("r0", hits=98, served=100, edges=2,
                    bytes_served=4096, now=2.0)
    rate = agg3e.edge_hit_rate("r0")
    if rate is None or abs(rate - 0.94) > 1e-9:
        problems.append(f"edge hit-rate fold wrong: {rate}")
    text = render(agg3e, [])
    if "EDGE:" not in text or "r0 edges=2" not in text \
            or "hit=94%" not in text:
        problems.append("console did not render the edge line")

    # 4) hot shard: skewed ordered rates flag shard 0
    agg4 = FleetAggregator(config=config)
    for i in range(30):
        t = i * 1.0
        agg4.ingest(healthy("S0N1", i, t, ordered=i * 50, shard=0))
        agg4.ingest(healthy("S1N1", i, t, ordered=i * 2, shard=1))
    index, hot = agg4.load_imbalance()
    if hot != 0 or index is None or index < config.SHARD_IMBALANCE_THRESHOLD:
        problems.append(f"hot shard not flagged: index={index} hot={hot}")
    if not any(a.kind == "shard.imbalance" for a in agg4.alerts):
        problems.append("imbalance raised no alert")

    # 4b) reshard convergence: the per-shard mapping-epoch + migration-
    # progress columns an operator watches a live split through — the
    # laggard's epoch is what shows, and the migration column clears
    # when the handoff completes
    agg4b = FleetAggregator(config=config)

    def resharding(node, seq, t, shard, epoch, mig=None):
        snap = healthy(node, seq, t, ordered=seq, shard=shard)
        snap["state"]["shard_map"] = {"epoch": epoch,
                                      **({"migration": mig} if mig else {})}
        return snap

    agg4b.ingest(resharding("S0N2", 0, 0.0, 0, 0))    # laggard: epoch 0
    agg4b.ingest(resharding("S0N1", 0, 0.5, 0, 1,
                            mig={"role": "source", "phase": "copying",
                                 "progress": 0.4}))
    agg4b.ingest(resharding("S2N1", 0, 0.5, 2, 1,
                            mig={"role": "target", "phase": "copying",
                                 "progress": 0.4}))
    if agg4b.mapping_epochs() != {0: 0, 2: 1}:
        problems.append(f"mapping epochs wrong (laggard must show): "
                        f"{agg4b.mapping_epochs()}")
    migs = agg4b.migrations()
    if set(migs) != {0, 2} or migs[0].get("role") != "source" \
            or migs[2].get("role") != "target":
        problems.append(f"migration columns wrong: {migs}")
    txt = render(agg4b, [])
    if "sou:copying@40%" not in txt or "migrations:" not in txt:
        problems.append("console does not render migration progress")
    # the handoff completes: migration column clears, epochs converge
    agg4b.ingest(resharding("S0N1", 1, 1.0, 0, 1))
    agg4b.ingest(resharding("S0N2", 1, 1.0, 0, 1))
    agg4b.ingest(resharding("S2N1", 1, 1.0, 2, 1))
    if agg4b.migrations() or agg4b.mapping_epochs() != {0: 1, 2: 1}:
        problems.append(
            f"post-reshard view did not converge: "
            f"{agg4b.migrations()} {agg4b.mapping_epochs()}")
    # a decommissioned (merged-away) node is FORGOTTEN, not paged
    agg4b.forget_node("S2N1")
    if "S2N1" in agg4b.fleet_summary()["nodes"]:
        problems.append("forget_node left the retired node enrolled")

    # 5) incident clustering: anomalies on two nodes within the gap fold
    # into ONE incident; a distant one stands alone
    dumps = [
        {"node": "A", "clock_domain": "shared", "mono_anchor": 0.0,
         "wall_anchor": None, "dumped_at": 50.0, "anomalies": 2,
         "events": [[10.0, "anomaly.suspicion", "", {"code": 1}],
                    [10.5, "anomaly.view_change_start", "", {}]]},
        {"node": "B", "clock_domain": "shared", "mono_anchor": 0.0,
         "wall_anchor": None, "dumped_at": 50.0, "anomalies": 2,
         "events": [[11.0, "anomaly.view_change_start", "", {}],
                    [40.0, "anomaly.breaker", "", {"to": "open"}]]},
    ]
    incidents = incident_timelines(dumps, gap_s=2.0)
    if len(incidents) != 2 or incidents[0]["nodes"] != ["A", "B"] \
            or len(incidents[0]["events"]) != 3:
        problems.append(f"incident clustering wrong: {incidents}")

    # 6) the renderer survives every view above (smoke, not goldens)
    try:
        for a in (agg, agg2, agg3, agg3e, agg4, agg4b):
            render(a, incidents)
    except Exception as e:
        problems.append(f"render failed: {type(e).__name__}: {e}")

    # 7) fleet history plane: bounded footprint gauges stay quiet, an
    # injected leak raises EXACTLY ONE unbounded_growth page naming the
    # gauge, ledger-backed gauges never page, the history ring honors
    # its slot bound, query() downsamples, and the console renders the
    # TREND/FOOTPRINT rungs off the same ring
    from plenum_tpu_torch.observability import HistoryRecorder
    agg7 = FleetAggregator(config=config)
    agg7.attach_history(HistoryRecorder(max_slots=16))
    for i in range(60):
        snap = healthy("N1", i, i * 1.0, ordered=i * 3)
        snap["state"]["footprint"] = {
            # breathing inside its working set: bounded
            "stashed_entries": 120 + (i % 5) * 8,
            # the injected leak: grows without bound
            "leaky_stash": 80 + 10 * i,
            # ledger-backed: grows by design, exempt from paging
            "kv_entries": 1000 * (i + 1),
        }
        agg7.ingest(snap)
    pages = [a for a in agg7.alerts if a.kind == "unbounded_growth"
             and a.severity == "page"]
    if len(pages) != 1 or pages[0].subject != "leaky_stash" \
            or pages[0].detail.get("gauge") != "leaky_stash":
        problems.append(
            f"leak should page exactly once naming leaky_stash: "
            f"{[a.to_dict() for a in pages]}")
    if any(a.subject in ("stashed_entries", "kv_entries")
           for a in agg7.alerts if a.kind == "unbounded_growth"):
        problems.append("bounded/exempt gauge paged unbounded_growth")
    if len(agg7.history.rows) > 16 or agg7.history.seq != 60:
        problems.append(
            f"history ring unbounded: rows={len(agg7.history.rows)} "
            f"seq={agg7.history.seq}")
    down = agg7.history.query(max_points=5)
    full = agg7.history.window()
    if len(down) != 5 or down[0] != full[0] or down[-1] != full[-1]:
        problems.append(f"query downsample wrong: {len(down)} rows")
    text = render(agg7, [])
    if "TREND:" not in text or "FOOTPRINT:" not in text \
            or "leaky_stash" not in text:
        problems.append("console did not render TREND/FOOTPRINT rungs")

    print(json.dumps({"check": "ok" if not problems else "FAIL",
                      "problems": problems}))
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="dirs holding *-telemetry-*.json spools "
                         "(+ optional flight dumps)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--watch", type=float, default=None, metavar="SECONDS")
    ap.add_argument("--last-n", type=int, default=5)
    ap.add_argument("--config", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="Config override (repeatable), e.g. "
                         "--config SLO_BURN_THRESHOLD=1.2 — the console "
                         "must judge with the POOL's thresholds, not the "
                         "defaults, or dashboard and pool disagree")
    ap.add_argument("--check", action="store_true",
                    help="run the built-in self-test and exit")
    args = ap.parse_args(argv)
    if args.check:
        return self_check()
    if not args.paths:
        ap.error("paths required (or --check)")
    from plenum_tpu_torch.config import Config
    overrides = {}
    for item in args.config:
        name, _, raw = item.partition("=")
        if not _:
            ap.error(f"--config wants NAME=VALUE, got {item!r}")
        try:
            overrides[name] = json.loads(raw)
        except json.JSONDecodeError:
            overrides[name] = raw
    config = Config(**overrides)
    prev_mark = None
    while True:
        agg, incidents = build_view(args.paths, config=config)
        if not agg.latest:
            print(json.dumps(
                {"error": f"no telemetry spools under {args.paths}"}))
            return 1
        # staleness is judged on the FLEET clock (newest snapshot anyone
        # sent), which needs at least one live reporter — a whole-pool
        # outage freezes it, so the console itself watches for a spool
        # that stopped advancing between refreshes
        mark = (agg.snapshots, agg.now)
        spool_idle = args.watch is not None and prev_mark == mark
        prev_mark = mark
        if args.json:
            print(json.dumps({"fleet": agg.fleet_summary(),
                              "spool_idle": spool_idle,
                              "incidents": [
                                  {k: v for k, v in inc.items()
                                   if k != "events"}
                                  for inc in incidents[-args.last_n:]]},
                             default=repr))
        else:
            if args.watch:
                print("\033[2J\033[H", end="")    # clear for the live view
            print(render(agg, incidents, args.last_n))
            if spool_idle:
                print("  WARNING: no new telemetry since the last "
                      "refresh — the whole fleet may be down (health "
                      "scores above are last-known, not live)")
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
