"""FleetAggregator: snapshots in, pool/shard-wide signals out.

Composes per-node :mod:`snapshot` streams into the live fleet view:

* **health scores** per node and per shard in [0, 1] — a documented
  penalty fold over the snapshot's state section (breaker open, read-only
  degradation, catchup, view change, shedding, anchor staleness), NOT a
  learned figure: an operator must be able to read a 0.4 and say why;
* the **shard load-imbalance index** — max per-shard ordered rate over
  the mean, measured across the trailing window.  This is the exact
  input live shard split/merge (ROADMAP item 1) will consume, and past
  ``SHARD_IMBALANCE_THRESHOLD`` the hot shard is flagged;
* **per-node anchor staleness** — how far behind the BLS-anchored root
  each node's read plane serves from (the WAN-staleness signal);
* **multi-window SLO burn rates** against the already-configured
  ``INGRESS_SLO_P95`` / ``BATCH_SLO_P95`` budgets: burn = violating
  fraction / budget per window, and an alert fires only when BOTH the
  fast and slow windows burn past the threshold — fast for recency,
  slow so a blip cannot page (the classic multi-window burn-rate rule).

Alerts are edge-triggered with a latch: one structured alert when a
condition turns true, one ``*_clear`` when it recovers — an idle pool
raises ZERO alerts and a sustained overload raises ONE, not a storm.
Every alert also lands in an attached flight-recorder ring
(``tracer.anomaly``), so the incident timeline and the burn-rate story
meet in the same artifact.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.observability.history import (GROWTH_EXEMPT_GAUGES,
                                              GrowthWatch)


@dataclass
class Alert:
    t: float
    kind: str                       # e.g. "slo_burn.ingress", "health.node"
    subject: str                    # node name, shard id, or "" (pool)
    severity: str                   # "page" | "warn" | "clear"
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "subject": self.subject,
                "severity": self.severity, "detail": self.detail}


class BurnRateTracker:
    """Multi-window burn-rate over (violations, total) deltas.

    Each ``note(t, viol, n)`` records one snapshot interval's SLO ledger;
    ``burn(t, window)`` folds the intervals inside [t-window, t] into
    violating-fraction / budget. ``alerting(t)`` is the multi-window
    rule: both windows past the threshold, with a minimum sample count
    AND a minimum number of distinct intervals — one burst-heavy first
    interval can satisfy any check count, so the interval floor is what
    actually makes 'a blip cannot page' true."""

    MIN_SAMPLES = 8
    MIN_INTERVALS = 4

    def __init__(self, budget: float, threshold: float,
                 fast_window: float, slow_window: float):
        self.budget = max(1e-9, budget)
        self.threshold = threshold
        self.fast_window = fast_window
        self.slow_window = slow_window
        self._points: deque = deque(maxlen=4096)    # (t, viol, n)

    def note(self, t: float, violations: int, total: int) -> None:
        if total > 0:
            self._points.append((t, int(violations), int(total)))

    def _fold(self, t: float, window: float) -> tuple[int, int, int]:
        viol = n = pts = 0
        for (ts, v, c) in reversed(self._points):
            if ts < t - window:
                break
            viol += v
            n += c
            pts += 1
        return viol, n, pts

    def burn(self, t: float, window: float) -> float:
        viol, n, _pts = self._fold(t, window)
        if n == 0:
            return 0.0
        return (viol / n) / self.budget

    def alerting(self, t: float) -> bool:
        viol, n, pts = self._fold(t, self.slow_window)
        if n < self.MIN_SAMPLES or pts < self.MIN_INTERVALS:
            return False
        return (self.burn(t, self.fast_window) >= self.threshold
                and self.burn(t, self.slow_window) >= self.threshold)

    def summary(self, t: float) -> dict:
        return {"fast": round(self.burn(t, self.fast_window), 2),
                "slow": round(self.burn(t, self.slow_window), 2),
                "budget": self.budget}


# --- health score -----------------------------------------------------------
# The documented penalty table (docs/observability.md "Health score"):
# each (condition, penalty) subtracts from 1.0; the score clamps to
# [0, 1]. Ordered by how much of the node's service the condition costs.
HEALTH_PENALTIES = (
    ("read_only_degraded", 0.8),    # ordering parked; reads only
    ("breaker_open", 0.5),          # crypto plane on CPU fallback
    ("catchup_running", 0.3),       # resyncing, not ordering
    ("breaker_half_open", 0.2),     # probing its way back
    ("vc_in_progress", 0.2),        # ordering paused for the view change
    ("shedding", 0.2),              # front door refusing new work
    ("anchor_stale", 0.3),          # serving reads at a stale root
    ("lane_breaker_open", 0.2),     # one chip of the multi-device ring
    #                                 degraded (other lanes still serve,
    #                                 so lighter than the plane breaker)
)


def node_health(state: dict, anchor_stale: bool = False) -> float:
    """state = the snapshot's flattened condition dict -> score in [0,1]."""
    score = 1.0
    for key, penalty in HEALTH_PENALTIES:
        if key == "anchor_stale":
            if anchor_stale:
                score -= penalty
        elif state.get(key):
            score -= penalty
    return max(0.0, min(1.0, score))


class FleetAggregator:
    """Snapshots in (``ingest``), fleet view out (``fleet_summary``).

    `now` defaults to the latest ingested snapshot's stamp, so a replayed
    stream aggregates identically to the live run that produced it.
    `tracer`: alerts are mirrored into its ring as anomalies.
    `freshness_s`: anchor-staleness bound (defaults to the read plane's
    client-side freshness bound).
    """

    def __init__(self, config=None, tracer=None, metrics=None,
                 freshness_s: float = 900.0,
                 region_of: Optional[Callable[[str], str]] = None):
        self.config = config
        self.tracer = tracer
        self.metrics = metrics
        self.freshness_s = freshness_s
        self.region_of = region_of
        budget = getattr(config, "SLO_BURN_BUDGET", 0.05)
        threshold = getattr(config, "SLO_BURN_THRESHOLD", 2.0)
        fast = getattr(config, "SLO_BURN_FAST_WINDOW", 10.0)
        slow = getattr(config, "SLO_BURN_SLOW_WINDOW", 60.0)
        self.window = slow
        # a node whose last snapshot is older than this (vs the fleet
        # clock self.now) scores 0.0: a crashed/partitioned node must
        # read as DOWN, not frozen-at-healthy
        self.stale_after = getattr(config, "TELEMETRY_STALE_AFTER", 10.0)
        # pool-scoped judgments (imbalance, staleness sweep) run once
        # per snapshot interval, not once per ingest — per-ingest cost
        # must not grow with fleet size
        self._pool_eval_interval = getattr(config, "TELEMETRY_INTERVAL",
                                           1.0)
        self._pool_eval_next = 0.0
        self._mk_burn = lambda: BurnRateTracker(budget, threshold, fast, slow)
        # per (slo kind, node) burn tracker; alert latches per kind+subject
        # hold the ACTIVE Alert object (None when clear), so active_alerts
        # survives history trimming and costs O(latches), not O(history)
        self.burn: dict[tuple[str, str], BurnRateTracker] = {}
        self._latched: dict[tuple[str, str], Optional[Alert]] = {}
        # bounded raise/clear history: a flapping condition on a
        # long-lived aggregator must not grow memory without limit
        self.alerts: list[Alert] = []
        self.snapshots = 0
        # the fleet clock: MEDIAN of the nodes' latest stamps, not the
        # max — a single node stamping far-future times must not drag
        # the clock forward and stale the whole honest pool (staleness
        # tolerates the median's one-interval lag; TELEMETRY_STALE_AFTER
        # is many intervals)
        self.now = 0.0
        self._node_t: dict[str, float] = {}
        # node -> latest snapshot; node -> deque[(t, ordered_total)]
        self.latest: dict[str, dict] = {}
        self._ordered: dict[str, deque] = {}
        self._node_shard: dict[str, Optional[int]] = {}
        # judgment streaks, noted ONCE per pool interval: consecutive
        # active / consecutive clear counts per (kind, subject), so
        # `sustained(kind, N)` means N consecutive INTERVALS over
        # threshold — the one definition the autopilot and tests share
        # instead of re-deriving "sustained" ad hoc from raw burn values
        self._streaks: dict[tuple[str, str], int] = {}
        self._clear_streaks: dict[tuple[str, str], int] = {}
        # the autopilot (control/autopilot.py) publishes its live
        # summary here so the fleet console renders it off the same
        # aggregator handle it already holds; None = no autopilot
        self.autopilot: Optional[dict] = None
        # the Proof-CDN edge tier (reads/edge.py): per-region windowed
        # (t, hits, served, bytes) ledgers fed by EdgeFleet.note_edge,
        # plus the published per-region summary the console's EDGE line
        # renders; None = no edge fleet attached
        self.edge: Optional[dict] = None
        self._edge_hist: dict[str, deque] = {}
        # fleet history plane (observability/history.py): when a
        # HistoryRecorder is attached, one compact fleet row per pool
        # interval lands in its bounded ring; the growth watch trends
        # every resource-footprint gauge and raises the edge-triggered
        # unbounded_growth alert after HISTORY_GROWTH_SUSTAIN growing
        # intervals — the one bounded-growth primitive the soaks assert
        self.history = None
        self._growth = GrowthWatch(
            window=getattr(config, "HISTORY_GROWTH_WINDOW", 120.0),
            min_points=getattr(config, "HISTORY_GROWTH_MIN_POINTS", 8),
            floor=getattr(config, "HISTORY_GROWTH_FLOOR", 64.0),
            fraction=getattr(config, "HISTORY_GROWTH_FRACTION", 0.5),
            floors={
                # RSS is in bytes: its jitter floor is megabytes
                "process_rss_bytes": 64 << 20,
                # Gauges bounded BY CONSTRUCTION (capped rings/LRUs,
                # GC'd maps, TTL-swept tables) get their floor set AT
                # the design cap: below it, growth is the structure
                # filling its budget (a cold flight ring fills linearly
                # for minutes; BLS sig maps climb until the first
                # stable checkpoint GC — those trends are design, not
                # leaks); past it, the bound itself is broken and the
                # trend pages. The soaks' hard caps police the same
                # budgets instantaneously.
                "flight_ring_entries":
                    float(getattr(config, "TRACE_RING_SIZE", 4096)) + 1,
                "read_cache_entries": 4 * 4096 + 1,
                "bls_verdict_cache_entries": 16384 + 1,
                "stashed_entries": 8 * 1000 + 1,
                "request_state_entries": 5000 + 1,
                "dedup_map_entries": 5000 + 1,
                # per-validator-scaled caps use a generous 8-node bound
                "vc_vote_entries": (4 + 130) * 8 + 1,
                "bls_sig_entries":
                    2 * getattr(config, "CHK_FREQ", 100) * 8 + 1,
            })
        self._growth_sustain = getattr(config, "HISTORY_GROWTH_SUSTAIN", 3)

    def attach_history(self, recorder) -> None:
        """Record one fleet row per pool interval into `recorder` (a
        history.HistoryRecorder) — the console's TREND source and the
        post-mortem record correlate.py reads context from."""
        self.history = recorder

    # --- intake -----------------------------------------------------------

    def ingest(self, snap: dict) -> None:
        node = snap.get("node", "?")
        t = float(snap.get("t", 0.0))
        self.snapshots += 1
        self._node_t[node] = max(self._node_t.get(node, 0.0), t)
        stamps = sorted(self._node_t.values())
        mid = len(stamps) // 2
        median = stamps[mid] if len(stamps) % 2 \
            else (stamps[mid - 1] + stamps[mid]) / 2
        self.now = max(self.now, median)    # monotone fleet clock
        self.latest[node] = snap
        self._node_shard[node] = (snap.get("tags") or {}).get("shard")
        state = snap.get("state", {})
        node_state = state.get("node", {})
        ordered = node_state.get("ordered_total")
        if ordered is not None:
            hist = self._ordered.setdefault(node, deque(maxlen=1024))
            hist.append((t, int(ordered)))
        # SLO ledgers: every source section may carry {"slo": [viol, n]}
        # deltas — ingress queue-wait vs INGRESS_SLO_P95, batch path vs
        # BATCH_SLO_P95 — each feeds its own multi-window tracker
        for section, kind in (("ingress", "ingress"), ("node", "batch")):
            slo = state.get(section, {}).get("slo")
            if slo:
                tracker = self.burn.setdefault(
                    (kind, node), self._mk_burn())
                tracker.note(t, slo[0], slo[1])
        self._evaluate(node, t)

    def forget_node(self, node: str) -> None:
        """Remove a DECOMMISSIONED node from the fleet view (a retired
        shard after a merge): it must read as gone, not as a 0.0-health
        page — the staleness sweep only judges nodes still enrolled."""
        self.latest.pop(node, None)
        self._node_t.pop(node, None)
        self._ordered.pop(node, None)
        self._node_shard.pop(node, None)
        for key in [k for k in self.burn if k[1] == node]:
            del self.burn[key]
        for key in [k for k in self._latched if k[1] == node]:
            self._latched[key] = None
        for store in (self._streaks, self._clear_streaks):
            for key in [k for k in store if k[1] == node]:
                del store[key]

    # --- judgments ---------------------------------------------------------

    def _flags(self, snap: dict) -> dict:
        """Flatten the condition booleans health + alerts read."""
        state = snap.get("state", {})
        node_state = state.get("node", {})
        crypto = state.get("crypto", {})
        ingress = state.get("ingress", {})
        pipeline = state.get("pipeline", {})
        breaker = crypto.get("breaker_state")
        return {
            "read_only_degraded": node_state.get("read_only_degraded"),
            "catchup_running": node_state.get("catchup_running"),
            "vc_in_progress": node_state.get("vc_in_progress"),
            "breaker_open": breaker == "open",
            "breaker_half_open": breaker == "half_open",
            "shedding": ingress.get("shedding"),
            # multi-device ring: ANY chip lane degraded dings health
            # lightly (distinct from breaker_open so one sick chip in an
            # 8-lane ring reads as -0.2, not -0.5; the node-level crypto
            # breaker — lane 0's, the find_supervisor view — still
            # carries the full plane-down penalty when it opens)
            "lane_breaker_open": bool(pipeline.get("breakers_open")),
        }

    def anchor_age(self, node: str) -> Optional[float]:
        snap = self.latest.get(node)
        if snap is None:
            return None
        age = snap.get("state", {}).get("node", {}).get("anchor_age")
        return float(age) if age is not None else None

    def node_stale(self, node: str) -> bool:
        """True when the node has gone silent: no snapshot within
        `stale_after` of the fleet clock (the newest ingested stamp)."""
        snap = self.latest.get(node)
        return (snap is not None
                and self.now - float(snap.get("t", 0.0)) > self.stale_after)

    def node_health(self, node: str) -> Optional[float]:
        snap = self.latest.get(node)
        if snap is None:
            return None
        if self.node_stale(node):
            return 0.0              # down ≠ frozen-at-last-known-healthy
        age = self.anchor_age(node)
        stale = age is not None and age > self.freshness_s
        return node_health(self._flags(snap), anchor_stale=stale)

    def shard_health(self, healths: Optional[dict[str, Optional[float]]]
                     = None) -> dict[int, float]:
        """shard id -> min member health (a shard is as healthy as its
        sickest member: quorum math, not averages, decides liveness).
        Pass precomputed `healths` to avoid re-scoring every node."""
        out: dict[int, float] = {}
        for node, sid in self._node_shard.items():
            if sid is None:
                continue
            h = healths.get(node) if healths is not None \
                else self.node_health(node)
            if h is None:
                continue
            out[sid] = min(out.get(sid, 1.0), h)
        return out

    def ordered_rates(self) -> dict[int, float]:
        """shard id -> ordered txns/s over the trailing window ENDING AT
        the fleet clock (so a silent node's rate decays toward zero
        instead of freezing at its last-known figure); per-shard rate =
        max over member nodes, since all members order the same stream
        and a lagging member must not under-report the shard."""
        rates: dict[int, float] = {}
        t_end = self.now
        for node, hist in self._ordered.items():
            sid = self._node_shard.get(node)
            if sid is None or not hist:
                continue
            first = last = None
            for (ts, n) in reversed(hist):
                if ts < t_end - self.window:
                    break
                first = (ts, n)
                if last is None:
                    last = (ts, n)
            rate = 0.0
            if first is not None and t_end > first[0]:
                rate = (last[1] - first[1]) / (t_end - first[0])
            rates[sid] = max(rates.get(sid, 0.0), rate)
        return rates

    def load_imbalance(self, rates: Optional[dict[int, float]] = None
                       ) -> tuple[Optional[float], Optional[int]]:
        """-> (index, hot shard id). index = max rate / mean rate; None
        until at least two shards report. The hot shard is only named
        when the index crosses the config threshold."""
        if rates is None:
            rates = self.ordered_rates()
        if len(rates) < 2:
            return None, None
        mean = sum(rates.values()) / len(rates)
        if mean <= 0:
            return 1.0, None
        hot_sid, hot_rate = max(rates.items(), key=lambda kv: kv[1])
        index = hot_rate / mean
        threshold = getattr(self.config, "SHARD_IMBALANCE_THRESHOLD", 1.5)
        return round(index, 3), (hot_sid if index >= threshold else None)

    def cold_shard(self, rates: Optional[dict[int, float]] = None
                   ) -> Optional[int]:
        """The under-load merge candidate: the shard whose trailing
        ordered rate fell below mean * SHARD_UNDERLOAD_FACTOR. None
        until at least two shards report with a positive mean — an idle
        pool is balanced, not under-loaded."""
        if rates is None:
            rates = self.ordered_rates()
        if len(rates) < 2:
            return None
        mean = sum(rates.values()) / len(rates)
        if mean <= 0:
            return None
        cold_sid, cold_rate = min(rates.items(), key=lambda kv: kv[1])
        factor = getattr(self.config, "SHARD_UNDERLOAD_FACTOR", 0.25)
        return cold_sid if cold_rate < mean * factor else None

    def lane_breakers(self) -> dict[int, bool]:
        """Pipeline lane -> any node's latest snapshot reports that
        chip's breaker not closed (the `pipeline.devices` state section;
        remote federation lanes report through the same gauges)."""
        out: dict[int, bool] = {}
        for snap in self.latest.values():
            devices = snap.get("state", {}).get("pipeline", {}) \
                .get("devices") or []
            for dev in devices:
                lane = dev.get("lane")
                if lane is None:
                    continue
                sick = dev.get("breaker") not in (None, "none", "closed")
                out[lane] = out.get(lane, False) or sick
        return out

    # --- sustained judgments (the autopilot's input) -------------------------

    def tracker(self, kind: str, subject: str) -> BurnRateTracker:
        """Get-or-create the burn tracker for (kind, subject) — the
        seam external read planes (the observer fleet) feed their SLO
        ledgers through; its judgments join the streak notes and the
        `slo_burn.<kind>` sustained queries automatically."""
        return self.burn.setdefault((kind, subject), self._mk_burn())

    def note_edge(self, region: str, hits: int, served: int,
                  edges: int = 0, bytes_served: int = 0,
                  now: Optional[float] = None,
                  cache_entries: Optional[int] = None) -> None:
        """One edge-tier window for `region` (EdgeFleet._roll_window):
        DELTAS, not lifetime totals. Feeds the windowed hit-rate fold
        `edge_hit_rate` (the autopilot's absorbed-capacity signal) and
        publishes the per-region summary the console's EDGE line
        renders. The edge tier is untrusted, so this is capacity
        telemetry only — never a correctness judgment."""
        t = self.now if now is None else now
        hist = self._edge_hist.setdefault(region, deque(maxlen=256))
        hist.append((t, int(hits), int(served)))
        ed = self.edge if isinstance(self.edge, dict) else {}
        regions = ed.setdefault("regions", {})
        row = regions.setdefault(region, {"served": 0, "bytes": 0})
        row["edges"] = edges
        row["served"] += int(served)
        row["bytes"] += int(bytes_served)
        rate = self.edge_hit_rate(region)
        if rate is not None:
            row["hit_rate"] = round(rate, 4)
        if cache_entries is not None:
            row["cache_entries"] = int(cache_entries)
        ed["served"] = sum(r["served"] for r in regions.values())
        ed["bytes"] = sum(r["bytes"] for r in regions.values())
        ed["cache_entries"] = sum(r.get("cache_entries", 0)
                                  for r in regions.values())
        self.edge = ed

    def edge_hit_rate(self, region: str) -> Optional[float]:
        """The region's edge hit-rate folded over the slow SLO window
        (None = no edge windows noted inside it). The observer fan-out
        policy reads this before spawning: a region whose edges absorb
        nearly every read doesn't need more observer capacity."""
        hist = self._edge_hist.get(region)
        if not hist:
            return None
        cutoff = hist[-1][0] - self.window
        hits = served = 0
        for t, h, n in hist:
            if t >= cutoff:
                hits += h
                served += n
        return hits / served if served else None

    def _note_judgment(self, key: tuple[str, str], active: bool) -> None:
        if active:
            self._streaks[key] = self._streaks.get(key, 0) + 1
            self._clear_streaks[key] = 0
        else:
            self._clear_streaks[key] = self._clear_streaks.get(key, 0) + 1
            self._streaks[key] = 0

    def sustained(self, kind: str, intervals: int,
                  subject: Optional[str] = None) -> bool:
        """True when the (kind, subject) judgment has held ACTIVE for at
        least `intervals` CONSECUTIVE pool intervals. subject=None asks
        whether ANY subject of that kind is sustained."""
        if subject is not None:
            return self._streaks.get((kind, subject), 0) >= intervals
        return any(n >= intervals for (k, _s), n in self._streaks.items()
                   if k == kind)

    def sustained_subjects(self, kind: str, intervals: int) -> list[str]:
        """Every subject of `kind` currently sustained — the evidence
        list an autopilot decision records."""
        return sorted(s for (k, s), n in self._streaks.items()
                      if k == kind and n >= intervals)

    def sustained_clear(self, kind: str, intervals: int,
                        subject: Optional[str] = None) -> bool:
        """True when the judgment has held CLEAR for `intervals`
        consecutive pool intervals — subject=None requires EVERY
        ever-noted subject of the kind to be clear (vacuously true when
        none was ever noted)."""
        if subject is not None:
            return self._clear_streaks.get((kind, subject), 0) >= intervals
        keys = {k for k in (*self._streaks, *self._clear_streaks)
                if k[0] == kind}
        return all(self._clear_streaks.get(k, 0) >= intervals
                   for k in keys)

    def mapping_epochs(self) -> dict[int, int]:
        """shard id -> the MIN mapping epoch its members report (the
        `shard_map` telemetry state section) — the laggard is what an
        operator watching a reshard converge needs to see."""
        out: dict[int, int] = {}
        for node, snap in self.latest.items():
            sid = self._node_shard.get(node)
            epoch = snap.get("state", {}).get("shard_map", {}).get("epoch")
            if sid is None or epoch is None:
                continue
            out[sid] = min(out.get(sid, 1 << 30), int(epoch))
        return out

    def migrations(self) -> dict[int, dict]:
        """shard id -> live migration {role, phase, progress} from the
        shard's FRESHEST shard_map report (empty when nothing moves).
        A fresher member snapshot WITHOUT a migration clears the
        shard's entry — a node that crashed mid-migration must not pin
        a phantom 'copying@40%' on the console forever."""
        out: dict[int, dict] = {}
        best_t: dict[int, float] = {}
        for node, snap in self.latest.items():
            sid = self._node_shard.get(node)
            shard_map = snap.get("state", {}).get("shard_map")
            if sid is None or shard_map is None:
                continue
            t = float(snap.get("t", 0.0))
            if t < best_t.get(sid, -1.0):
                continue
            best_t[sid] = t
            mig = shard_map.get("migration")
            if mig:
                out[sid] = dict(mig)
            else:
                out.pop(sid, None)
        return out

    def _footprint(self) -> dict[str, float]:
        """Fleet-wide resource footprint: per-gauge MAX across each
        node's latest `state.footprint` section (the worst node is the
        leak candidate; a sum would double-count the replicated state),
        plus the edge tier's total cache entries when one is attached."""
        out: dict[str, float] = {}
        for snap in self.latest.values():
            fp = snap.get("state", {}).get("footprint") or {}
            for gauge, value in fp.items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                out[gauge] = max(out.get(gauge, 0.0), v)
        ed = self.edge if isinstance(self.edge, dict) else None
        if ed and ed.get("cache_entries") is not None:
            out["edge_cache_entries"] = float(ed["cache_entries"])
        return out

    def growth_verdicts(self) -> dict[str, dict]:
        """gauge -> growth verdict (history.GrowthWatch.verdict) over
        every footprint gauge seen so far — the soaks' single
        bounded-growth assertion surface."""
        return self._growth.verdicts(now=self.now)

    def staleness(self) -> dict[str, float]:
        """node (or region, with a region_of map) -> newest anchor age."""
        out: dict[str, float] = {}
        for node in self.latest:
            age = self.anchor_age(node)
            if age is None:
                continue
            key = self.region_of(node) if self.region_of else node
            prev = out.get(key)
            out[key] = age if prev is None else min(prev, age)
        return out

    # --- alerting -----------------------------------------------------------

    ALERTS_MAX = 1024

    def _raise(self, key: tuple[str, str], active: bool, t: float,
               detail: dict, severity: str = "page") -> None:
        was = self._latched.get(key) is not None
        if active == was:
            return
        kind, subject = key
        alert = Alert(t, kind, subject,
                      severity if active else "clear", detail)
        self._latched[key] = alert if active else None
        self.alerts.append(alert)
        if len(self.alerts) > self.ALERTS_MAX:
            del self.alerts[: -self.ALERTS_MAX]
        if self.metrics is not None and active:
            self.metrics.add_event(MetricsName.TELEMETRY_ALERTS)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.anomaly(f"alert.{kind}", alert.to_dict())

    def _evaluate(self, node: str, t: float) -> None:
        # burn-rate alerts for the trackers this node feeds (direct
        # lookup — never a scan over every node's trackers)
        for kind in ("ingress", "batch"):
            tracker = self.burn.get((kind, node))
            if tracker is not None:
                self._raise((f"slo_burn.{kind}", node),
                            tracker.alerting(t), t, tracker.summary(t))
        # health-floor alert per node
        floor = getattr(self.config, "HEALTH_ALERT_FLOOR", 0.5)
        h = self.node_health(node)
        if h is not None:
            self._raise(("health.node", node), h < floor, t,
                        {"health": round(h, 3),
                         "flags": {k: True for k, v in
                                   self._flags(self.latest[node]).items()
                                   if v}},
                        severity="warn")
        # pool-scoped judgments, once per snapshot interval (per-ingest
        # cost must not scale with fleet size)
        if t < self._pool_eval_next:
            return
        self._pool_eval_next = t + self._pool_eval_interval
        # a silent node can never evaluate itself — sweep for peers that
        # went dark so a crashed node reads 0.0, not frozen-at-healthy
        for other in self.latest:
            if other != node and self.node_stale(other):
                self._raise(("health.node", other), True, t,
                            {"health": 0.0,
                             "stale_s": round(
                                 self.now
                                 - float(self.latest[other].get("t", 0.0)),
                                 2)},
                            severity="warn")
        # shard imbalance: the flag clears as the rates re-balance
        rates = self.ordered_rates()
        index, hot = self.load_imbalance(rates)
        if index is not None:
            self._raise(("shard.imbalance", "pool"), hot is not None, t,
                        {"index": index, "hot_shard": hot},
                        severity="warn")
        # judgment streaks for sustained(): one note per pool interval
        self._note_judgment(("shard.imbalance", "pool"),
                            index is not None and hot is not None)
        # under-load is only judged while NO shard is hot, so a merge
        # streak can never accumulate while a split is warranted
        cold = self.cold_shard(rates)
        self._note_judgment(("shard.underload", "pool"),
                            hot is None and cold is not None)
        for (kind, node), tracker in self.burn.items():
            self._note_judgment((f"slo_burn.{kind}", node),
                                tracker.alerting(t))
        for lane, open_ in self.lane_breakers().items():
            self._note_judgment(("pipeline.lane", str(lane)), open_)
        # growth trends over the resource-footprint gauges: note one
        # sample per gauge per pool interval, judge the windowed fit,
        # and page (edge-triggered, latched) only after the growth has
        # SUSTAINED — a cache filling its working set must not alarm.
        # Ledger-backed gauges (GROWTH_EXEMPT_GAUGES) are trended for
        # the console but never judged: a chain grows by design.
        fp = self._footprint()
        for gauge, value in sorted(fp.items()):
            self._growth.note(gauge, t, value)
        for gauge, v in self._growth.verdicts(now=t).items():
            growing = (v.get("verdict") == "growing"
                       and gauge not in GROWTH_EXEMPT_GAUGES)
            key = ("unbounded_growth", gauge)
            self._note_judgment(key, growing)
            self._raise(key,
                        self._streaks.get(key, 0) >= self._growth_sustain,
                        t, {"gauge": gauge, **v})
        if self.history is not None:
            self.history.append(self._history_row(t, fp, rates, index, hot))

    def _history_row(self, t: float, fp: dict, rates: dict,
                     index, hot) -> dict:
        """One compact fleet row for the history ring. Every field
        derives from ingested snapshots and the fleet clock — replaying
        the same stream reproduces the ring byte-for-byte (sampled
        percentiles only appear when the emitters ran wall_sums=True)."""
        row: dict = {"t": round(t, 6), "nodes": len(self.latest)}
        healths = [h for h in (self.node_health(n) for n in self.latest)
                   if h is not None]
        if healths:
            row["health_min"] = round(min(healths), 3)
            row["health_mean"] = round(sum(healths) / len(healths), 3)
        row["tps"] = round(sum(rates.values()) if rates
                           else self._pool_rate(), 2)
        if index is not None:
            row["imbalance"] = index
        if hot is not None:
            row["hot_shard"] = hot
        if self.burn:
            summaries = [tr.summary(t) for tr in self.burn.values()]
            row["burn_fast"] = max(s["fast"] for s in summaries)
            row["burn_slow"] = max(s["slow"] for s in summaries)
        row["alerts"] = len(self.active_alerts())
        if isinstance(self.autopilot, dict):
            ap = {k: self.autopilot[k]
                  for k in ("state", "actions", "reverts", "holds")
                  if k in self.autopilot}
            if ap:
                row["autopilot"] = ap
        p95 = None
        for snap in self.latest.values():
            s = snap.get("sampled", {}).get(MetricsName.ORDERING_TIME)
            if s:
                p95 = max(p95 or 0.0, float(s[1]))
        if p95 is not None:
            row["ordering_p95"] = round(p95, 6)
        if fp:
            row["footprint"] = {k: round(v, 2)
                                for k, v in sorted(fp.items())}
        return row

    def _pool_rate(self) -> float:
        """Ordered txns/s for an UNSHARDED pool: the per-shard fold in
        ordered_rates skips nodes without a shard tag, so the history
        row's TPS needs its own max-across-nodes window (all nodes
        order the same replicated stream)."""
        t_end = self.now
        best = 0.0
        for hist in self._ordered.values():
            first = last = None
            for (ts, n) in reversed(hist):
                if ts < t_end - self.window:
                    break
                first = (ts, n)
                if last is None:
                    last = (ts, n)
            if first is not None and t_end > first[0]:
                best = max(best, (last[1] - first[1])
                           / (t_end - first[0]))
        return best

    def active_alerts(self) -> list[Alert]:
        return [a for a in self._latched.values() if a is not None]

    # --- reporting -----------------------------------------------------------

    def fleet_summary(self) -> dict:
        rates = self.ordered_rates()
        index, hot = self.load_imbalance(rates)
        healths = {n: self.node_health(n) for n in self.latest}
        shard_h = self.shard_health(healths)
        burn = {}
        for (kind, node), tracker in sorted(self.burn.items()):
            burn.setdefault(kind, {})[node] = tracker.summary(self.now)
        return {
            "t": self.now,
            "snapshots": self.snapshots,
            "nodes": {n: {
                "health": healths[n],
                "seq": self.latest[n].get("seq"),
                "shard": self._node_shard.get(n),
                "anchor_age": self.anchor_age(n),
            } for n in sorted(self.latest)},
            "shard_health": {str(k): round(v, 3)
                             for k, v in sorted(shard_h.items())},
            "mapping_epochs": {str(k): v for k, v in
                               sorted(self.mapping_epochs().items())},
            "migrations": {str(k): v for k, v in
                           sorted(self.migrations().items())},
            "ordered_rates": {str(k): round(v, 2) for k, v in
                              sorted(rates.items())},
            "load_imbalance": index,
            "hot_shard": hot,
            "staleness": {k: round(v, 2)
                          for k, v in sorted(self.staleness().items())},
            "burn": burn,
            "alerts": [a.to_dict() for a in self.alerts[-50:]],
            "active_alerts": [a.to_dict() for a in self.active_alerts()],
            **({"footprint": {k: round(v, 2)
                              for k, v in sorted(fp.items())}}
               if (fp := self._footprint()) else {}),
            **({"growth": growth}
               if (growth := {g: v for g, v in
                              self.growth_verdicts().items()
                              if v.get("verdict") != "insufficient"})
               else {}),
        }
