"""Fleet history plane: a durable time-series ring + growth-rate verdicts.

The telemetry plane (snapshot.py/aggregator.py) sees only the present:
per-interval snapshots fold into health scores and are discarded. This
module is the layer that remembers — two primitives:

* :class:`HistoryRecorder` — a bounded, replay-deterministic on-disk
  time-series ring. The :class:`~.aggregator.FleetAggregator` appends
  ONE compact fleet row per pool interval (health, imbalance, TPS,
  burn state, autopilot counts, resource footprint); rows rotate over
  ``HISTORY_MAX_SLOTS`` numbered files written atomically (tmp+rename —
  the telemetry-spool discipline), so a console or a post-mortem can
  read a torn-free record of the whole run, and a sim-time week costs
  bounded disk. ``query(t0, t1, max_points)`` returns a windowed,
  evenly-downsampled slice; ``history_bytes`` is the canonical
  serialization the replay-determinism guard compares.

* :class:`GrowthWatch` — per-gauge growth-rate trends: a windowed
  least-squares fit over each resource-footprint gauge's (t, value)
  series. A gauge whose PROJECTED growth over the window exceeds both
  an absolute floor and a fraction of its mean level reads "growing";
  sustained growth raises the aggregator's edge-triggered
  ``anomaly.alert.unbounded_growth`` naming the gauge — the single
  bounded-growth primitive the soaks (tools/churn_soak.py,
  tools/soak.py) assert through instead of hand-rolled caps.

Determinism: rows are built ONLY from snapshot-derived values and the
fleet clock, so a replayed seeded run (``wall_sums=False``) produces a
byte-identical history ring — the telemetry twin of the tracer's
``wall_durations`` guard.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Optional

HISTORY_SCHEMA_VERSION = 1

# Gauges that grow with the CHAIN by design — the ledger-backed KV
# stores. They are recorded and trended (capacity planning needs the
# curve) but never judged "unbounded": a healthy pool ordering writes
# grows its ledger forever, and paging on that would teach operators to
# ignore the alert that matters.
GROWTH_EXEMPT_GAUGES = frozenset({"kv_entries", "kv_disk_bytes"})


def linear_slope(points) -> Optional[float]:
    """Least-squares slope (value units per second) over [(t, value)];
    None with fewer than two points or zero time spread."""
    n = len(points)
    if n < 2:
        return None
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    den = sum((t - mt) ** 2 for t, _ in points)
    if den <= 0:
        return None
    num = sum((t - mt) * (v - mv) for t, v in points)
    return num / den


class GrowthWatch:
    """Windowed linear-fit growth trends over named gauges.

    ``note(gauge, t, value)`` records one sample; ``verdict(gauge)``
    fits the samples inside the trailing `window` and judges:

    * ``insufficient`` — fewer than `min_points` samples in the window
      (a fresh gauge must not alert off two points);
    * ``growing`` — the gauge's current value is at least `floor` AND
      the fitted slope projects growth — over the span the samples
      actually cover, capped at one window — exceeding max(`floor`,
      `fraction` * mean level). Three gates, so a tiny structure
      ramping from empty to its working set (value below the floor)
      and a large one breathing within it (projection below the
      fraction of its level) stay quiet, while a real leak — growth
      that keeps outrunning its own level — trips;
    * ``bounded`` — everything else. Note the verdict reads the
      TRAILING window only: a slow leak pages when it first outruns
      its level, and once it has grown huge it reads as its own new
      baseline — the latched alert and the ring rows are the record.

    `floors` optionally overrides the absolute floor per gauge (an RSS
    gauge measured in bytes needs a megabyte-scale floor, not an
    entry-count one).
    """

    def __init__(self, window: float = 120.0, min_points: int = 8,
                 floor: float = 64.0, fraction: float = 0.5,
                 floors: Optional[dict] = None):
        self.window = window
        self.min_points = max(2, int(min_points))
        self.floor = floor
        self.fraction = fraction
        self.floors = dict(floors) if floors else {}
        self._series: dict[str, deque] = {}

    def note(self, gauge: str, t: float, value) -> None:
        series = self._series.setdefault(gauge, deque(maxlen=1024))
        series.append((float(t), float(value)))

    def gauges(self) -> list[str]:
        return sorted(self._series)

    def verdict(self, gauge: str, now: Optional[float] = None) -> dict:
        series = self._series.get(gauge)
        if not series:
            return {"verdict": "insufficient", "points": 0}
        t_end = series[-1][0] if now is None else now
        pts = [(t, v) for (t, v) in series if t >= t_end - self.window]
        out = {"points": len(pts),
               "value": pts[-1][1] if pts else series[-1][1]}
        if len(pts) < self.min_points:
            out["verdict"] = "insufficient"
            return out
        slope = linear_slope(pts)
        mean = sum(v for _, v in pts) / len(pts)
        gauge_floor = self.floors.get(gauge, self.floor)
        threshold = max(gauge_floor, self.fraction * mean)
        # Project over the span the samples actually cover (capped at
        # the window) — extrapolating a 9-second cold-start wiggle out
        # to a full window would page on noise.
        horizon = min(self.window, pts[-1][0] - pts[0][0])
        projected = (slope or 0.0) * horizon
        growing = out["value"] >= gauge_floor and projected > threshold
        out.update({"slope_per_s": round(slope or 0.0, 6),
                    "projected": round(projected, 2),
                    "threshold": round(threshold, 2),
                    "verdict": "growing" if growing else "bounded"})
        return out

    def verdicts(self, now: Optional[float] = None) -> dict[str, dict]:
        return {g: self.verdict(g, now=now) for g in self.gauges()}


class HistoryRecorder:
    """Bounded on-disk (and in-memory) ring of per-interval fleet rows.

    `max_slots` bounds BOTH the in-memory deque and the on-disk window:
    row seq N lands in file ``history-<N % max_slots>.json`` via
    tmp+rename, so a reader never sees a torn row and a week-long run
    costs `max_slots` files, not a week of appends. ``dir=None`` keeps
    the ring in memory only (the soak/test mode).
    """

    def __init__(self, dir: Optional[str] = None, max_slots: int = 512):
        self.dir = dir
        self.max_slots = max(1, int(max_slots))
        self.rows: deque = deque(maxlen=self.max_slots)
        self.seq = 0                    # total rows ever appended
        self.spooled = 0

    def append(self, row: dict) -> None:
        row = {"v": HISTORY_SCHEMA_VERSION, "seq": self.seq, **row}
        self.rows.append(row)
        if self.dir is not None:
            self._spool(row)
        self.seq += 1

    def _spool(self, row: dict) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
            slot = row["seq"] % self.max_slots
            path = os.path.join(self.dir, f"history-{slot}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(row, fh, default=repr)
            os.replace(tmp, path)
            self.spooled += 1
        except OSError:
            pass                # a full disk must not take down the fleet

    # --- queries -----------------------------------------------------------

    def window(self, t0: Optional[float] = None,
               t1: Optional[float] = None) -> list[dict]:
        """Rows with t in [t0, t1] (None = unbounded side), seq order."""
        out = []
        for row in self.rows:
            t = float(row.get("t", 0.0))
            if t0 is not None and t < t0:
                continue
            if t1 is not None and t > t1:
                continue
            out.append(row)
        return out

    def query(self, t0: Optional[float] = None, t1: Optional[float] = None,
              max_points: Optional[int] = None) -> list[dict]:
        """Windowed slice, evenly downsampled to at most `max_points`
        rows (first and last of the window always kept) — how a
        sim-time week renders on an 80-column console."""
        rows = self.window(t0, t1)
        if not max_points or len(rows) <= max_points:
            return rows
        if max_points == 1:
            return [rows[-1]]
        step = (len(rows) - 1) / (max_points - 1)
        picked = []
        seen = set()
        for i in range(max_points):
            idx = round(i * step)
            if idx not in seen:
                seen.add(idx)
                picked.append(rows[idx])
        return picked

    def history_bytes(self) -> bytes:
        """Canonical serialization of the ring — the unit the replay
        determinism guard compares byte-for-byte."""
        return b"|".join(
            json.dumps(r, sort_keys=True, separators=(",", ":"),
                       default=repr).encode()
            for r in self.rows)

    @classmethod
    def load(cls, dir: str, max_slots: int = 512) -> "HistoryRecorder":
        """Rebuild a recorder from its on-disk slot window (rows sorted
        by seq; torn/mid-replace files skipped — the atomic-write
        discipline means a valid older row is still on disk)."""
        rec = cls(dir=None, max_slots=max_slots)
        rows = []
        try:
            names = os.listdir(dir)
        except OSError:
            names = []
        for name in names:
            if not (name.startswith("history-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(dir, name)) as fh:
                    row = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(row, dict) and "seq" in row:
                rows.append(row)
        rows.sort(key=lambda r: r["seq"])
        for row in rows:
            rec.rows.append(row)
        rec.seq = (rows[-1]["seq"] + 1) if rows else 0
        rec.dir = dir
        return rec
