"""Performance monitor — the "R" in RBFT.

Reference behavior: plenum/server/monitor.py:136 (Monitor,
RequestTimeTracker:30), common/monitor_strategies.py,
throughput_measurements.py — every instance's ordered traffic is measured
(EMA throughput with a revival-spike-safe warmup, latency from request
finalization to ordering); the master is DEGRADED when its throughput falls
below DELTA × the best backup's (instance_throughput_ratio:456,
isMasterDegraded:425) or its request latency exceeds the backups' by OMEGA.
A degraded master costs the pool its performance without being provably
Byzantine — exactly what the f+1 redundant instances exist to detect — and
is answered with a view-change vote (Node.checkPerformance:2501).
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.config import Config


class EMAThroughput:
    """Windowed exponential-moving-average events/second.

    Events are accumulated into fixed windows of `window_size` seconds; each
    completed window folds into the EMA. A `min_activity_windows` warmup keeps
    a just-revived (or just-created) instance from reading as degraded/spiking
    before it has real history (ref throughput_measurements.py
    EMAThroughputMeasurement + safe-start wrapper, config.py:149-154).
    """

    def __init__(self, window_size: float = 15.0, alpha: float = 0.5,
                 min_activity_windows: int = 2):
        self.window_size = window_size
        self.alpha = alpha
        self.min_activity_windows = min_activity_windows
        self._started: Optional[float] = None
        self._window_start = 0.0
        self._window_count = 0
        self._ema: Optional[float] = None
        self._windows_seen = 0

    def start(self, now: float) -> None:
        self._started = now
        self._window_start = now

    def add(self, count: int, now: float) -> None:
        if self._started is None:
            self.start(now)
        self._advance(now)
        self._window_count += count

    def _advance(self, now: float) -> None:
        while now >= self._window_start + self.window_size:
            rate = self._window_count / self.window_size
            self._ema = rate if self._ema is None else \
                self.alpha * rate + (1.0 - self.alpha) * self._ema
            self._window_count = 0
            self._window_start += self.window_size
            self._windows_seen += 1

    def throughput(self, now: float) -> Optional[float]:
        """None while warming up (no safe reading yet)."""
        if self._started is None:
            return None
        self._advance(now)
        if self._windows_seen < self.min_activity_windows:
            return None
        return self._ema


class RequestTimeTracker:
    """Request digest -> finalization time; yields per-instance ordering
    latencies (ref monitor.py RequestTimeTracker:30)."""

    def __init__(self):
        self._added: dict[str, float] = {}
        # per-instance EMA of ordering latency
        self._latency: dict[int, float] = {}
        self._alpha = 0.3

    def add(self, digest: str, now: float) -> None:
        self._added.setdefault(digest, now)

    def cleanup(self, now: float, max_age: float) -> None:
        """Drop stale entries (requests that never ordered — discarded,
        stalled, or lost): without this the map grows without bound."""
        self._added = {d: ts for d, ts in self._added.items()
                       if now - ts <= max_age}

    def ordered(self, inst_id: int, digests, now: float,
                release: bool = False) -> None:
        for digest in digests:
            ts = self._added.get(digest)
            if ts is None:
                continue
            sample = now - ts
            prev = self._latency.get(inst_id)
            self._latency[inst_id] = sample if prev is None else \
                self._alpha * sample + (1 - self._alpha) * prev
            if release:
                del self._added[digest]

    def latency(self, inst_id: int) -> Optional[float]:
        return self._latency.get(inst_id)

    def drop(self, digest: str) -> None:
        self._added.pop(digest, None)

    @property
    def tracked_count(self) -> int:
        return len(self._added)


class Monitor:
    """Per-instance throughput/latency bookkeeping + the degradation verdict.

    The node feeds it: `request_finalized` when the propagate quorum fires,
    `request_ordered` on every instance's Ordered event. `is_master_degraded`
    implements the RBFT comparison; the node's checkPerformance loop turns a
    True into VoteForViewChange(PRIMARY_DEGRADED).
    """

    MASTER = 0

    def __init__(self, config: Optional[Config] = None,
                 now: Callable[[], float] = lambda: 0.0):
        self._config = config or Config()
        self._now = now
        self.throughputs: dict[int, EMAThroughput] = {}
        self.req_tracker = RequestTimeTracker()
        self.total_ordered: dict[int, int] = {}
        self.ordered_batches: dict[int, int] = {}

    def _tp(self, inst_id: int) -> EMAThroughput:
        if inst_id not in self.throughputs:
            tp = EMAThroughput(
                window_size=self._config.throughput_first_ts_window,
                min_activity_windows=2)
            tp.start(self._now())
            self.throughputs[inst_id] = tp
        return self.throughputs[inst_id]

    def reset(self) -> None:
        """View change / instance-set change: all history is void
        (ref monitor.reset on view change)."""
        self.throughputs.clear()
        self.req_tracker = RequestTimeTracker()

    # --- feeding ----------------------------------------------------------

    def request_finalized(self, digest: str) -> None:
        self.req_tracker.add(digest, self._now())

    def request_ordered(self, inst_id: int, digests) -> None:
        now = self._now()
        self._tp(inst_id).add(len(digests), now)
        self.total_ordered[inst_id] = \
            self.total_ordered.get(inst_id, 0) + len(digests)
        self.ordered_batches[inst_id] = self.ordered_batches.get(inst_id, 0) + 1
        # only the master's ordering releases the tracker entry: backups
        # ordering the same request later must still find it for latency
        self.req_tracker.ordered(inst_id, digests, now,
                                 release=(inst_id == self.MASTER))

    # --- verdicts ---------------------------------------------------------

    def instance_throughput_ratio(self) -> Optional[float]:
        """master_throughput / best_backup_throughput; None while warming up
        or with no backups (ref instance_throughput_ratio:456)."""
        now = self._now()
        master = self._tp(self.MASTER).throughput(now)
        backups = [tp for i, t in self.throughputs.items()
                   if i != self.MASTER
                   and (tp := t.throughput(now)) is not None]
        if master is None or not backups:
            return None
        best = max(backups)
        if best == 0:
            return None
        return master / best

    def master_latency_excess(self) -> Optional[float]:
        master = self.req_tracker.latency(self.MASTER)
        backups = [lat for i in self.req_tracker._latency
                   if i != self.MASTER
                   and (lat := self.req_tracker.latency(i)) is not None]
        if master is None or not backups:
            return None
        return master - min(backups)

    def is_master_degraded(self) -> bool:
        """ref isMasterDegraded:425 — throughput ratio below DELTA, or
        latency excess beyond OMEGA."""
        ratio = self.instance_throughput_ratio()
        if ratio is not None and ratio < self._config.DELTA:
            return True
        excess = self.master_latency_excess()
        if excess is not None and excess > self._config.OMEGA:
            return True
        return False

    # --- stats (bench + validator-info surface) ---------------------------

    def master_throughput(self) -> Optional[float]:
        return self._tp(self.MASTER).throughput(self._now())

    def stats(self) -> dict:
        now = self._now()
        return {
            "throughput": {i: tp.throughput(now)
                           for i, tp in self.throughputs.items()},
            "latency": {i: self.req_tracker.latency(i)
                        for i in self.req_tracker._latency},
            "total_ordered": dict(self.total_ordered),
            "ordered_batches": dict(self.ordered_batches),
            "master_degraded": self.is_master_degraded(),
        }
