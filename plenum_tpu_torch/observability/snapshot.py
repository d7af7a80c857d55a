"""Per-node telemetry snapshots: the unit of the live fleet view.

A :class:`TelemetryEmitter` periodically folds the node's in-memory
metrics accumulators into a compact snapshot — counter DELTAS since the
previous snapshot (so the stream is a rate signal, robust to collector
flushes), p50/p95 over the sampled names' reservoirs, plus a ``state``
section of live gauges contributed by registered sources (the node
itself, its ingress plane, the shared crypto pipeline).

Design constraints, inherited from the tracing plane:

1. **Disabled cost is one attribute check.** ``NULL_TELEMETRY.enabled``
   is a class attribute ``False``; call sites guard with
   ``if telemetry.enabled:`` and a disabled node registers NO snapshot
   timer. The microbenchmark assertion in tests/test_telemetry.py pins
   the pattern's cost exactly like the NullTracer one.

2. **Replay determinism.** Snapshot stamps come ONLY from the node's
   injectable timer, so replaying a recorded node produces a
   byte-identical snapshot stream (``snapshot_bytes`` is the canonical
   serialization the determinism guard compares). Counter SUMS and the
   sampled percentiles are the one legitimately non-deterministic part
   (stage timers measure wall time via perf_counter); exactly like the
   tracer's ``wall_durations`` flag, ``wall_sums=False`` strips them so
   replay comparisons see only the deterministic event counts.

Transport: snapshots go to in-process ``sinks`` (a FleetAggregator, a
test list), optionally over the wire as the best-effort ``TELEMETRY``
message (``ship_fn``; SimNetwork and the TCP stack both carry any
MessageBase), and into a bounded on-disk spool (atomic tmp+rename and a
rotating numbered window — the flight-dump discipline), so a live
console can follow a TCP pool without touching its process.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Callable, Optional

from plenum_tpu_torch.common.metrics import MetricsName, percentile

SCHEMA_VERSION = 1

# --- the snapshot schema ----------------------------------------------------
# Every MetricsName the node emits must appear in exactly one section
# below (or in EXEMPT_METRICS with a reason) — tools/metrics_lint.py
# enforces this in tier-1, so a new counter cannot silently bypass the
# fleet view. The section names the part of a snapshot the metric's
# delta/percentiles ride in; the emitter itself is generic (it folds
# every accumulator it sees), the schema is the contract maintainers
# and the lint read.
SNAPSHOT_SCHEMA: dict[str, frozenset] = {
    "node": frozenset({
        MetricsName.PROD_TIME, MetricsName.CLIENT_MSGS,
        MetricsName.PROPAGATES, MetricsName.ORDERED_BATCH_SIZE,
        MetricsName.EXECUTE_BATCH_TIME, MetricsName.BACKUP_ORDERED,
        MetricsName.GROUP_COMMIT_BATCHES,
        MetricsName.CLIENT_INBOX_DEPTH, MetricsName.PROPAGATE_INBOX_DEPTH,
    }),
    "consensus": frozenset({
        MetricsName.BATCH_CTL_SIZE, MetricsName.BATCH_CTL_WAIT,
        MetricsName.BATCH_CTL_DEPTH, MetricsName.BATCH_CTL_COALESCE,
        MetricsName.BATCH_CTL_DECISIONS,
        MetricsName.VIEW_CHANGES, MetricsName.SUSPICIONS,
        MetricsName.BACKUP_INSTANCE_REMOVED, MetricsName.CATCHUPS,
        MetricsName.MASTER_3PC_BATCH_TIME,
        MetricsName.PREPARE_PHASE_TIME, MetricsName.COMMIT_PHASE_TIME,
        MetricsName.ORDERING_TIME,
        MetricsName.VC_DETECT_TO_VOTE, MetricsName.VC_VOTE_TO_START,
        MetricsName.VC_START_TO_NEW_VIEW, MetricsName.VC_NEW_VIEW_TO_ORDER,
        MetricsName.REQUEST_QUEUE_DEPTH,
    }),
    "commit_path": frozenset({
        MetricsName.COMMIT_BLS_VERIFY_TIME, MetricsName.COMMIT_APPLY_TIME,
        MetricsName.COMMIT_DURABLE_TIME, MetricsName.COMMIT_REPLY_TIME,
        MetricsName.COMMIT_WAVE_TIME,
    }),
    "crypto": frozenset({
        MetricsName.SIG_BATCH_SIZE, MetricsName.SIG_BATCH_TIME,
        MetricsName.BLS_VERIFY_TIME, MetricsName.BLS_PAIRING_CHECKS,
        MetricsName.BLS_PAIRINGS, MetricsName.BLS_PAIRINGS_NATIVE,
        MetricsName.BLS_PAIRINGS_PER_BATCH,
        MetricsName.SIG_PLANE_DISPATCHES,
        MetricsName.CRYPTO_BREAKER_STATE, MetricsName.CRYPTO_BREAKER_OPENS,
        MetricsName.CRYPTO_FALLBACK_BATCHES,
        MetricsName.CRYPTO_FALLBACK_ITEMS,
        MetricsName.CRYPTO_HEDGE_WINS, MetricsName.CRYPTO_DEADLINE_MISSES,
        MetricsName.CRYPTO_DISPATCH_BUDGET,
        MetricsName.BLS_BATCH_FALLBACKS, MetricsName.BLS_LOCAL_FALLBACKS,
        MetricsName.SIG_BATCH_FILL_TIME, MetricsName.SIG_DISPATCH_TIME,
    }),
    "pipeline": frozenset({
        MetricsName.PIPELINE_DISPATCHES,
        MetricsName.PIPELINE_ITEMS_PER_DISPATCH,
        MetricsName.PIPELINE_OCCUPANCY, MetricsName.PIPELINE_PAD_WASTE,
        MetricsName.PIPELINE_DEDUP_RATIO,
        MetricsName.PIPELINE_BUCKET_HIT_RATE,
        MetricsName.PIPELINE_COMPILED_SHAPES,
        MetricsName.PIPELINE_CTL_FLUSH_WAIT,
        MetricsName.PIPELINE_CTL_BUCKET_FLOOR,
        MetricsName.PIPELINE_CTL_DECISIONS,
        MetricsName.PIPELINE_DEVICE_LANES,
        MetricsName.PIPELINE_DEVICE_BREAKERS_OPEN,
        MetricsName.PIPELINE_DEVICE_OCCUPANCY_MAX,
        MetricsName.PIPELINE_DEVICE_DISPATCH_SPREAD,
        MetricsName.PIPELINE_CMT_WAVES, MetricsName.PIPELINE_CMT_ITEMS,
        MetricsName.PIPELINE_CMT_LEVELS,
        MetricsName.PIPELINE_CMT_HOST_FALLBACKS,
        MetricsName.PIPELINE_FED_REMOTE_LANES,
        MetricsName.PIPELINE_FED_STEALS,
        MetricsName.PIPELINE_FED_STOLEN_ITEMS,
        MetricsName.PIPELINE_FED_REMOTE_BREAKERS_OPEN,
        MetricsName.PIPELINE_FED_SHIP_MS_P95,
    }),
    "reads": frozenset({
        MetricsName.READ_QUERIES, MetricsName.READ_PROOF_GEN_TIME,
        MetricsName.READ_CACHE_HITS, MetricsName.READ_PROOFS_STATE,
        MetricsName.READ_PROOFS_MERKLE, MetricsName.READ_PROOFS_VERKLE,
        MetricsName.READ_PROOFLESS,
        MetricsName.READ_ANCHOR_UPDATES,
        MetricsName.READ_PROOF_BYTES_STATE,
        MetricsName.READ_PROOF_BYTES_STATE_MULTI,
        MetricsName.READ_PROOF_BYTES_MERKLE,
        MetricsName.READ_PROOF_BYTES_VERKLE,
        MetricsName.READ_PROOF_BYTES_VERKLE_MULTI,
        MetricsName.OBSERVER_PUSHES, MetricsName.OBSERVER_MS_ADOPTED,
        MetricsName.OBSERVER_MS_REJECTED,
        MetricsName.OBSERVER_STALE_SUPPRESSED,
    }),
    "edge": frozenset({
        MetricsName.EDGE_QUERIES, MetricsName.EDGE_HITS,
        MetricsName.EDGE_MISSES, MetricsName.EDGE_REVALIDATIONS,
        MetricsName.EDGE_INVALIDATIONS, MetricsName.EDGE_NEGATIVE_HITS,
        MetricsName.EDGE_BYTES_SERVED, MetricsName.EDGE_VERIFY_FAILURES,
    }),
    "ingress": frozenset({
        MetricsName.INGRESS_ADMITTED, MetricsName.INGRESS_SHED,
        MetricsName.INGRESS_QUEUE_WAIT, MetricsName.INGRESS_QUEUE_DEPTH,
        MetricsName.INGRESS_AUTH_BATCH, MetricsName.INGRESS_AUTH_FAIL,
        MetricsName.INGRESS_CLIENTS, MetricsName.INGRESS_FAIRNESS_SPREAD,
        MetricsName.INGRESS_CTL_ADMIT, MetricsName.INGRESS_CTL_WATERMARK,
        MetricsName.INGRESS_CTL_DECISIONS,
    }),
    "shards": frozenset({
        MetricsName.SHARD_ROUTED, MetricsName.SHARD_UNROUTABLE,
        MetricsName.SHARD_ORDERED_BATCHES, MetricsName.SHARD_CROSS_READS,
        MetricsName.SHARD_CROSS_READS_OK,
        MetricsName.SHARD_MAP_PROOF_FAILURES,
        MetricsName.SHARD_CROSS_VERIFY_TIME,
        MetricsName.SHARD_HEALTH, MetricsName.SHARD_IMBALANCE,
        MetricsName.RESHARD_MIGRATIONS, MetricsName.RESHARD_COPIED,
        MetricsName.RESHARD_FORWARDED, MetricsName.RESHARD_STALE_NACKS,
        MetricsName.RESHARD_UNSETTLED,
        MetricsName.SHARD_FAST_NACKS,
        MetricsName.XSW_BEGUN, MetricsName.XSW_COMMITS,
        MetricsName.XSW_ABORTS,
    }),
    "robustness": frozenset({
        MetricsName.VC_DURATION, MetricsName.CATCHUP_DURATION,
        MetricsName.CATCHUP_ROUNDS, MetricsName.CATCHUP_PROVIDER_SWITCHES,
        MetricsName.CATCHUP_WATCHDOG_KICKS, MetricsName.CATCHUP_DEGRADED,
        MetricsName.MEMBERSHIP_POOL_CHANGES, MetricsName.MEMBERSHIP_VALIDATORS,
        MetricsName.MEMBERSHIP_KEY_ROTATIONS,
    }),
    "telemetry": frozenset({
        MetricsName.TELEMETRY_SNAPSHOTS, MetricsName.TELEMETRY_ALERTS,
        MetricsName.TELEMETRY_SOURCE_ERRORS,
    }),
    "autopilot": frozenset({
        MetricsName.AUTOPILOT_DECISIONS, MetricsName.AUTOPILOT_ACTIONS,
        MetricsName.AUTOPILOT_REVERTS, MetricsName.AUTOPILOT_HOLDS,
    }),
    # resource footprint: size-now gauges for every bounded structure —
    # the raw series observability/history.py fits growth trends over.
    # PROCESS_RSS_BYTES graduates out of EXEMPT here: a host gauge is a
    # poor fleet AGGREGATE but a fine fleet TREND (any node's RSS curve
    # bending up is a fleet problem).
    "footprint": frozenset({
        MetricsName.FOOTPRINT_KV_ENTRIES,
        MetricsName.FOOTPRINT_KV_DISK_BYTES,
        MetricsName.FOOTPRINT_FLIGHT_RING,
        MetricsName.FOOTPRINT_STASHED,
        MetricsName.FOOTPRINT_REQUEST_STATE,
        MetricsName.FOOTPRINT_DEDUP_MAP,
        MetricsName.FOOTPRINT_READ_CACHE,
        MetricsName.FOOTPRINT_VC_VOTES,
        MetricsName.FOOTPRINT_BLS_SIGS,
        MetricsName.FOOTPRINT_BLS_VERDICT_CACHE,
        MetricsName.FOOTPRINT_EDGE_CACHE,
        MetricsName.PROCESS_RSS_BYTES,
    }),
}

# MetricsNames deliberately OUTSIDE the fleet view, with the reason the
# lint prints. Process gauges describe the HOST (metrics_report territory,
# meaningless to aggregate across a fleet); transport byte totals are
# per-link volumes whose fleet story the per-type dynamic rows tell.
EXEMPT_METRICS: dict[str, str] = {
    MetricsName.GC_TRACKED_OBJECTS: "host gauge, not a fleet signal",
    MetricsName.GC_GEN2_COLLECTIONS: "host gauge, not a fleet signal",
    MetricsName.GC_UNCOLLECTABLE: "host gauge, not a fleet signal",
    MetricsName.GC_PAUSE_TIME: "host gauge, not a fleet signal",
    MetricsName.NODE_MSGS_IN: "per-link transport volume",
    MetricsName.NODE_FRAMES_OUT: "per-link transport volume",
    MetricsName.TRANSPORT_DROPPED_FRAMES: "per-link transport volume",
    MetricsName.TRANSPORT_DROPPED_SESSIONS: "per-link transport volume",
    MetricsName.TRANSPORT_TX_BYTES: "per-link transport volume",
    MetricsName.TRANSPORT_RX_BYTES: "per-link transport volume",
}


def schema_section_of(name: str) -> Optional[str]:
    for section, names in SNAPSHOT_SCHEMA.items():
        if name in names:
            return section
    return None


class CumulativeDelta:
    """Per-interval deltas over monotone cumulative counters — the
    bookkeeping a telemetry state source needs for its ledger fields
    (sheds, SLO checks/violations). The counter section's flush-rebase
    logic lives in ``_fold_counters``; this is the same consume-on-read
    discipline for source-provided cumulatives, shared so each source
    doesn't hand-roll its own last-seen pairs.

    NOTE: a ``take`` CONSUMES the delta — state sources must be read
    only from the emitter's tick path (one reader), or the next
    snapshot under-reports by whatever the out-of-band read took.
    """

    def __init__(self):
        self._last: dict[str, int] = {}

    def take(self, key: str, current: int) -> int:
        d = current - self._last.get(key, 0)
        self._last[key] = current
        return d


class NullTelemetry:
    """Disabled telemetry: `enabled` is False and every method no-ops.
    Call sites MUST guard with `if telemetry.enabled:` so the disabled
    path costs exactly one attribute check; the methods exist only for
    unguarded cold-path callers (wiring, tests)."""

    enabled = False

    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        pass

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        pass

    def tick(self) -> None:
        pass

    def snapshot(self) -> Optional[dict]:
        return None

    def stop(self) -> None:
        pass


NULL_TELEMETRY = NullTelemetry()


class TelemetryEmitter(NullTelemetry):
    """Periodic snapshot producer for one node.

    `now` is the node's injectable timer clock — the ONE stamp source.
    `metrics` is the node's MetricsCollector; deltas are taken against
    the last-seen (count, sum) per accumulator, and a collector flush
    (count went DOWN) re-bases cleanly: the current fold IS the delta.
    """

    enabled = True

    def __init__(self, node: str, metrics, now: Callable[[], float],
                 config=None, timer=None, spool_dir: Optional[str] = None,
                 ship: Optional[Callable[[dict], None]] = None,
                 tags: Optional[dict] = None, wall_sums: bool = True):
        from plenum_tpu_torch.common.timer import RepeatingTimer
        self.node = node
        # wall_sums=False strips counter sums + sampled percentiles (the
        # perf_counter-derived fields) for record/replay comparisons —
        # the telemetry twin of Tracer.wall_durations
        self.wall_sums = wall_sums
        self.metrics = metrics
        self._now = now
        self.config = config
        self.tags = dict(tags) if tags else None
        self.spool_dir = spool_dir
        self.spool_max = getattr(config, "TELEMETRY_SPOOL_MAX", 64)
        self.ring: deque = deque(
            maxlen=getattr(config, "TELEMETRY_RING", 256))
        self.seq = 0
        self.spooled = 0
        # public wire seam: set to a callable(snapshot) to ship each
        # snapshot off-node (Node.ship_telemetry_to wires this to the
        # best-effort TELEMETRY message; TELEMETRY_SHIP_TO does it
        # from config for TCP pools)
        self.ship = ship
        self._sinks: list[Callable[[dict], None]] = []
        self._sources: dict[str, Callable[[], dict]] = {}
        # name -> (accumulator object, count, sum) at the previous
        # snapshot, for deltas. The OBJECT reference detects collector
        # flushes: KvMetricsCollector.flush() clears the accumulator
        # dict, so a fresh interval means a fresh Accumulator instance —
        # identity comparison re-bases exactly then (a count comparison
        # cannot: a busy post-flush interval can exceed the old total)
        self._last: dict[str, tuple] = {}
        self._tick_timer = None
        if timer is not None:
            self._tick_timer = RepeatingTimer(
                timer, getattr(config, "TELEMETRY_INTERVAL", 1.0),
                self.tick)

    def stop(self) -> None:
        if self._tick_timer is not None:
            self._tick_timer.stop()

    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a live-state contributor; its dict lands under
        snapshot["state"][name]. Sources must read ONLY timer-stamped or
        counter-derived values to keep the stream replay-deterministic."""
        self._sources[name] = fn

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        self._sinks.append(fn)

    # --- snapshot construction -------------------------------------------

    def _fold_counters(self) -> tuple[dict, dict]:
        counters: dict[str, list] = {}
        sampled: dict[str, list] = {}
        for name in sorted(self.metrics.accumulators):
            acc = self.metrics.accumulators[name]
            last_acc, last_n, last_sum = self._last.get(name,
                                                        (None, 0, 0.0))
            if last_acc is not acc:         # collector flushed: re-base
                last_n, last_sum = 0, 0.0
            d_n = acc.count - last_n
            self._last[name] = (acc, acc.count, acc.total)
            if d_n <= 0:
                continue
            d_sum = acc.total - last_sum
            counters[name] = [d_n, round(d_sum, 9)] if self.wall_sums \
                else [d_n]
            if self.wall_sums and acc.samples:
                # the reservoir spans the collector's whole interval, not
                # just this snapshot's — an honest distribution signal,
                # labeled as such (p50/p95 of recent samples)
                sampled[name] = [
                    round(percentile(acc.samples, 0.5), 9),
                    round(percentile(acc.samples, 0.95), 9)]
        return counters, sampled

    def snapshot(self) -> dict:
        counters, sampled = self._fold_counters()
        state: dict[str, dict] = {}
        for name in sorted(self._sources):
            try:
                got = self._sources[name]()
            except Exception:
                # a dying subsystem must not take telemetry (and thus
                # the node) down — but a silently missing section would
                # blind the health fold, so the drop itself is counted
                # and rides the next snapshot's counter deltas
                self.metrics.add_event(MetricsName.TELEMETRY_SOURCE_ERRORS)
                continue
            if got:
                state[name] = got
        snap = {
            "v": SCHEMA_VERSION,
            "node": self.node,
            **({"tags": self.tags} if self.tags else {}),
            "seq": self.seq,
            "t": self._now(),
            "counters": counters,
            "sampled": sampled,
            "state": state,
        }
        self.seq += 1
        return snap

    def tick(self) -> None:
        snap = self.snapshot()
        self.ring.append(snap)
        self.metrics.add_event(MetricsName.TELEMETRY_SNAPSHOTS)
        for sink in self._sinks:
            sink(snap)
        if self.ship is not None:
            try:
                self.ship(snap)
            except Exception:
                pass                # telemetry is best-effort by design
        if self.spool_dir is not None and self.spool_max:
            self._spool(snap)

    def _spool(self, snap: dict) -> None:
        """Rotating numbered window of snapshot files, written atomically
        (tmp+rename — the flight-dump discipline): a console tailing the
        spool never reads a torn snapshot, and the window bounds disk."""
        try:
            os.makedirs(self.spool_dir, exist_ok=True)
            slot = snap["seq"] % self.spool_max
            path = os.path.join(self.spool_dir,
                                f"{self.node}-telemetry-{slot}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(snap, fh, default=repr)
            os.replace(tmp, path)
            self.spooled += 1
        except OSError:
            pass                    # a full disk must not take down the node


def snapshot_bytes(snap: Optional[dict]) -> bytes:
    """Canonical byte serialization of one snapshot — the unit the
    record/replay determinism guard compares byte-for-byte."""
    if snap is None:
        return b""
    return json.dumps(snap, sort_keys=True, separators=(",", ":"),
                      default=repr).encode()


def make_telemetry(node: str, metrics, now, config=None, timer=None,
                   **kw):
    """Config-gated construction seam: TELEMETRY=False -> the shared
    NULL_TELEMETRY (one attribute check per call site, no timer)."""
    if config is not None and not getattr(config, "TELEMETRY", True):
        return NULL_TELEMETRY
    return TelemetryEmitter(node, metrics, now, config=config, timer=timer,
                            **kw)
