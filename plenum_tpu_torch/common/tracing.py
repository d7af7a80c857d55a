"""Per-request tracing plane: span events, flight recorder, clock anchors.

Every request (keyed by its request digest) and every 3PC batch (keyed by
the batch digest) is traced through named span events emitted at each hop
of the pipeline — client ingress, signature verdict, propagate quorum,
pre-prepare send/receive, prepare quorum, commit send, ordering, durable
flush, client reply — plus protocol ANOMALIES (suspicion raised, view
change start/complete, breaker state transitions, catchup trigger). The
correlation key is the digest the protocol already carries end to end, so
tracing needs NO wire-format change: each node records only what it saw,
and `tools/trace_report.py` assembles the per-node dumps into cross-node
latency waterfalls and pool-level critical-path attribution.

Two design constraints shape the implementation:

1. **Disabled cost is one attribute check.** Hot-path call sites guard
   every emission with `if tracer.enabled:`; `NullTracer.enabled` is a
   class attribute `False`, so a pool running untraced pays one LOAD_ATTR
   per site and never builds the event tuple. A microbenchmark assertion
   (tests/test_tracing.py) pins this below 2% of the per-txn budget.

2. **Replay determinism.** Span timestamps come ONLY from the node's
   injectable TimerService clock, and event payloads are derived from
   message content — never from wall reads — so replaying a recorded node
   under a MockTimer reproduces a byte-identical span sequence
   (tests/test_tools.py determinism guard). Wall-clock stage DURATIONS
   (apply/durable perf_counter measurements) are genuinely
   non-deterministic and therefore ride the events only when
   `wall_durations=True` (the default for live pools; replay comparisons
   construct tracers with it off).

The **flight recorder** is the bounded ring itself: the last RING_SIZE
span events + anomalies, dumped to disk automatically when an anomaly is
recorded (debounced) or on demand. Dumps are written atomically
(tmp + rename) so a crash mid-dump never leaves a torn artifact, and the
auto-dump-on-anomaly means the seconds BEFORE a crash/view-change/breaker
trip are already on disk when the postmortem starts.

Clock model: each dump carries (mono_anchor, wall_anchor, clock_domain).
In-process sims share one timer (`clock_domain="shared"`) — alignment is
the identity. TCP pools run one perf_counter epoch per process
(`clock_domain="wall"`) — the anchor pair maps each node's monotonic
times onto the wall clock, and trace_report applies a causality
refinement (a pre-prepare cannot be received before it was sent) on top.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Callable, Optional

# --- span stage names -------------------------------------------------------
# Request-keyed (key = request digest):
INGRESS = "ingress"                  # client request entered the node pipeline
AUTH = "auth"                        # signature verdict landed (data: ok)
PROPAGATE_QUORUM = "propagate_quorum"  # f+1 propagate votes -> finalized
REPLY = "reply"                      # REPLY sent to the client
# Batch-keyed (key = 3PC batch digest; data carries seq + req digests):
PP_SENT = "pp_sent"                  # primary broadcast the PRE-PREPARE
PP_RECV = "pp_recv"                  # replica admitted the PRE-PREPARE
PREPARE_QUORUM = "prepare_quorum"    # n-f matching PREPAREs
COMMIT_SENT = "commit_sent"          # own COMMIT broadcast
ORDERED = "ordered"                  # commit quorum -> Ordered emitted
APPLY = "apply"                      # uncommitted batch apply completed
# Ingress-plane (front door; request-keyed where a digest exists):
ING_ADMIT = "ing_admit"              # request admitted into its client queue
ING_SHED = "ing_shed"                # explicit load-shed reply (data: reason)
# Pool-keyed (key = ""):
ING_AUTH = "ing_auth"                # ingress auth batch dispatched (data: n, sigs)
ING_VERDICT = "ing_verdict"          # ingress auth verdicts landed (data: ok, fail)
ING_CONTROLLER = "ing_controller"    # admission-controller decision (data: knobs)
DURABLE = "durable"                  # group-commit flush closed (data: seqs)
CONTROLLER = "controller"            # batch-controller decision (data: knobs)
CRYPTO_DISPATCH = "crypto_dispatch"  # signature batch dispatched (data: kind)
READ_BATCH = "read_batch"            # read plane served a tick's queries
# fused crypto pipeline (parallel/pipeline.py): one event per resolved
# device wave — submit->pack->dispatch->collect spans (all stamped on the
# pipeline's injectable clock), plus bucket id / item count / pad waste;
# trace_report renders these as the `device` waterfall stage
DEVICE = "device"
DEVICE_CONTROLLER = "device_controller"  # pipeline-controller decision
# sharding plane (shards/): every shard-attributed span carries a
# `shard` tag in its data dict, and shard-hosted node dumps carry a
# top-level `shard` tag (Tracer(tags=...)) so trace_report can group a
# fabric's waterfalls per shard and attribute cross-shard hops
SHARD_ROUTE = "shard_route"          # router decision (data: shard, kind)
CROSS_SHARD = "cross_shard_read"     # verified cross-shard read resolved
#                                      (data: shard, ok, dur, reason)

ANOMALY_PREFIX = "anomaly."

RING_SIZE = 4096


class NullTracer:
    """Disabled tracing: `enabled` is False and every method is a no-op.
    Call sites MUST guard with `if tracer.enabled:` so the disabled path
    costs exactly one attribute check — the methods exist only for
    unguarded cold-path callers (dump plumbing, tests)."""

    enabled = False

    def emit(self, stage: str, key: str, data=None) -> None:
        pass

    def anomaly(self, kind: str, data=None) -> None:
        pass

    def snapshot(self) -> Optional[dict]:
        return None

    def dump(self, path: Optional[str] = None) -> Optional[dict]:
        return None


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Bounded flight-recorder ring of (t, stage, key, data) span events.

    `now` is the node's TimerService clock (sim or perf_counter) — the ONE
    time source for event stamps, keeping recorded runs replayable.
    `wall` (optional, e.g. time.time) is sampled ONCE at construction to
    anchor this node's monotonic timeline onto the wall clock for
    cross-process assembly; it never stamps individual events.
    """

    enabled = True

    def __init__(self, node: str, now: Callable[[], float],
                 ring_size: int = RING_SIZE,
                 dump_dir: Optional[str] = None,
                 clock_domain: str = "shared",
                 wall: Optional[Callable[[], float]] = None,
                 min_dump_interval: float = 5.0,
                 wall_durations: bool = True,
                 tags: Optional[dict] = None):
        self.node = node
        # free-form dump tags (e.g. {"shard": 0}); assembly-side grouping
        # only — individual events stay tag-free so hot-path cost is flat
        self.tags = dict(tags) if tags else None
        self._now = now
        self.ring: deque = deque(maxlen=ring_size)
        self.dump_dir = dump_dir
        self.clock_domain = clock_domain
        self.mono_anchor = now()
        self.wall_anchor = wall() if wall is not None else None
        self.wall_durations = wall_durations
        self.dumps_written = 0
        self.anomalies = 0
        self._min_dump_interval = min_dump_interval
        self._last_auto_dump = float("-inf")

    def emit(self, stage: str, key: str, data=None) -> None:
        self.ring.append((self._now(), stage, key, data))

    def anomaly(self, kind: str, data=None) -> None:
        """Record a protocol anomaly and auto-dump the ring (debounced):
        the last-seconds story must reach disk BEFORE whatever follows the
        anomaly (crash, wedge) can lose it."""
        self.anomalies += 1
        self.emit(ANOMALY_PREFIX + kind, "", data)
        if self.dump_dir is not None:
            now = self._now()
            if now - self._last_auto_dump >= self._min_dump_interval:
                self._last_auto_dump = now
                try:
                    self.dump()
                except OSError:
                    pass            # a full disk must not take down consensus

    def snapshot(self) -> dict:
        """The dump payload: ring contents + the clock anchors assembly
        needs. Events are JSON-ready lists; the ring itself is untouched."""
        return {
            "node": self.node,
            **({"tags": self.tags} if self.tags else {}),
            "clock_domain": self.clock_domain,
            "mono_anchor": self.mono_anchor,
            "wall_anchor": self.wall_anchor,
            "dumped_at": self._now(),
            "anomalies": self.anomalies,
            "events": [list(e) for e in self.ring],
        }

    def dump(self, path: Optional[str] = None) -> dict:
        """Write the snapshot as JSON (atomic tmp+rename — a crash mid-dump
        must never tear an artifact); -> the snapshot dict. With no path
        and no dump_dir the snapshot is only returned."""
        snap = self.snapshot()
        if path is None and self.dump_dir is not None:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"{self.node}-flight-{self.dumps_written}.json")
        if path is not None:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(snap, fh, default=repr)
            os.replace(tmp, path)
            self.dumps_written += 1
        return snap


def make_tracer(node: str, now: Callable[[], float], config=None,
                dump_dir: Optional[str] = None,
                clock_domain: str = "shared",
                wall: Optional[Callable[[], float]] = None):
    """Config-gated construction seam: FLIGHT_RECORDER=False -> the shared
    NullTracer (one attribute check per hot-path site, zero allocations)."""
    if config is not None and not getattr(config, "FLIGHT_RECORDER", True):
        return NULL_TRACER
    ring = getattr(config, "TRACE_RING_SIZE", RING_SIZE) if config else RING_SIZE
    interval = getattr(config, "FLIGHT_DUMP_MIN_INTERVAL", 5.0) \
        if config else 5.0
    return Tracer(node, now, ring_size=ring, dump_dir=dump_dir,
                  clock_domain=clock_domain, wall=wall,
                  min_dump_interval=interval)


def span_sequence(snapshot: Optional[dict]) -> bytes:
    """Canonical byte serialization of a snapshot's span sequence — the
    unit the record/replay determinism guard compares byte-for-byte."""
    if snapshot is None:
        return b""
    return json.dumps(snapshot["events"], sort_keys=True,
                      separators=(",", ":"), default=repr).encode()
