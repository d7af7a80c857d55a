"""Node orchestrator: message pipelines, propagation, ordering, execution.

Reference behavior: plenum/server/node.py (Node:129) — the prod() event loop
(:1037) services client and node inboxes under quotas, validates + propagates
client requests (processRequest:2000, processPropagate:2099), forwards
finalized requests to replicas, executes ordered batches
(processOrdered:2167, executeBatch:2661) and replies to clients
(:2753-2788). Signature checking (verifySignature:2624) happens on every
propagated request on every node.

TPU-first design difference: the pipelines are batch-shaped. Each prod cycle
drains its inbox quota FIRST, then authenticates every pending signature in
ONE batched Ed25519 dispatch (the accumulate-then-flush design of SURVEY.md §7
stage 6), then routes per-request verdicts exactly as the reference's scalar
path would (ack/nack/reject/suspicion).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

from plenum_tpu_torch.catchup import NodeLeecherService, SeederService
from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.internal_messages import (MissingMessage,
                                                 NeedMasterCatchup,
                                                 NeedViewChange,
                                                 NewViewAccepted,
                                                 RaisedSuspicion, ReqKey,
                                                 RequestPropagates,
                                                 VoteForViewChange)
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                             BackupInstanceFaulty,
                                             BatchCommitted,
                                             CatchupRep, CatchupReq,
                                             Commit, ConsistencyProof,
                                             DOMAIN_LEDGER_ID,
                                             LedgerStatus, NewView,
                                             Ordered, POOL_LEDGER_ID,
                                             Prepare, PrePrepare,
                                             Propagate, PropagateBatch,
                                             Reject, Reply,
                                             RequestAck, RequestNack,
                                             Telemetry, ViewChange)
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution.database_manager import (NODE_STATUS_DB_LABEL,
                                                   SEQ_NO_DB_LABEL)
from plenum_tpu_torch.consensus.view_change_trigger_service import \
    InstanceChangeVoteStore
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import RepeatingTimer, TimerService
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.consensus.bls_bft_replica import BlsBftReplica
from plenum_tpu_torch.consensus.replica import Replica, Replicas
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.exceptions import (InvalidClientRequest,
                                             UnauthorizedClientRequest)
from plenum_tpu_torch.execution.write_manager import ThreePcBatch
from plenum_tpu_torch.common.metrics import (KvMetricsCollector, MetricsCollector,
                                       MetricsName)
from plenum_tpu_torch.common import tracing

# footprint gauge key (Node.footprint()) -> flushed MetricsName; the
# schema's "footprint" section and tools/metrics_lint.py cover each name
_FOOTPRINT_METRIC_NAMES = {
    "kv_entries": MetricsName.FOOTPRINT_KV_ENTRIES,
    "kv_disk_bytes": MetricsName.FOOTPRINT_KV_DISK_BYTES,
    "flight_ring_entries": MetricsName.FOOTPRINT_FLIGHT_RING,
    "stashed_entries": MetricsName.FOOTPRINT_STASHED,
    "request_state_entries": MetricsName.FOOTPRINT_REQUEST_STATE,
    "dedup_map_entries": MetricsName.FOOTPRINT_DEDUP_MAP,
    "read_cache_entries": MetricsName.FOOTPRINT_READ_CACHE,
    "vc_vote_entries": MetricsName.FOOTPRINT_VC_VOTES,
    "bls_sig_entries": MetricsName.FOOTPRINT_BLS_SIGS,
    "bls_verdict_cache_entries": MetricsName.FOOTPRINT_BLS_VERDICT_CACHE,
}
from plenum_tpu_torch.node.blacklister import Blacklister
from plenum_tpu_torch.node.bootstrap import NodeComponents
from plenum_tpu_torch.node.message_req_processor import MessageReqProcessor
from plenum_tpu_torch.node.monitor import Monitor
from plenum_tpu_torch.node.notifier import (NotifierEventManager,
                                      TOPIC_VIEW_CHANGE)
from plenum_tpu_torch.node.observer import Observable
from plenum_tpu_torch.node.propagator import Propagator

# Suspicions whose message only the primary can have authored: these implicate
# the primary and become view-change votes rather than blacklistings
# (ref node.py:2854-2944 reportSuspiciousNode).
PRIMARY_FAULT_CODES = frozenset(s.code for s in (
    Suspicions.DUPLICATE_PPR_SENT, Suspicions.PPR_DIGEST_WRONG,
    Suspicions.PPR_REJECT_WRONG, Suspicions.PPR_STATE_WRONG,
    Suspicions.PPR_TXN_WRONG, Suspicions.PPR_TIME_WRONG,
    Suspicions.PPR_BLS_MULTISIG_WRONG, Suspicions.PPR_AUDIT_TXN_ROOT_WRONG))

# Primary-fault subset meaning "the primary's claimed roots don't match
# what we derive locally" — ambiguous between a lying primary and OUR OWN
# divergence. One primary implicated is a vote; f+1 distinct primaries
# implicated without progress means we are the diverged party (see
# Node._note_root_mismatch).
ROOT_MISMATCH_CODES = frozenset(s.code for s in (
    Suspicions.PPR_STATE_WRONG, Suspicions.PPR_TXN_WRONG,
    Suspicions.PPR_BLS_MULTISIG_WRONG, Suspicions.PPR_AUDIT_TXN_ROOT_WRONG))

# Unambiguous peer misbehavior that blacklists the sender. Deliberately tiny:
# digest/BLS mismatches against OUR pre-prepare (PR_DIGEST_WRONG, CM_BLS_WRONG)
# are NOT here — an equivocating primary makes honest peers produce exactly
# those, and blacklisting them would let the primary partition its validators.
BLACKLIST_CODES = frozenset(s.code for s in (
    Suspicions.PPR_FRM_NON_PRIMARY, Suspicions.INVALID_REQ_SIGNATURE))


class LastSentPpStore:
    """Durable {inst_id: (view_no, pp_seq_no)} of the last PRE-PREPARE each
    BACKUP primary on this node sent (ref last_sent_pp_store_helper.py:1).
    The master primary needs no such record — its position is restored from
    the audit ledger — but a restarting backup primary would otherwise
    re-issue pp_seq_no 1 and collide with its shadows' 3PC logs."""

    KEY = b"last_sent_pp"

    def __init__(self, kv):
        self._kv = kv
        # write-through cache: store() fires once per backup batch on the
        # ordering hot path, and a KV get+unpack per call would be a
        # read-modify-write tax for data only this object writes
        self._cur: dict = self._load_from_kv()

    def _load_from_kv(self) -> dict:
        try:
            got = unpack(self._kv.get(self.KEY))
            return got if isinstance(got, dict) else {}
        except Exception:
            return {}

    def store(self, inst_id: int, view_no: int, pp_seq_no: int) -> None:
        self._cur[str(inst_id)] = [view_no, pp_seq_no]
        self._kv.put(self.KEY, pack(self._cur))

    def load_raw(self) -> dict:
        return dict(self._cur)

    def erase(self) -> None:
        self._cur = {}
        try:
            self._kv.remove(self.KEY)
        except KeyError:
            pass


class Node:
    def __init__(self, name: str, timer: TimerService, node_bus: ExternalBus,
                 components: NodeComponents,
                 client_send: Optional[Callable[[Any, str], None]] = None,
                 config: Optional[Config] = None,
                 instance_count: Optional[int] = None,
                 metrics: Optional[MetricsCollector] = None,
                 tracer=None):
        self.name = name
        self.timer = timer
        self.node_bus = node_bus
        self.config = config or Config()
        self.c = components
        self._client_send = client_send or (lambda msg, client: None)
        self.started_at = timer.get_current_time()
        # tracing plane (common/tracing.py): span events at every pipeline
        # hop + protocol anomalies, in a bounded flight-recorder ring.
        # Every emission below is guarded by `tracer.enabled` so the
        # default NullTracer costs one attribute check per site.
        self.tracer = tracer if tracer is not None else tracing.NULL_TRACER
        if self.config.GC_SERVER_TUNING:
            from plenum_tpu_torch.common.metrics import tune_gc_for_server
            tune_gc_for_server()

        # named-metric accumulators (ref common/metrics_collector.py:331);
        # KV-backed collectors get a periodic flush so history survives
        self.metrics = metrics or MetricsCollector()
        if isinstance(self.metrics, KvMetricsCollector):
            self._metrics_flush_timer = RepeatingTimer(
                timer, self.config.METRICS_FLUSH_INTERVAL,
                self._flush_metrics)
            # queue depths are sampled well below the flush cadence so the
            # flushed fold's max/mean reflect depth UNDER load, not the
            # drained snapshot at flush time (ref node.py:2289 dumps queue
            # gauges the same way)
            self._gauge_sample_timer = RepeatingTimer(
                timer, self.config.QUEUE_GAUGE_SAMPLE_INTERVAL,
                self._sample_queue_gauges)
        # shared crypto plane reports through the last-attached collector
        # (fill latency, dispatch wall time, batch size)
        verifier = getattr(components.authenticator.core_authenticator,
                           "verifier", None)
        if hasattr(verifier, "metrics"):
            verifier.metrics = self.metrics
        # breaker state transitions are protocol anomalies: the flight
        # recorder must hold the device-plane story of the seconds before
        # a fuzz failure or view change (co-hosted nodes share one plane;
        # the last-attached tracer records for the host, same convention
        # as the shared plane's metrics hook above)
        if self.tracer.enabled:
            from plenum_tpu_torch.parallel.supervisor import find_supervisor
            sup = find_supervisor(verifier)
            if sup is not None:
                sup.breaker.on_transition = (
                    lambda old, new: self.tracer.anomaly(
                        "breaker", {"from": old, "to": new}))
        # fused crypto pipeline: the last-attached node's tracer records
        # the shared ring's `device` wave spans (same convention as the
        # shared plane's metrics hook above), and the ring's flush window
        # + controller run on this node's injectable clock so sims and
        # replays steer identically
        if components.pipeline is not None:
            components.pipeline.set_clock(timer.get_current_time)
            if self.tracer.enabled:
                components.pipeline.tracer = self.tracer
        # commit-wave stage timer (execution/write_manager.py): the
        # drain's wave duration feeds commit_wave_ms_p50/p95
        components.write_manager.metrics = self.metrics

        self.pool_manager = components.pool_manager
        self.pool_manager._on_changed = self._on_pool_changed
        self.on_pool_changed_callbacks: list[Callable[[], None]] = []
        self.validators = self.pool_manager.node_names or [name]
        self.quorums = self.pool_manager.quorums

        # suspicions → blacklist, and sender-is-a-validator, both enforced
        # at bus ingress so no service ever sees traffic from a blacklisted
        # or non-member peer — otherwise a demoted/unknown sender's votes
        # would still count toward 3PC/checkpoint/propagate quorums
        # (ref server/blacklister.py + validateNodeMsg sender checks).
        # EXCEPTION (membership churn): catchup QUERIES — LedgerStatus
        # asks and CatchupReq range fetches — are admitted from any node
        # the POOL LEDGER knows even while it is not a validator, so a
        # joining/rejoining node can sync before promotion. Only the
        # query side passes: replies and votes from non-validators stay
        # filtered, so they can never feed a cons-proof or 3PC quorum.
        self.blacklister = Blacklister(
            ttl=self.config.BLACKLIST_TTL, now=timer.get_current_time)
        self.node_bus.set_incoming_filter(
            lambda frm: frm in self.validators
            and not self.blacklister.is_blacklisted(frm),
            accept_msg=self._accept_joiner_msg)

        self.propagator = Propagator(
            name, self.quorums,
            send_to_nodes=lambda msg: self.node_bus.send(msg),
            forward_to_replicas=self._forward_to_replicas,
            now=timer.get_current_time,
            validators=lambda: self.validators,
            request_body=self._request_body,
            digest_gossip=self.config.DIGEST_GOSSIP,
            tracer=self.tracer)
        # digest -> targeted body-fetch tries so far (digest-gossip: a
        # quorum can complete before any body-carrying propagate arrives)
        self._body_fetches: dict[str, int] = {}

        # verified read plane (reads/plane.py): proof envelopes + a
        # per-signed-root result cache in front of the read manager; its
        # anchors advance from the commit path and from (possibly late)
        # multi-sig aggregation (_make_replica wires bls.on_multi_sig).
        # The domain ledger's tree hasher is reused so envelope digests
        # batch through the configured (possibly device-backed) SHA-256.
        from plenum_tpu_torch.reads import ReadPlane
        domain_ledger = self.c.db.get_ledger(DOMAIN_LEDGER_ID)
        self.read_plane = ReadPlane(
            self.c.db, self.c.read_manager, metrics=self.metrics,
            hasher=domain_ledger.hasher if domain_ledger else None,
            tracer=self.tracer)

        # closed-loop batch controller (consensus/batch_controller.py):
        # steers batch size / wait / in-flight depth / group-commit
        # coalescing from timer-stamped stage samples; one per node,
        # wired into the MASTER ordering service and the drain loop below
        from plenum_tpu_torch.consensus.batch_controller import make_controller
        self.batch_controller = make_controller(
            self.config, timer, tracer=self.tracer, metrics=self.metrics)

        # one network RTT estimate for the whole node (common/backoff.py):
        # fed by catchup round trips, read by catchup retry pacing AND the
        # view-change escalation timeout — both must agree on what "slow"
        # means on this link before either declares anything dead
        from plenum_tpu_torch.common.backoff import RttEstimator
        self.catchup_rtt = RttEstimator()

        # RBFT: f+1 protocol instances by default (ref replicas.py:19),
        # recomputed as pool membership changes f; an explicit
        # instance_count PINS the count (BASELINE config 2 runs 3)
        self._pinned_instances = instance_count
        n_inst = self._n_instances()
        status_kv = self.c.db.get_store(NODE_STATUS_DB_LABEL)
        self._last_sent_pp = \
            LastSentPpStore(status_kv) if status_kv is not None else None
        self.replicas = Replicas(self._make_replica)
        self.replicas.grow_to(n_inst)

        # audit txns snapshot the current primaries + node reg
        # (ref audit_batch_handler.py:83-231). The registry MUST come from
        # UNCOMMITTED pool state — the registry at this batch's position in
        # the chain — never from the committed view (`self.validators`):
        # with a deep in-flight window, a NODE txn can sit applied-but-
        # uncommitted under later batches, and commit-time registries
        # differ node to node (one commits the NODE txn before applying
        # batch B, another applies B speculatively first), forking the
        # audit root of the SAME batch (churn soak: committed audit
        # prefixes conflicting beyond append-repair)
        components.write_manager._primaries_provider = (
            lambda: list(self.replicas.master.data.primaries))

        def uncommitted_node_reg():
            from plenum_tpu_torch.execution.handlers.node import VALIDATOR
            reg = [rec.get("alias", dest) for dest, rec
                   in self.c.node_handler.all_nodes(committed=False).items()
                   if VALIDATOR in rec.get("services", [VALIDATOR])]
            return sorted(reg) or [name]
        components.write_manager._node_reg_provider = uncommitted_node_reg

        # highest pp_seq_no this node has executed (via ordering OR catchup);
        # an Ordered re-emitted for a re-certified batch must not double-commit
        self._last_executed_pp_seq = 0
        # pipelined signature verification: one in-flight device dispatch per
        # pipeline; while a dispatch is computing, the prod loop keeps doing
        # consensus work instead of blocking on the device round-trip
        # (accumulate-then-flush, SURVEY.md §7 stage 6). After MAX_AUTH_POLLS
        # unproductive polls the collect BLOCKS: prod loops that spin faster
        # than the device computes (MockTimer sims) must not starve the
        # pipeline forever, and a wedged dispatch must surface, not hang the
        # inbox silently.
        self.MAX_AUTH_POLLS = 50
        self._auth_inflight = None      # (token, items, polls)
        self._prop_inflight = None
        # inboxes (quota-drained each prod; ref zstack quotas config.py:250)
        self._client_inbox: list[tuple[dict, str]] = []
        self._propagate_inbox: list[tuple[Propagate, str]] = []
        self._ordered_queue: list[Ordered] = []
        # digest -> {sender: body_seen}: which propagates we already counted
        # per sender, and whether that sender has delivered a BODY yet (a
        # digest-only vote may legitimately be followed by the same peer's
        # body-carrying MessageRep fetch reply — that upgrade must not be
        # dropped as a duplicate). The whole entry is freed when the request
        # executes (durable dedup then lives in the seq-no DB keyed by
        # payload digest).
        self._seen_propagates: dict[str, dict[str, bool]] = {}
        # digest -> entries parked while that digest's signature dispatch
        # is in flight (client or propagate path): each node verifies a
        # given request's signature at most once per arrival wave. Entries
        # are ("prop", Propagate, frm) — peers' propagates that become
        # votes on the landed verdict — or ("client", Request, frm) — the
        # client's own copy racing a peer's dispatch. Popped at verdict.
        self._authing: dict[str, list[tuple]] = {}

        # catchup: seeder answers peers; leecher drives our own sync
        # (ref ledger_manager.py:21 + server/catchup/*)
        self.seeder = SeederService(
            components.db, send=self.node_bus.send,
            last_3pc=lambda: self.master_replica.last_ordered_3pc)
        self.leecher = NodeLeecherService(
            components.db, send=self.node_bus.send, timer=timer,
            quorums_provider=lambda: self.quorums,
            peers_provider=lambda: [n for n in self.validators
                                    if n != self.name],
            on_txn_added=self._on_catchup_txn,
            on_catchup_complete=self._on_catchup_complete,
            config=self.config, salt=name, rtt=self.catchup_rtt)
        # catchup progress watchdog: a stalled round (frozen progress key
        # across one interval) gets kicked — forced provider rotation +
        # immediate re-request; repeated kicks restart the round outright.
        # Paired with graceful degradation: rounds that keep ending in
        # divergence park the node in READ-ONLY mode (ordering stays
        # paused, the verified reads keep serving at the last anchored
        # root) instead of a silent retry-forever wedge.
        self._catchup_started_at: Optional[float] = None
        self._catchup_progress_mark = None
        self._catchup_kicks = 0
        self._diverged_rounds = 0
        self.read_only_degraded = False
        self._read_only_reason: Optional[str] = None
        self._catchup_watchdog_timer = RepeatingTimer(
            timer, self.config.CATCHUP_WATCHDOG_INTERVAL,
            self._catchup_watchdog)
        self.node_bus.subscribe(LedgerStatus, self._receive_ledger_status)
        self.node_bus.subscribe(ConsistencyProof,
                                self.leecher.process_consistency_proof)
        self.node_bus.subscribe(CatchupReq, self.seeder.process_catchup_req)
        self.node_bus.subscribe(CatchupRep, self.leecher.process_catchup_rep)

        self.node_bus.subscribe(Propagate, self._receive_propagate)
        self.node_bus.subscribe(PropagateBatch, self._receive_propagate_batch)
        # "ask peers for a missing message" (ref message_req_processor.py:13)
        self.message_req = MessageReqProcessor(self)
        # observers are remote followers addressed like clients
        # (ref server/observer/observable.py:11; push in _execute_batch)
        self.observable = Observable(send=self._client_send)
        from collections import deque
        self.spylog: Any = deque(maxlen=1000)      # bounded event trace

        # periodic GC of request state that never reached the propagate
        # quorum — without it spam propagates leak memory forever
        # (ref node.py _clean_req cleanup on OUTDATED_REQS_CHECK_INTERVAL)
        self._outdated_reqs_timer = RepeatingTimer(
            timer, self.config.OUTDATED_REQS_CHECK_INTERVAL,
            self._clean_outdated_reqs)

        # RBFT monitor: compare master vs backup instances, vote out a
        # degraded master (ref monitor.py:136, node.checkPerformance:2501)
        self.monitor = Monitor(self.config, now=timer.get_current_time)
        # ops notifications: throughput spikes + view changes fan out to
        # registered handlers (ref server/notifier_plugin_manager.py)
        self.notifier = NotifierEventManager(
            bounds_coeff=self.config.NOTIFIER_SPIKE_BOUNDS_COEFF,
            min_cnt=self.config.NOTIFIER_SPIKE_MIN_CNT,
            min_activity_threshold=self.config.NOTIFIER_SPIKE_MIN_ACTIVITY,
            enabled=self.config.NOTIFIER_EVENTS_ENABLED)
        self._perf_check_timer = RepeatingTimer(
            timer, self.config.PerfCheckFreq, self.check_performance)

        # faulty BACKUP instances: a backup that stops ordering while work
        # is pending poisons the monitor's master-vs-backup comparison; an
        # f+1 quorum of BackupInstanceFaulty removes it, and the next view
        # change re-adds it fresh (ref backup_instance_faulty_processor.py
        # + node.py:2580-2596)
        self.node_bus.subscribe(BackupInstanceFaulty,
                                self._process_backup_faulty)
        self._backup_wedge_markers: dict[int, tuple[tuple, float]] = {}
        self._backup_faulty_votes: dict[tuple[int, int], set[str]] = {}
        self._removed_backups: set[int] = set()
        self._backup_check_timer = RepeatingTimer(
            timer, self.config.BACKUP_INSTANCE_FAULTY_CHECK_FREQ,
            self._check_backup_instances)

        # quorum-connectivity self-check (ref inconsistency_watchers.py:5):
        # having once seen strong-quorum connectivity, dropping below weak
        # quorum means we cannot distinguish pool failure from our own
        # partition — resynchronize via catchup when connectivity returns
        from plenum_tpu_torch.node.inconsistency_watcher import \
            NetworkInconsistencyWatcher
        self.network_watcher = NetworkInconsistencyWatcher(
            self._on_lost_quorum_connectivity, network=self.node_bus)
        self.network_watcher.set_nodes(self.validators)
        self._needs_resync = False
        self.node_bus.subscribe(ExternalBus.Connected,
                                self._maybe_resync_after_partition)
        # straggler self-check: a node stuck in an old view while the pool
        # moved on (it was mid-catchup through the view change; its lone
        # InstanceChange vote can never reach quorum, and below CHK_FREQ
        # no checkpoint-lag signal exists) would wait forever on stashed
        # FUTURE_VIEW messages. Once f+1 DISTINCT peers are seen talking
        # in higher views, the pool has provably moved on without us:
        # resync via catchup, which adopts the audit ledger's view (found
        # by the partition-heal fuzz; ref: the f+1 future-view lag checks
        # in the reference's message stashing/CurrentState handling).
        self._ahead_views: dict[str, int] = {}
        self._straggler_fired_view = -1
        self._straggler_fired_at = float("-inf")
        for mt in (PrePrepare, Prepare, Commit, ViewChange, NewView):
            self.node_bus.subscribe(mt, self._note_peer_view)
        # seq-lag twin of the view-lag check: a commit quorum sitting
        # ahead of a position that made no progress across one interval
        self._behind_marker: Optional[int] = None
        # divergence self-check: distinct primaries whose pre-prepares WE
        # rejected for root mismatches since our last ordering progress.
        # f+1 distinct primaries contain an honest one, so at that point
        # the diverged party is provably us, not them — resync (found by
        # the churn soak: a node whose uncommitted state diverged during
        # a view-change storm rejected every subsequent batch — no
        # commits recorded, so behind_evidence stayed None — and wedged
        # at its last ordered position while voting endless suspicions)
        self._divergence_primaries: set = set()
        self._divergence_fired_at = float("-inf")
        # view-change storm self-check (config.VC_STORM_RESYNC_STARTS):
        # consecutive view-change starts with no completion between them.
        # A storm no escalation can end usually means primary selection
        # itself diverges — a membership txn (demotion, removal) committed
        # on part of the pool while OUR pool ledger still lacks it, so
        # every view we propose names a different primary than our peers'
        # (flood+demotion churn fuzz: a 2v2 registry split left no view
        # able to gather a NEW_VIEW quorum, ever). The cure is a pool-
        # ledger resync, not another vote.
        self._vc_starts_streak = 0
        self._vc_resync_fired_at = float("-inf")
        self._behind_check_timer = RepeatingTimer(
            timer, self.config.STUCK_BEHIND_CHECK_FREQ,
            self._check_stuck_behind)
        # VC stall decomposition: detection stamp on primary disconnect
        self._vc_phase_ts: dict[str, float] = {}
        self.node_bus.subscribe(
            ExternalBus.Disconnected,
            lambda m, frm="": self._vc_mark("detect")
            if m.name == self.master_replica.data.primary_name else None)

        # crash-restart: a node rebuilt over durable storage resumes at the
        # audit ledger's 3PC position and primaries instead of view 0 / seq 0
        # (ref node.py:1830,1875 — the same restore catchup applies later)
        self._restore_3pc_from_audit()
        self._restore_backup_last_sent_pp()

        # live fleet telemetry (observability/snapshot.py): a periodic
        # replay-deterministic snapshot of this node's counters + health
        # state on the injectable timer. Disabled (TELEMETRY=False) this
        # is the shared NULL_TELEMETRY — one attribute check per call
        # site, no timer registered. Other subsystems (IngressPlane, the
        # sharded fabric) add their own sources/sinks after construction.
        from plenum_tpu_torch.observability import CumulativeDelta, make_telemetry
        self.telemetry = make_telemetry(
            name, self.metrics, timer.get_current_time, config=self.config,
            timer=timer)
        if self.telemetry.enabled:
            self._telemetry_deltas = CumulativeDelta()
            self.telemetry.add_source("node", self._telemetry_node_state)
            self.telemetry.add_source("crypto", self._telemetry_crypto_state)
            self.telemetry.add_source("footprint",
                                      self._telemetry_footprint_state)
            if self.c.pipeline is not None:
                self.telemetry.add_source(
                    "pipeline", self._telemetry_pipeline_state)
            ship_to = getattr(self.config, "TELEMETRY_SHIP_TO", "")
            if ship_to and ship_to != name:
                self.ship_telemetry_to(ship_to)
        # inbound TELEMETRY snapshots (best-effort) feed an
        # attached FleetAggregator; without one they drop on the floor
        self.fleet_aggregator = None
        self.node_bus.subscribe(Telemetry, self._receive_telemetry)

        # built-in actions need the finished node (ref validator_info_tool)
        from plenum_tpu_torch.execution.action_manager import ValidatorInfoAction
        self.action_manager = components.action_manager
        if self.action_manager is not None:
            self.action_manager.register_handler(ValidatorInfoAction(self))

        # plugins get the finished node last (ref plugin init hooks)
        from plenum_tpu_torch.plugins import init_plugins
        init_plugins(self, getattr(components, "plugins", []))

    def _restore_3pc_from_audit(self) -> None:
        from plenum_tpu_torch.execution.handlers import audit as audit_lib
        audit = self.c.db.get_ledger(AUDIT_LEDGER_ID)
        view_no, pp_seq_no, primaries = audit_lib.last_audited_view(audit)
        if (view_no, pp_seq_no) == (0, 0):
            return
        for replica in self.replicas:
            replica.data.view_no = view_no
            if primaries:
                replica.data.primaries = list(primaries)
            replica.ordering.caught_up_till_3pc(
                (view_no, pp_seq_no) if replica.is_master
                else replica.last_ordered_3pc)
        # the duplicate-Ordered execution guard must survive restart too
        self._last_executed_pp_seq = max(self._last_executed_pp_seq,
                                         pp_seq_no)
        # persisted InstanceChange votes were loaded against view 0; now
        # that the audited view is known, retire proposals it supersedes
        trigger = self.master_replica.vc_trigger
        if trigger is not None:
            trigger.purge_stale()
        self.spylog.append(("restored_from_audit", (view_no, pp_seq_no)))

    def _restore_backup_last_sent_pp(self) -> None:
        """Resume each backup primary at its persisted last-sent seq-no
        (ref last_sent_pp_store_helper.try_restore_last_sent_pp_seq_no):
        only for instances where this node IS the primary, only when the
        stored view matches the restored view — a row from an older view is
        stale (numbering restarted) and is dropped."""
        if self._last_sent_pp is None:
            return
        stored = self._last_sent_pp.load_raw()
        if not stored:
            return
        stale = False
        survivors: list[tuple[int, int, int]] = []
        for inst_str, pair in stored.items():
            try:
                inst_id, (view_no, pp_seq_no) = int(inst_str), pair
            except (ValueError, TypeError):
                stale = True
                continue
            if inst_id == 0 or inst_id not in self.replicas:
                stale = True
                continue
            data = self.replicas[inst_id].data
            if view_no != data.view_no or not data.is_primary:
                stale = True
                continue
            data.pp_seq_no = max(data.pp_seq_no, pp_seq_no)
            data.last_ordered_3pc = max(data.last_ordered_3pc,
                                        (view_no, pp_seq_no))
            survivors.append((inst_id, view_no, pp_seq_no))
            self.spylog.append(("restored_backup_pp", (inst_id, pp_seq_no)))
        if stale:
            # rewrite exactly the rows the restore loop accepted — a dead
            # row (wrong view OR not primary here) must not resurrect
            self._last_sent_pp.erase()
            for inst_id, view_no, pp_seq_no in survivors:
                self._last_sent_pp.store(inst_id, view_no, pp_seq_no)

    def _sample_queue_gauges(self) -> None:
        self.metrics.add_event(MetricsName.CLIENT_INBOX_DEPTH,
                               len(self._client_inbox))
        self.metrics.add_event(MetricsName.PROPAGATE_INBOX_DEPTH,
                               len(self._propagate_inbox))
        self.metrics.add_event(
            MetricsName.REQUEST_QUEUE_DEPTH,
            sum(len(q) for q in
                self.master_replica.ordering.request_queues.values()))

    def _sample_crypto_gauges(self) -> None:
        """Pairing accounting + device-plane dispatch counters as cumulative
        gauges (read back via max, like gc_pause_time). PAIRING_STATS is
        process-wide — per-node exactness holds in the one-process-per-node
        topology the flushed history exists for."""
        from plenum_tpu_torch.crypto.bn254 import PAIRING_STATS
        self.metrics.add_event(MetricsName.BLS_PAIRING_CHECKS,
                               PAIRING_STATS["checks"])
        self.metrics.add_event(MetricsName.BLS_PAIRINGS,
                               PAIRING_STATS["pairings"])
        self.metrics.add_event(MetricsName.BLS_PAIRINGS_NATIVE,
                               PAIRING_STATS["native"])
        # ShardedTorchEd25519Verifier.dispatches, possibly wrapped by the
        # CoalescingVerifier (walk one level of ._inner)
        verifier = getattr(self.c.authenticator.core_authenticator,
                           "verifier", None)
        for obj in (verifier, getattr(verifier, "_inner", None)):
            dispatches = getattr(obj, "dispatches", None)
            if dispatches is not None:
                self.metrics.add_event(MetricsName.SIG_PLANE_DISPATCHES,
                                       dispatches)
                break
        # plane supervisor: breaker state gauge + fallback/hedge/deadline
        # cumulative counters + the dispatch-budget distribution — the
        # degraded-mode story must be VISIBLE in the flushed history
        # (docs/robustness.md "Degraded modes of the crypto plane")
        from plenum_tpu_torch.parallel.supervisor import find_supervisor
        sup = find_supervisor(verifier)
        if sup is not None:
            st = sup.supervisor_stats()
            self.metrics.add_event(MetricsName.CRYPTO_BREAKER_STATE,
                                   st["breaker_state_code"])
            self.metrics.add_event(MetricsName.CRYPTO_BREAKER_OPENS,
                                   st["breaker_opens"])
            self.metrics.add_event(MetricsName.CRYPTO_FALLBACK_BATCHES,
                                   st["fallback_batches"])
            self.metrics.add_event(MetricsName.CRYPTO_FALLBACK_ITEMS,
                                   st["fallback_items"])
            self.metrics.add_event(MetricsName.CRYPTO_HEDGE_WINS,
                                   st["hedge_wins"])
            self.metrics.add_event(MetricsName.CRYPTO_DEADLINE_MISSES,
                                   st["deadline_misses"])
            for budget_s in sup.drain_budget_samples():
                self.metrics.add_event(MetricsName.CRYPTO_DISPATCH_BUDGET,
                                       budget_s)
        # BLS plane health: combined-check fallbacks (process-wide) and,
        # with the service plane, local-IPC fallback counts
        from plenum_tpu_torch.crypto.bls import BATCH_STATS
        self.metrics.add_event(MetricsName.BLS_BATCH_FALLBACKS,
                               BATCH_STATS["fallbacks"])
        bls = getattr(self.replicas.master, "bls", None)
        bls_stats = getattr(getattr(bls, "_verifier", None), "stats", None)
        if isinstance(bls_stats, dict) and "local_fallbacks" in bls_stats:
            self.metrics.add_event(MetricsName.BLS_LOCAL_FALLBACKS,
                                   bls_stats["local_fallbacks"])
        # read-plane health as cumulative gauges (read back via max):
        # cache effectiveness + the proofless rate an operator watches —
        # proofless replies are the ones that cost clients an f+1 fanout
        rp = self.read_plane.stats
        self.metrics.add_event(MetricsName.READ_CACHE_HITS,
                               rp["cache_hits"])
        self.metrics.add_event(MetricsName.READ_PROOFS_STATE,
                               rp["proofs_state"])
        self.metrics.add_event(MetricsName.READ_PROOFS_MERKLE,
                               rp["proofs_merkle"])
        self.metrics.add_event(MetricsName.READ_PROOFS_VERKLE,
                               rp["proofs_verkle"])
        self.metrics.add_event(MetricsName.READ_PROOFLESS,
                               rp["proofless"])
        self.metrics.add_event(MetricsName.READ_ANCHOR_UPDATES,
                               rp["anchor_updates"])
        # fused crypto pipeline: dispatch/dedup/bucket gauges (the ring is
        # shared, so like PAIRING_STATS these are host-wide figures)
        if self.c.pipeline is not None:
            self.c.pipeline.sample_metrics(self.metrics)

    # --- live fleet telemetry (observability/) ---------------------------

    def _telemetry_node_state(self) -> dict:
        """The node's live health gauges for the telemetry snapshot's
        state section. Everything here derives from counters or the
        injectable timer — no wall reads — so a replayed node emits a
        byte-identical snapshot stream."""
        master = self.master_replica.data
        domain = self.c.db.get_ledger(DOMAIN_LEDGER_ID)
        out = {
            "ordered_total": (domain.size - 1) if domain is not None else 0,
            "view_no": master.view_no,
            "vc_in_progress": bool(master.waiting_for_new_view),
            "catchup_running": bool(self.leecher.is_running),
            "read_only_degraded": bool(self.read_only_degraded),
            "validators": len(self.validators),
        }
        anchor = self.read_plane.anchor_for(DOMAIN_LEDGER_ID)
        if anchor is not None:
            out["anchor_age"] = round(
                max(0.0, self.timer.get_current_time()
                    - anchor.ms.value.timestamp), 6)
        # batch-SLO ledger deltas (controller decisions vs BATCH_SLO_P95)
        ctl = self.batch_controller
        if ctl is not None:
            d_v = self._telemetry_deltas.take("slo_v", ctl.slo_violations)
            d_n = self._telemetry_deltas.take("slo_n", ctl.slo_checks)
            if d_n > 0:
                out["slo"] = [d_v, d_n]
        return out

    def _telemetry_crypto_state(self) -> dict:
        """Crypto-plane breaker state in its own section so the
        aggregator's health fold reads one canonical key."""
        from plenum_tpu_torch.parallel.supervisor import find_supervisor
        verifier = getattr(self.c.authenticator.core_authenticator,
                           "verifier", None)
        sup = find_supervisor(verifier)
        if sup is None:
            return {}
        return {"breaker_state": sup.breaker.state,
                "fallback_batches": sup.stats.get("fallback_batches", 0)}

    def _telemetry_pipeline_state(self) -> dict:
        pipe = self.c.pipeline
        if pipe is None:
            return {}
        st = pipe.stats
        dispatches = st.get("dispatches", 0)
        out = {
            "occupancy": pipe.occupancy(),
            "dispatches": dispatches,
            "bucket_hit_rate": round(
                st.get("bucket_hits", 0) / dispatches, 3)
            if dispatches else None,
        }
        # multi-device ring: per-chip lane gauges so the fleet console
        # can show WHICH chip is sick (breaker per lane), plus the open
        # count the aggregator's health fold reads
        devices = pipe.device_state()
        if devices:
            out["devices"] = devices
            out["breakers_open"] = sum(
                1 for d in devices
                if d.get("breaker") not in ("closed", "none"))
        return out

    def footprint(self) -> dict:
        """Size-now of every bounded in-memory/on-disk structure — the
        resource-footprint gauges the fleet history plane fits growth
        trends over (observability/history.py), and the ONE inventory
        the soaks assert bounded growth through. Every value is an
        integer size, deterministic given the same ordered stream —
        except the two wall/host-derived gauges the telemetry source
        strips under ``wall_sums=False``."""
        out = {"kv_entries": 0, "kv_disk_bytes": 0}
        for kv in self.c.db.iter_kv_stores():
            try:
                size = kv.size
                out["kv_entries"] += int(size() if callable(size) else size)
            except Exception:
                pass
            path = getattr(kv, "_file_path", None)
            if path:
                try:
                    out["kv_disk_bytes"] += os.path.getsize(path)
                except OSError:
                    pass
        out["flight_ring_entries"] = (
            len(self.tracer.ring) if self.tracer.enabled else 0)
        stashed = 0
        for replica in self.replicas:
            for svc in (replica.ordering, replica.checkpointer,
                        replica.view_changer):
                stasher = getattr(svc, "_stasher", None)
                if stasher is not None:
                    stashed += sum(len(q) for q in stasher._queues.values())
                    stashed += len(stasher.discarded)
        out["stashed_entries"] = stashed
        out["request_state_entries"] = len(self.propagator.requests)
        out["dedup_map_entries"] = len(self._seen_propagates)
        out["read_cache_entries"] = sum(
            len(s) for s in self.read_plane._cache.values())
        vcs = self.master_replica.view_changer
        votes = sum(len(d) for d in vcs._view_changes.values())
        trigger = self.master_replica.vc_trigger
        if trigger is not None:
            votes += sum(len(d) for d in trigger._votes.values())
        out["vc_vote_entries"] = votes
        bls = self.master_replica.bls
        out["bls_sig_entries"] = (
            len(bls._sigs) + len(bls._pending_order)
            if bls is not None else 0)
        # process-wide verdict cache: real size, but NOT per-run
        # deterministic (shared across every node in the process)
        from plenum_tpu_torch.crypto.bls import _BLS_VERDICTS
        out["bls_verdict_cache_entries"] = len(_BLS_VERDICTS)
        return out

    def _telemetry_footprint_state(self) -> dict:
        """Footprint gauges for the snapshot's state section. Under
        ``wall_sums=False`` (record/replay comparisons) the host- and
        process-derived gauges are stripped — RSS reads the HOST and the
        BLS verdict cache is process-wide across nodes — so the replayed
        stream stays byte-identical; everything left derives from the
        ordered stream alone."""
        out = self.footprint()
        if getattr(self.telemetry, "wall_sums", True):
            from plenum_tpu_torch.common.metrics import process_rss_bytes
            rss = process_rss_bytes()
            if rss is not None:
                out["process_rss_bytes"] = rss
        else:
            out.pop("bls_verdict_cache_entries", None)
        return out

    def _sample_footprint_gauges(self) -> None:
        """Footprint sizes as ordinary metric events at flush cadence, so
        the on-disk metrics history carries the same growth story the
        live telemetry plane trends (footprint.* names, lint-covered)."""
        fp = self.footprint()
        for key, name in _FOOTPRINT_METRIC_NAMES.items():
            if key in fp:
                self.metrics.add_event(name, fp[key])

    def attach_fleet_aggregator(self, aggregator) -> None:
        """Route inbound TELEMETRY snapshots (and this node's own) into
        `aggregator` — the seam fleet_console/tests/fabrics use to host
        the pool-wide view on one designated node."""
        self.fleet_aggregator = aggregator
        if self.telemetry.enabled:
            self.telemetry.add_sink(aggregator.ingest)

    def ship_telemetry_to(self, peer: str) -> None:
        """Ship this node's snapshots to `peer` as the best-effort
        TELEMETRY wire message — the production counterpart of
        attach_fleet_aggregator: every other node ships to the node
        hosting the aggregator (TELEMETRY_SHIP_TO wires this from
        config at construction)."""
        if self.telemetry.enabled:
            self.telemetry.ship = lambda snap: self.node_bus.send(
                Telemetry(snapshot=snap), peer)

    def _receive_telemetry(self, msg: Telemetry, frm: str) -> None:
        if self.fleet_aggregator is None:
            return
        # bind the snapshot to the AUTHENTICATED sender: one byzantine
        # peer must not overwrite another node's health story (a forged
        # healthy "Alpha" stream would mask Alpha's real outage)
        if msg.snapshot.get("node") != frm:
            return
        self.fleet_aggregator.ingest(msg.snapshot)

    def _flush_metrics(self) -> None:
        """Sample process RSS/GC gauges + one last queue sample, then flush
        accumulators to the KV store. The in-flush flag lets signal
        handlers (start_node's SIGTERM tail-flush) skip the call instead
        of re-entering a KV append already on the stack."""
        self._in_metrics_flush = True
        try:
            from plenum_tpu_torch.common.metrics import sample_process_gauges
            sample_process_gauges(self.metrics)
            self._sample_queue_gauges()
            self._sample_crypto_gauges()
            self._sample_footprint_gauges()
            self.metrics.flush()
        finally:
            self._in_metrics_flush = False

    def check_performance(self) -> None:
        if self.leecher.is_running:
            return
        self.notifier.check_throughput(
            self.monitor.master_throughput(), self.name,
            self.timer.get_current_time())
        if self.monitor.is_master_degraded():
            self.spylog.append(("master_degraded", self.monitor.stats()))
            self.replicas.master.internal_bus.send(
                VoteForViewChange(
                    suspicion_code=Suspicions.PRIMARY_DEGRADED.code))
            # history is void once we've called for a new master
            self.monitor.reset()

    def _check_backup_instances(self) -> None:
        """Detect wedged BACKUP instances: queued work but no 3PC progress
        for BACKUP_INSTANCE_FAULTY_TIMEOUT -> broadcast a
        BackupInstanceFaulty vote (and count our own). The master has its
        own watchdog (PrimaryHealthService) — view change, not removal."""
        now = self.timer.get_current_time()
        master = self.replicas.master.data
        if (self.leecher.is_running or not master.is_participating
                or master.waiting_for_new_view):
            # catchup / an in-flight view change legitimately freezes every
            # instance: restart the stall clocks instead of counting the
            # pause as a wedge (same gate as PrimaryHealthService.check)
            self._backup_wedge_markers.clear()
            return
        live = set()
        for replica in list(self.replicas):
            iid = replica.data.inst_id
            if iid == 0:
                continue
            live.add(iid)
            has_work = replica.has_unordered_work()
            marker = replica.data.last_ordered_3pc
            prev = self._backup_wedge_markers.get(iid)
            if not has_work or prev is None or prev[0] != marker:
                self._backup_wedge_markers[iid] = (marker, now)
                continue
            if now - prev[1] >= self.config.BACKUP_INSTANCE_FAULTY_TIMEOUT:
                vote = BackupInstanceFaulty(
                    view_no=self.replicas.master.data.view_no, inst_id=iid,
                    reason=Suspicions.BACKUP_INSTANCE_STALLED.code)
                self.node_bus.send(vote)                 # broadcast to peers
                self._process_backup_faulty(vote, self.name)
                self._backup_wedge_markers[iid] = (marker, now)  # re-vote
        for iid in list(self._backup_wedge_markers):
            if iid not in live:
                del self._backup_wedge_markers[iid]

    def _process_backup_faulty(self, msg: BackupInstanceFaulty,
                               frm: str) -> None:
        """f+1 DISTINCT voters (ref quorums backup_instance_faulty) agree a
        backup stalled -> remove the instance. Ids are stable across the
        gap; the instance is re-created fresh by the next view change."""
        view = self.replicas.master.data.view_no
        if msg.view_no != view or msg.inst_id == 0 \
                or msg.inst_id not in self.replicas:
            return
        voters = self._backup_faulty_votes.setdefault(
            (view, msg.inst_id), set())
        voters.add(frm)
        if not self.quorums.backup_instance_faulty.is_reached(len(voters)):
            return
        self.replicas.remove_instance(msg.inst_id)   # stop()s the zombie
        self._removed_backups.add(msg.inst_id)
        self._backup_wedge_markers.pop(msg.inst_id, None)
        # stale votes (this instance, and anything from older views) go too
        self._backup_faulty_votes = {
            k: v for k, v in self._backup_faulty_votes.items()
            if k[0] == view and k[1] != msg.inst_id}
        self.monitor.reset()    # comparison basis changed
        self.metrics.add_event(MetricsName.BACKUP_INSTANCE_REMOVED)
        self.spylog.append(("backup_instance_removed", msg.inst_id))

    def _clean_outdated_reqs(self) -> None:
        now = self.timer.get_current_time()
        ttl = self.config.PROPAGATES_PHASE_REQ_TIMEOUT
        bodyless_ttl = self.config.PROPAGATE_BODYLESS_REQ_TIMEOUT
        retention = self.config.EXECUTED_REQ_RETENTION
        for digest, state in list(self.propagator.requests.items()):
            expired = (
                (state.executed and state.executed_at is not None
                 and now - state.executed_at > retention)
                or (not state.finalised and now - state.added_at > ttl)
                # digest votes with no verified body behind them are the
                # one state a peer can mint for free: short leash
                or (state.request is None
                    and now - state.added_at > bodyless_ttl))
            if expired:
                self.propagator.requests.free(digest)
                self._seen_propagates.pop(digest, None)
                self._body_fetches.pop(digest, None)
        # _seen_propagates entries whose request never made it into the
        # propagator (failed signature, late propagate of an executed txn)
        # have no RequestState carrying a timestamp — they are orphans the
        # moment they exist, and the cheapest spam vector if kept
        for digest in list(self._seen_propagates):
            if digest not in self.propagator.requests:
                del self._seen_propagates[digest]
        self.monitor.req_tracker.cleanup(now, ttl)

    # --- wiring -----------------------------------------------------------

    def _n_instances(self) -> int:
        """Effective RBFT instance count: pinned if the constructor said
        so, else f+1 from the CURRENT quorums (tracks pool membership)."""
        if self._pinned_instances is not None:
            return max(1, self._pinned_instances)
        return max(1, self.quorums.f + 1)

    def _make_replica(self, inst_id: int) -> Replica:
        from plenum_tpu_torch.execution.handlers import audit as audit_lib
        audit = self.c.db.get_ledger(AUDIT_LEDGER_ID)
        reg_memo: dict[str, Optional[list]] = {}

        def node_reg_at(pool_root: str) -> Optional[list]:
            got = reg_memo.get(pool_root)
            if got is None:
                # misses are NOT memoized: a root absent now can appear
                # later (staged audit txns revert and re-apply around view
                # changes), and a stale None would mis-judge the sig
                got = audit_lib.node_reg_at_pool_root(audit, pool_root)
                if got is not None:
                    if len(reg_memo) > 64:
                        reg_memo.clear()
                    reg_memo[pool_root] = got
            return got

        def key_at(name: str, pool_root_hex: str):
            try:
                return self.c.node_handler.bls_key_at_root(
                    name, bytes.fromhex(pool_root_hex))
            except (ValueError, KeyError):
                return None

        # BLS multi-signatures are a MASTER-instance concern: only master
        # batches carry state roots worth certifying. Backups signing over
        # empty roots would be wasted pairings AND their root-less sigs
        # cannot cite a pool-state epoch for rotation-aware validation.
        bls = None
        if inst_id == 0:
            # with the service plane, the per-batch aggregate pairing is
            # deduped host-wide (every co-hosted node runs the identical
            # check); otherwise verify locally — the factory encodes both
            from plenum_tpu_torch.parallel.crypto_service import \
                make_bls_verifier
            if (self.c.pipeline is not None
                    and self.config.crypto_backend != "service"):
                # commit-path batch checks ride the pipeline ring: one
                # deduped combined pairing check per flush window instead
                # of one per co-hosted node (the service plane keeps its
                # own host-wide dedup path)
                bls_verifier = self.c.pipeline.bls_verifier()
            else:
                bls_verifier = make_bls_verifier(self.config.crypto_backend)
            bls = BlsBftReplica(
                node_name=self.name, bls_signer=self.c.bls_signer,
                bls_verifier=bls_verifier,
                key_register=self.c.bls_register,
                bls_store=self.c.bls_store,
                node_reg_at=node_reg_at, key_at=key_at)
            # commit-path stage timer + pairings-per-batch counter
            bls.metrics = self.metrics
            # freshly aggregated multi-sigs advance the read plane's
            # signed-root anchor (late pending-order retries included)
            bls.on_multi_sig = self.read_plane.on_multi_sig
        # InstanceChange votes survive restart via the node-status DB
        # (ref instance_change_provider.py:34-69); master-only — backups
        # have no view-change machinery (see Replica)
        ic_store = None
        if inst_id == 0:
            status_kv = self.c.db.get_store(NODE_STATUS_DB_LABEL)
            if status_kv is not None:
                ic_store = InstanceChangeVoteStore(status_kv)
        replica = Replica(
            node_name=self.name, inst_id=inst_id,
            validators=self.validators, timer=self.timer,
            network=self.node_bus,
            executor=self.c.executor if inst_id == 0 else None,
            bls=bls, config=self.config,
            get_request=self.propagator.requests.get_request,
            checkpoint_digest_provider=(
                lambda seq: audit.uncommitted_root_hash.hex()),
            instance_count=self._n_instances(),
            metrics=self.metrics if inst_id == 0 else None,
            ic_vote_store=ic_store,
            tracer=self.tracer if inst_id == 0 else None,
            controller=self.batch_controller if inst_id == 0 else None,
            rtt=self.catchup_rtt if inst_id == 0 else None)
        if bls is not None:
            bls.report_bad_signature = lambda sender, r=replica: \
                r.internal_bus.send(RaisedSuspicion(
                    inst_id=inst_id, code=Suspicions.CM_BLS_WRONG.code,
                    reason="bad COMMIT BLS signature (batch-check fallback)",
                    sender=sender))
        if inst_id != 0 and self._last_sent_pp is not None:
            replica.ordering.on_backup_pp_sent = self._last_sent_pp.store
        replica.internal_bus.subscribe(Ordered, self._on_ordered)
        replica.internal_bus.subscribe(RaisedSuspicion, self._on_suspicion)
        # lambdas: message_req is constructed after the replicas
        replica.internal_bus.subscribe(
            MissingMessage, lambda m: self.message_req.process_missing(m))
        replica.internal_bus.subscribe(
            RequestPropagates, self._on_request_propagates)
        if inst_id == 0:
            replica.internal_bus.subscribe(
                NeedMasterCatchup, lambda _msg: self.start_catchup())
            replica.internal_bus.subscribe(NewViewAccepted,
                                           self._on_master_new_view)
            # VC stall decomposition: stamp the vote and the IC-quorum
            # start as they pass through the master's bus
            replica.internal_bus.subscribe(
                VoteForViewChange,
                lambda _m: self._vc_mark("vote"))
            replica.internal_bus.subscribe(
                NeedViewChange,
                lambda _m: self._vc_mark("start"))
        return replica

    # --- view-change stall decomposition ---------------------------------
    # Phase stamps ride the node timer: primary-disconnect detection ->
    # our IC vote -> IC quorum (NeedViewChange) -> NewViewAccepted ->
    # first post-VC order. Durations are emitted as metrics events so
    # tools/metrics_report can print the breakdown of a fault's cost.

    _VC_PHASES = (("detect", "vote", MetricsName.VC_DETECT_TO_VOTE),
                  ("vote", "start", MetricsName.VC_VOTE_TO_START),
                  ("start", "new_view", MetricsName.VC_START_TO_NEW_VIEW),
                  ("new_view", "order", MetricsName.VC_NEW_VIEW_TO_ORDER))

    _VC_ORDER = ("detect", "vote", "start", "new_view", "order")

    def _vc_mark(self, phase: str) -> None:
        """A stamp REFRESHES (latest wins) as long as no later phase has
        been stamped: a transient blip's 'detect' or a degradation vote's
        'vote' from an episode that never progressed must not anchor the
        durations of the real episode that follows. Once a later phase
        exists, earlier stamps freeze; phase metrics are emitted when the
        later endpoint of each pair is stamped."""
        if phase == "start":
            self._vc_starts_streak += 1
            self._maybe_vc_storm_resync()
        elif phase in ("new_view", "order"):
            self._vc_starts_streak = 0
        ts = self._vc_phase_ts
        rank = self._VC_ORDER.index(phase)
        if any(p in ts for p in self._VC_ORDER[rank + 1:]):
            return                      # episode already past this phase
        ts[phase] = self.timer.get_current_time()
        if phase == "start" and self.tracer.enabled:
            self.tracer.anomaly("view_change_start", None)
        if phase == "order":
            # metrics emit ONCE, at completion (refreshed stamps would
            # otherwise emit duplicate, drifting durations)
            for frm, to, metric in self._VC_PHASES:
                if frm in ts and to in ts:
                    self.metrics.add_event(metric, ts[to] - ts[frm])
            # whole-episode duration (earliest stamp -> first post-VC
            # order), sampled so metrics_report prints churn p50/p95
            first = min(ts[p] for p in self._VC_ORDER if p in ts)
            self.metrics.add_event(MetricsName.VC_DURATION,
                                   ts["order"] - first)
            if self.tracer.enabled:
                self.tracer.anomaly("view_change_recovered",
                                    {"duration_s": ts["order"] - first})
            self.spylog.append(("vc_stall_phases", dict(ts)))
            ts.clear()                  # episode complete

    def _on_request_propagates(self, msg: RequestPropagates) -> None:
        """Ordering stashed a pre-prepare (or the primary skipped batching)
        on MISSING_REQUESTS: pull the request bodies from peers. Digests
        with known voters go through the targeted fetch loop; digests
        nobody has vouched for yet fall back to a broadcast MessageReq."""
        for digest in msg.bad_requests:
            if self.propagator.requests.has_body(digest):
                continue
            state = self.propagator.requests.get(digest)
            if state is not None and any(s != self.name
                                         for s in state.propagates):
                self._request_body(digest, urgent=True)
            else:
                self.message_req.request("PROPAGATE", {"digest": digest})

    # --- targeted request-body fetch (digest-gossip) --------------------

    def _request_body(self, digest: str, urgent: bool) -> None:
        """Arm the per-digest body-fetch loop. Non-urgent arms it on a
        grace delay (the client's own broadcast or the disseminator's body
        usually outruns it); urgent (quorum reached / ordering blocked)
        fires NOW — escalating an already-armed-but-still-delayed loop by
        bumping its generation, so exactly one retry chain stays live."""
        fetch = self._body_fetches.get(digest)
        if fetch is not None:
            if urgent and fetch["tries"] == 0:
                fetch["gen"] += 1           # orphan the delayed first tick
                self.timer.schedule(
                    0.0, lambda: self._body_fetch_tick(digest, fetch["gen"]))
            return
        fetch = self._body_fetches[digest] = {"tries": 0, "gen": 0}
        delay = 0.0 if urgent else self.config.PROPAGATE_BODY_FETCH_DELAY
        self.timer.schedule(delay,
                            lambda: self._body_fetch_tick(digest, 0))

    def _body_fetch_tick(self, digest: str, gen: int) -> None:
        """One fetch attempt: ask the NEXT propagate voter for the body,
        re-arming until the body lands (bad/garbage replies simply leave
        the body absent, so the retry covers both timeout and lies)."""
        fetch = self._body_fetches.get(digest)
        if fetch is None or fetch["gen"] != gen:
            return                          # stood down or escalated past us
        state = self.propagator.requests.get(digest)
        if state is None or state.request is not None:
            del self._body_fetches[digest]
            if state is not None:
                state.fetch_started = False
            return
        senders = sorted(s for s in state.propagates if s != self.name)
        if fetch["tries"] >= 2 * max(len(senders), 1) + 2:
            # every voter tried twice and nobody produced a body that
            # verifies: give up; a fresh vote re-arms the loop, and the
            # bodyless-state TTL sweeps the orphan
            del self._body_fetches[digest]
            state.fetch_started = False
            self.spylog.append(("body_fetch_exhausted", digest))
            return
        dst = [senders[fetch["tries"] % len(senders)]] if senders else None
        fetch["tries"] += 1
        self.message_req.request("PROPAGATE", {"digest": digest}, dst=dst)
        self.timer.schedule(self.config.PROPAGATE_BODY_FETCH_RETRY,
                            lambda: self._body_fetch_tick(digest, gen))

    def _on_master_new_view(self, msg: NewViewAccepted) -> None:
        """The master completed a view change: every backup instance follows
        (view change is node-level; backups have no VC machinery of their own).
        Backups removed as faulty are re-created fresh here (ref
        restore_backup_replicas on view change)."""
        n_inst = self._n_instances()
        self._removed_backups.clear()       # a new view restores everything
        if self._last_sent_pp is not None:
            # backup numbering restarts with the view; stale rows must not
            # resume a future restart at an old view's heights
            self._last_sent_pp.erase()
        # partial vote sets from superseded views can never complete (view
        # is checked at receipt) — drop them or they leak one per view
        self._backup_faulty_votes = {
            k: v for k, v in self._backup_faulty_votes.items()
            if k[0] >= msg.view_no}
        fresh = [i for i in range(n_inst) if i not in self.replicas]
        self.replicas.grow_to(n_inst)
        primaries = list(self.replicas.master.data.primaries)
        for replica in self.replicas:
            if replica.data.inst_id in fresh:
                replica.set_validators(self.validators)
            replica.adopt_new_view(msg.view_no, primaries)
        self.monitor.reset()
        self.metrics.add_event(MetricsName.VIEW_CHANGES)
        self._vc_mark("new_view")
        self.notifier.send(TOPIC_VIEW_CHANGE, {
            "node": self.name, "view_no": msg.view_no,
            "primaries": primaries,
            "time": self.timer.get_current_time()})
        self.spylog.append(("view_change_complete", msg.view_no))
        if self.tracer.enabled:
            self.tracer.anomaly("view_change_complete",
                                {"view": msg.view_no})

    def _on_suspicion(self, msg: RaisedSuspicion) -> None:
        """Route a protocol suspicion: primary-authored faults become
        view-change votes; unambiguous peer misbehavior blacklists the
        sender (ref node.py:2854-2944)."""
        self.metrics.add_event(MetricsName.SUSPICIONS)
        self.spylog.append(("suspicion", (msg.code, msg.sender)))
        if self.tracer.enabled:
            self.tracer.anomaly("suspicion", {"code": msg.code,
                                              "sender": msg.sender})
        if msg.inst_id not in self.replicas:
            return
        replica = self.replicas[msg.inst_id]
        if msg.code in PRIMARY_FAULT_CODES and \
                msg.sender == replica.data.primary_name:
            if msg.inst_id == 0:
                replica.internal_bus.send(
                    VoteForViewChange(suspicion_code=msg.code))
                self._note_root_mismatch(msg)
            return
        if (msg.code in BLACKLIST_CODES and msg.sender
                and msg.sender != self.name):
            if self.blacklister.blacklist(msg.sender, msg.code):
                self.spylog.append(("blacklisted", msg.sender))

    def _note_root_mismatch(self, msg: RaisedSuspicion) -> None:
        """Divergence self-check. Each root-mismatch rejection implicates
        ONE primary — possibly byzantine. But once f+1 DISTINCT primaries'
        batches have failed our root derivation with no ordering progress
        in between, at least one of them was honest, so our own state is
        the diverged one: resync instead of wedging on suspicion votes.
        (The set resets on every master order and on catchup complete.)"""
        if msg.code not in ROOT_MISMATCH_CODES:
            return
        self._divergence_primaries.add(msg.sender)
        # only self-suspect while the pool is in a SETTLED view we share:
        # mid-view-change both sides legitimately disagree on roots for a
        # moment, and a resync here exits consensus exactly when our vote
        # is needed — the churn soak showed that splitting the pool into
        # view factions. A cooldown keeps a genuinely wedged node from
        # re-entering catchup faster than one round can complete.
        now = self.timer.get_current_time()
        cooldown = 2 * self.config.STUCK_BEHIND_CHECK_FREQ
        if (len(self._divergence_primaries) >= self.quorums.weak.value
                and not self.master_replica.data.waiting_for_new_view
                and now - self._divergence_fired_at > cooldown
                and not self.leecher.is_running
                and not self.read_only_degraded):
            self._divergence_fired_at = now
            suspects = sorted(self._divergence_primaries)
            self._divergence_primaries.clear()
            self.spylog.append(("divergence_resync", suspects))
            if self.tracer.enabled:
                self.tracer.anomaly("divergence_resync",
                                    {"primaries": suspects})
            # DEFERRED: suspicions surface inside consensus dispatch;
            # catchup reverts uncommitted state and must not run under
            # the 3PC processing stack (same rule as _note_peer_view)
            self.timer.schedule(0.0, self.start_catchup)

    # --- catchup ----------------------------------------------------------

    def _check_stuck_behind(self) -> None:
        """A live pool committed past us and we made no ordering progress
        for a full check interval: resync. Covers the mid-view straggler
        (rejoined after missing batches; no checkpoint below CHK_FREQ, no
        quorum behind its lone InstanceChange vote)."""
        r = self.master_replica
        evidence = r.ordering.behind_evidence()
        if evidence is None or self.leecher.is_running:
            self._behind_marker = None
            return
        last = r.last_ordered_3pc[1]
        if self._behind_marker == last:
            self._behind_marker = None
            self.spylog.append(("stuck_behind_resync", (last, evidence)))
            self.start_catchup()
        else:
            self._behind_marker = last

    def _note_peer_view(self, msg, frm: str) -> None:
        """Track the highest view each peer is demonstrably IN (master-
        instance consensus messages only); f+1 peers ahead -> resync.
        ViewChange/NewView for exactly my+1 do NOT count: during an
        ordinary view change every peer broadcasts those moments before
        we enter the view ourselves — only 3PC traffic (proof a higher
        view is ORDERING) or a jump of >= 2 views is straggler evidence."""
        view = getattr(msg, "view_no", None)
        if view is None or getattr(msg, "inst_id", 0) != 0:
            return
        my = self.master_replica.data.view_no
        if view <= my:
            self._ahead_views.pop(frm, None)
            return
        if isinstance(msg, (ViewChange, NewView)) and view == my + 1:
            return
        self._ahead_views[frm] = view
        ahead = [s for s, v in self._ahead_views.items() if v > my]
        now = self.timer.get_current_time()
        # damping: once per stuck view, UNLESS a previous attempt already
        # came and went without unsticking us (a catchup that raced the
        # rest of the pool's own recovery can conclude at a stale target;
        # the lag evidence persisting past a cooldown earns a retry)
        cooldown = 2 * self.config.STUCK_BEHIND_CHECK_FREQ
        if (len(ahead) >= self.quorums.propagate.value
                and (my > self._straggler_fired_view
                     or now - self._straggler_fired_at > cooldown)
                and not self.leecher.is_running):
            self._straggler_fired_view = my
            self._straggler_fired_at = now
            # DEFERRED: this handler runs inside consensus message
            # dispatch — starting catchup here would revert uncommitted
            # state under the 3PC processing stack mid-message. The
            # callback RE-VERIFIES the lag: a view change that completed
            # in the gap (we caught up on our own) must not pay a
            # needless catchup.
            self.timer.schedule(0.0, self._straggler_catchup)

    def _straggler_catchup(self) -> None:
        my = self.master_replica.data.view_no
        ahead = [s for s, v in self._ahead_views.items() if v > my]
        if (len(ahead) >= self.quorums.propagate.value
                and not self.leecher.is_running):
            self.spylog.append(("straggler_resync", (my, sorted(ahead))))
            self.start_catchup()

    def _on_lost_quorum_connectivity(self) -> None:
        """The watcher fired: we HAD consensus connectivity and now sit
        below the weak quorum. The reference restarts the node here; the
        payload of that restart is a resync, so mark one and run it as
        soon as enough peers are back (catching up with no peers would
        just time out)."""
        self.metrics.add_event(MetricsName.SUSPICIONS)
        self.spylog.append(("lost_quorum_connectivity",
                            sorted(self.node_bus.connecteds)))
        self._needs_resync = True
        self._maybe_resync_after_partition()

    def _maybe_resync_after_partition(self, *_a) -> None:
        if (getattr(self, "_needs_resync", False)
                and self.network_watcher.has_weak_connectivity()):
            self._needs_resync = False
            self.spylog.append(("resync_after_partition", None))
            self.start_catchup()

    def _maybe_vc_storm_resync(self) -> None:
        """Storm breaker: VC_STORM_RESYNC_STARTS consecutive view-change
        starts without a completion → resync the pool ledger. Escalating
        views only helps when everyone agrees WHO each view's primary is;
        with a registry split it never can, while catchup always can.
        Deferred (ViewChangeStarted surfaces inside consensus dispatch)
        and cooldown-damped like the other resync triggers — a genuine
        long outage keeps voting, paying at most one catchup round per
        cooldown window."""
        if self._vc_starts_streak < self.config.VC_STORM_RESYNC_STARTS:
            return
        now = self.timer.get_current_time()
        cooldown = 2 * self.config.STUCK_BEHIND_CHECK_FREQ
        if (now - self._vc_resync_fired_at <= cooldown
                or self.leecher.is_running or self.read_only_degraded):
            return
        self._vc_resync_fired_at = now
        self.spylog.append(("vc_storm_resync", self._vc_starts_streak))
        if self.tracer.enabled:
            self.tracer.anomaly("vc_storm_resync",
                                {"starts": self._vc_starts_streak})
        self.timer.schedule(0.0, self.start_catchup)

    def _accept_joiner_msg(self, msg, frm: str) -> bool:
        """Bus-filter escape hatch for membership churn: catchup QUERIES
        from a node the pool ledger knows but the validator set does not
        (yet). Strictly the seeder-serving subset — a LedgerStatus ask or
        a CatchupReq range fetch — so a non-validator can sync to join
        but can never vote into a cons-proof/3PC/propagate quorum."""
        if not (isinstance(msg, CatchupReq)
                or (isinstance(msg, LedgerStatus) and not msg.is_reply)):
            return False
        return (frm in self.pool_manager.known_node_names
                and not self.blacklister.is_blacklisted(frm))

    def _catchup_watchdog(self) -> None:
        """Kick a stalled catchup round: if the leecher's progress key is
        frozen across a full interval, force provider rotation + an
        immediate re-request; after CATCHUP_WATCHDOG_RESTART_KICKS
        consecutive fruitless kicks, restart the whole round (a target
        agreed with since-vanished peers can be genuinely unfinishable)."""
        if not self.leecher.is_running:
            self._catchup_progress_mark = None
            self._catchup_kicks = 0
            return
        mark = self.leecher.progress_key()
        if mark != self._catchup_progress_mark:
            self._catchup_progress_mark = mark
            self._catchup_kicks = 0
            return
        self._catchup_kicks += 1
        self.metrics.add_event(MetricsName.CATCHUP_WATCHDOG_KICKS)
        self.spylog.append(("catchup_watchdog_kick", self._catchup_kicks))
        if self.tracer.enabled:
            self.tracer.anomaly("catchup_stall",
                                {"kicks": self._catchup_kicks})
        if self._catchup_kicks >= self.config.CATCHUP_WATCHDOG_RESTART_KICKS:
            self._catchup_kicks = 0
            self.leecher.stop()
            self.leecher.start()        # fresh targets, fresh providers
        else:
            self.leecher.kick()

    def _degrade_read_only(self) -> None:
        """Catchup cannot complete soundly (divergent committed prefix,
        repeatedly): park in READ-ONLY mode. Ordering stays paused and no
        further catchup rounds start, but the verified read plane keeps
        serving state-proof reads at the last BLS-anchored root — clients
        get honest (if increasingly stale) proofs instead of a wedged
        node, and the freshness bound tells them exactly how stale."""
        if self.read_only_degraded:
            return
        self.read_only_degraded = True
        self._read_only_reason = "catchup_diverged"
        self.metrics.add_event(MetricsName.CATCHUP_DEGRADED, 1)
        self.spylog.append(("degraded_read_only", None))
        if self.tracer.enabled:
            self.tracer.anomaly("degraded_read_only",
                                {"diverged_rounds": self._diverged_rounds})

    def set_read_only(self, on: bool, reason: str = "autopilot") -> bool:
        """Orchestrated degradation (the autopilot's ladder, level 2):
        park/unpark read-only mode EXTERNALLY. Entering is refused while
        catchup divergence already parked the node (that state is not
        the orchestrator's to own); leaving only clears a read-only the
        SAME reason entered — a catchup-diverged node can never be
        un-degraded by a recovering autopilot. Returns True when the
        state changed."""
        if on:
            if self.read_only_degraded:
                return False
            self.read_only_degraded = True
            self._read_only_reason = reason
            self.spylog.append(("degraded_read_only", reason))
            if self.tracer.enabled:
                self.tracer.anomaly("degraded_read_only",
                                    {"reason": reason})
            return True
        if not self.read_only_degraded \
                or getattr(self, "_read_only_reason", None) != reason:
            return False
        self.read_only_degraded = False
        self._read_only_reason = None
        self.spylog.append(("undegraded_read_only", reason))
        return True

    def start_catchup(self) -> None:
        """Pause ordering, revert uncommitted work, sync all ledgers
        (ref node.py:2610 start_catchup → NodeLeecherService.start)."""
        if self.leecher.is_running or self.read_only_degraded:
            return
        # Quorum-ordered batches awaiting execution MUST execute before
        # catchup reverts the uncommitted stack they sit on (ref
        # force_process_ordered before starting the leecher): popping
        # them later against a reverted stack raised "commit with no
        # applied batches" and dropped ordered work (partition-heal fuzz).
        self._service_ordered()
        self.metrics.add_event(MetricsName.CATCHUPS)
        self._catchup_started_at = self.timer.get_current_time()
        self._catchup_progress_mark = None
        self._catchup_kicks = 0
        self.spylog.append(("catchup_started", None))
        if self.tracer.enabled:
            self.tracer.anomaly("catchup", None)
        for replica in self.replicas:
            replica.ordering.catchup_started()
        self.leecher.start()

    def _receive_ledger_status(self, msg: LedgerStatus, frm: str) -> None:
        # queries go to the seeder; acknowledgments feed our cons-proof
        # quorum — but only VALIDATORS' acknowledgments: a known-but-
        # demoted joiner's status may reach us through the joiner filter
        # and must not count toward the "we are current" quorum
        self.seeder.process_ledger_status(msg, frm)
        if frm in self.validators:
            self.leecher.process_ledger_status(msg, frm)

    def _on_catchup_txn(self, ledger_id: int, txn: dict) -> None:
        """A catchup txn was committed to the ledger: replay it into state
        and bookkeeping (ref node.py:1748 postTxnFromCatchupAddedToLedger)."""
        self.c.write_manager.apply_committed_txn(ledger_id, txn)
        digest = txn_lib.txn_digest(txn)
        if digest:
            self.propagator.requests.mark_executed(digest)
            # the request may sit RE-QUEUED in a replica (catchup_started's
            # revert returns unordered batches' requests to the queues, and
            # the pool ordered this one without us): leaving it queued lets
            # a primary re-batch an already-committed request (fuzz seed 45
            # double-order)
            for replica in self.replicas:
                for q in replica.ordering.request_queues.values():
                    q.pop(digest, None)

    def _on_catchup_complete(self, last_3pc) -> None:
        """All ledgers synced: adopt the audit ledger's 3PC position and
        primaries, rejoin consensus (ref allLedgersCaughtUp node.py:1790,
        select_primaries_on_catchup_complete :1830)."""
        from plenum_tpu_torch.execution.handlers import audit as audit_lib
        # churn observability: duration + request rounds + provider
        # switches, as sampled metrics AND as flight-recorder context, so
        # a WAN-degraded catchup regression is a p95 shift in
        # metrics_report, not an anecdote
        rounds = self.leecher.round_stats()
        duration = None
        if self._catchup_started_at is not None:
            duration = (self.timer.get_current_time()
                        - self._catchup_started_at)
            self._catchup_started_at = None
            self.metrics.add_event(MetricsName.CATCHUP_DURATION, duration)
        self.metrics.add_event(MetricsName.CATCHUP_ROUNDS,
                               rounds["rounds"])
        if rounds["provider_switches"]:
            self.metrics.add_event(MetricsName.CATCHUP_PROVIDER_SWITCHES,
                                   rounds["provider_switches"])
        if self.tracer.enabled:
            self.tracer.anomaly("catchup_complete",
                                {"duration_s": duration, **rounds})
        if self.leecher.diverged:
            # the committed prefix conflicts with the quorum target:
            # re-joining consensus on this ledger would fork. Retry a
            # bounded number of rounds (the conflict may have been a
            # transient lie), then degrade to read-only serving.
            self._diverged_rounds += 1
            if self._diverged_rounds >= \
                    self.config.CATCHUP_MAX_DIVERGED_ROUNDS:
                self._degrade_read_only()
            else:
                self.timer.schedule(
                    self.config.CATCHUP_WATCHDOG_INTERVAL,
                    self.start_catchup)
            return                      # ordering stays paused either way
        self._diverged_rounds = 0
        self._divergence_primaries.clear()
        audit = self.c.db.get_ledger(AUDIT_LEDGER_ID)
        view_no, pp_seq_no, primaries = audit_lib.last_audited_view(audit)
        if last_3pc is not None and last_3pc > (view_no, pp_seq_no):
            view_no, pp_seq_no = last_3pc
        self.pool_manager.pool_changed()
        self._last_executed_pp_seq = max(self._last_executed_pp_seq,
                                         pp_seq_no)
        for replica in self.replicas:
            if view_no > replica.data.view_no:
                replica.data.view_no = view_no
                if primaries:
                    replica.data.primaries = list(primaries)
            replica.ordering.caught_up_till_3pc(
                (view_no, pp_seq_no) if replica.is_master
                else replica.last_ordered_3pc)
        self.spylog.append(("catchup_complete", (view_no, pp_seq_no)))

    def _forward_to_replicas(self, digest: str) -> None:
        self.monitor.request_finalized(digest)
        for replica in self.replicas:
            replica.internal_bus.send(ReqKey(digest))

    def _on_ordered(self, msg: Ordered) -> None:
        if msg.inst_id == 0 and "new_view" in self._vc_phase_ts:
            # first post-VC MASTER order closes the episode (backups'
            # ordering is not client-visible recovery)
            self._vc_mark("order")
        self._ordered_queue.append(msg)

    def _on_pool_changed(self) -> None:
        """Pool-ledger commit changed membership: recompute quorums, update
        validators and BLS keys (ref node.py:731 setPoolParams)."""
        old_validators = list(self.validators)
        self.validators = self.pool_manager.node_names or [self.name]
        self.quorums = self.pool_manager.quorums
        self.propagator.set_quorums(self.quorums)
        self.network_watcher.set_nodes(self.validators)
        for replica in self.replicas:
            replica.set_validators(self.validators)
        self._adjust_replicas()
        rotated: list[str] = []
        for n in self.pool_manager.node_names:
            new_key = self.pool_manager.bls_key_of(n)
            old_key = self.c.bls_register.get_key_by_name(n)
            if old_key is not None and new_key is not None \
                    and old_key != new_key:
                rotated.append(n)
                # the rotated-OUT key must leave every crypto-plane key
                # table: fresh commits citing it are liars now, and a
                # warm decode/verdict row for a dead key is cache budget
                # a Byzantine signer can lean on (the key-table contract)
                for plane in (self.c.pipeline,
                              getattr(self.replicas.master, "bls",
                                      None) and
                              self.replicas.master.bls._verifier):
                    evict = getattr(plane, "evict_key", None)
                    if callable(evict):
                        evict(old_key)
            self.c.bls_register.set_key(n, new_key)
        # membership churn observability: every registry change counted,
        # the validator-count gauge refreshed, rotations called out in
        # the flight-recorder ring (a view change seconds later should
        # read as "the primary was demoted", not as a mystery)
        self.metrics.add_event(MetricsName.MEMBERSHIP_POOL_CHANGES)
        self.metrics.add_event(MetricsName.MEMBERSHIP_VALIDATORS,
                               len(self.validators))
        if rotated:
            self.metrics.add_event(MetricsName.MEMBERSHIP_KEY_ROTATIONS,
                                   len(rotated))
        if self.tracer.enabled:
            self.tracer.anomaly("pool_changed", {
                "validators": len(self.validators),
                "added": sorted(set(self.validators) - set(old_validators)),
                "removed": sorted(set(old_validators)
                                  - set(self.validators)),
                "rotated_keys": rotated})
        self.spylog.append(("pool_changed",
                            (len(old_validators), len(self.validators))))
        # a demoted PRIMARY cannot be waited out: its 3PC messages are
        # now filtered at every honest bus, so ordering is dead until a
        # view change — vote immediately instead of burning the ordering-
        # progress timeout (ref: the reference triggers VC on primary
        # demotion through its node-reg diff the same way)
        master = self.replicas.master
        primary = master.data.primary_name
        if (primary is not None and primary not in self.validators
                and self.name in self.validators
                and not master.data.waiting_for_new_view):
            self.spylog.append(("primary_demoted", primary))
            if self.tracer.enabled:
                self.tracer.anomaly("primary_demoted", {"primary": primary})
            master.internal_bus.send(VoteForViewChange(
                suspicion_code=Suspicions.PRIMARY_DEMOTED.code))
        # SELF-promotion: we just (re)entered the validator set after
        # sitting out. Anything the pool ordered in between is a gap our
        # stashed-commit window cannot see (commits far past the watermark
        # never land in behind_evidence) — resync BEFORE participating, or
        # we vote suspicions against every batch we cannot re-derive
        # (churn soak: a re-promoted straggler wedged at its demotion-era
        # ledger while the pool counted it toward quorums again)
        if (self.name in self.validators
                and self.name not in old_validators
                and not self.leecher.is_running
                and not self.read_only_degraded):
            self.spylog.append(("self_promoted_resync", None))
            if self.tracer.enabled:
                self.tracer.anomaly("self_promoted_resync", {})
            self.timer.schedule(0.0, self.start_catchup)
        # transport reacts too (TCP runner syncs its NodeRegistry + dials
        # new members here; ref kit_zstack connectToMissing)
        for cb in self.on_pool_changed_callbacks:
            cb()

    def _adjust_replicas(self) -> None:
        """Follow f across membership changes: RBFT runs f+1 protocol
        instances, so growing the pool past a 3f+1 boundary adds a backup
        instance and shrinking removes one (ref adjustReplicas
        node.py:1260). Existing primary ranks are kept mid-view; NEW ranks
        extend deterministically — round-robin on the CURRENT view over
        the committed validator list — so every honest node derives the
        same assignment from the same pool txn. The full set is reselected
        at the next view change (set_instance_count)."""
        n_inst = self._n_instances()
        master = self.replicas.master
        if master.view_changer is not None:
            master.view_changer.set_instance_count(n_inst)
        existing = set(self.replicas.instance_ids)
        target = set(range(n_inst)) - self._removed_backups
        if existing == target:
            return
        if max(existing) >= n_inst:
            self.replicas.shrink_to(n_inst)
            self._removed_backups -= {i for i in self._removed_backups
                                      if i >= n_inst}
            if set(self.replicas.instance_ids) == target:
                return          # pure shrink; a gap below n_inst still
                                # falls through to be re-filled
        # Deterministic extension: base the assignment on the COMMITTED
        # audit trail (view + primaries of the batch that changed
        # membership), never on master.data — a node mid-view-change has
        # proposal-scoped primaries that would diverge across the pool.
        # New ranks take the next round-robin validators not already
        # holding a rank (one faulty node must not control 2 instances).
        from plenum_tpu_torch.execution.handlers import audit as audit_lib
        audit = self.c.db.get_ledger(AUDIT_LEDGER_ID)
        view, _, primaries = audit_lib.last_audited_view(audit)
        primaries = list(primaries) or list(master.data.primaries)
        used = set(primaries)
        for rank in range(len(primaries), n_inst):
            n = len(self.validators)
            for j in range(n):
                cand = self.validators[(view + rank + j) % n]
                if cand not in used:
                    break
            else:
                # every validator already holds a rank — impossible while
                # n_inst = f+1 < n, but a future quorum-math change must
                # fail loudly, not silently give one node two instances
                raise RuntimeError(
                    f"no unranked validator for instance {rank}: "
                    f"{n_inst} instances over {n} validators")
            primaries.append(cand)
            used.add(cand)
        self.replicas.grow_to(n_inst, skip=self._removed_backups)
        # EVERY instance (master included) takes the extended canonical
        # list: the audit provider snapshots master.data.primaries, so a
        # short master list would be recorded durably and a restarted node
        # would restore one entry short (instance with no primary). The
        # list is derived purely from committed audit state, so a node
        # mid-view-change assigns the same value as everyone else — and
        # the view change's own completion re-selects it anyway.
        for replica in self.replicas:
            replica.data.primaries = list(primaries)
            if replica.data.inst_id not in existing:
                replica.set_validators(self.validators)
                # fresh backups join the audited view with a clean 3PC log
                replica.data.view_no = view
        self.spylog.append(
            ("replicas_adjusted", (sorted(existing), n_inst)))

    # --- ingress ----------------------------------------------------------

    def handle_client_message(self, msg: dict, frm: str) -> None:
        self._client_inbox.append((msg, frm))

    def submit_preverified(self, request: Request, frm: str) -> None:
        """Ingress-plane seam (ingress/plane.py): the request's signatures
        were already verified through THIS node's own authenticator in the
        plane's batched dispatch, and its static validation already ran at
        admission — re-dispatching here would double the device work. Pays
        the same settle pipeline as the in-node client path (ack / dedup
        Reply / propagate, or action execution), so everything downstream
        is indistinguishable from a request the node verified itself."""
        if self.c.read_manager.is_query_type(request.txn_type):
            self._answer_queries([(request, frm)])
            return
        if self.tracer.enabled:
            self.tracer.emit(tracing.INGRESS, request.digest, {"frm": frm})
        self._settle_client(request, frm, True)

    def _receive_propagate(self, msg: Propagate, frm: str) -> None:
        self._propagate_inbox.append((msg, frm))

    def _receive_propagate_batch(self, msg: PropagateBatch, frm: str) -> None:
        """Unpack a coalesced propagate envelope into the ordinary inbox:
        each entry pays the normal quota/dedup/auth pipeline."""
        for digest, sender_client in msg.votes:
            self._propagate_inbox.append(
                (Propagate(digest=digest, sender_client=sender_client), frm))
        for body in msg.bodies:
            try:
                inner = Propagate.from_dict(dict(body))
            except Exception:
                continue                   # one bad entry must not void the rest
            self._propagate_inbox.append((inner, frm))

    # --- the prod loop ----------------------------------------------------

    def prod(self) -> int:
        """One event-loop cycle (ref node.py:1037). Returns work count."""
        count = 0
        if self.c.pipeline is not None:
            # pump the shared ring: resolve a finished device wave,
            # promote the double-buffered packed one, pack the next
            self.c.pipeline.service()
        n = self._service_client_msgs()
        if n:
            self.metrics.add_event(MetricsName.CLIENT_MSGS, n)
        count += n
        n = self._service_propagates()
        if n:
            self.metrics.add_event(MetricsName.PROPAGATES, n)
        count += n
        self.replicas.service_all()
        count += self._service_ordered()
        # one PropagateBatch per tick instead of one wire message per vote:
        # the n^2 propagate message COUNT amortizes across the whole tick
        self.propagator.flush_outbox()
        return count

    # --- client pipeline --------------------------------------------------

    def _service_client_msgs(self) -> int:
        # finish last cycle's device dispatch first; while it's still
        # computing, leave the inbox queued (natural backpressure) and let
        # the rest of the prod cycle run
        self._auth_inflight, count = self._poll_inflight(
            self._auth_inflight, self._finish_client_auth)
        if self._auth_inflight is not None:
            return 0
        quota = self.config.LISTENER_MESSAGE_QUOTA
        batch, self._client_inbox = (self._client_inbox[:quota],
                                     self._client_inbox[quota:])
        to_auth: list[tuple[Request, str]] = []
        queries: list[tuple[Request, str]] = []
        for msg, frm in batch:
            if msg.get("op") == "OBSERVER_REGISTER":
                # a follower on this client connection wants BatchCommitted
                # pushes (ref observer/observable.py; the reference wires
                # registration through node plugins, here it is a first-
                # class client op so an ObserverNode needs no side channel)
                self.observable.add_observer(frm)
                self._client_send({"op": "OBSERVER_ACK"}, frm)
                continue
            try:
                request = Request.from_dict(msg)
            except Exception:
                self._client_send(RequestNack(
                    identifier=str(msg.get("identifier")),
                    req_id=msg.get("reqId") or 0,
                    reason="malformed request"), frm)
                continue
            if self.c.read_manager.is_query_type(request.txn_type):
                # answered together after the drain loop: the read plane
                # batches proof generation across the tick's query set
                queries.append((request, frm))
            elif self.action_manager is not None and \
                    self.action_manager.is_action_type(request.txn_type):
                # actions authenticate like writes but execute locally
                to_auth.append((request, frm))
            elif self.c.write_manager.is_write_type(request.txn_type):
                try:
                    self.c.write_manager.static_validation(request)
                except InvalidClientRequest as e:
                    self._client_send(RequestNack(
                        identifier=request.identifier,
                        req_id=request.req_id, reason=e.reason), frm)
                    continue
                if self.tracer.enabled:
                    self.tracer.emit(tracing.INGRESS, request.digest,
                                     {"frm": frm})
                to_auth.append((request, frm))
            else:
                self._client_send(RequestNack(
                    identifier=request.identifier, req_id=request.req_id,
                    reason=f"unknown txn type {request.txn_type!r}"), frm)
        if queries:
            self._answer_queries(queries)
        deduped: list[tuple[Request, str]] = []
        for req, frm in to_auth:
            if req.digest in self._authing:
                # a dispatch for these very bytes is already in flight
                # (peer propagate raced ahead): park the client copy and
                # settle it on that verdict instead of re-verifying
                self._authing[req.digest].append(("client", req, frm))
            else:
                self._authing[req.digest] = []
                deduped.append((req, frm))
        to_auth = deduped
        if to_auth:
            self._auth_inflight = self._submit_auth(
                to_auth, [r for r, _ in to_auth], self._finish_client_auth)
            if self._auth_inflight is not None:
                # deferred items are counted when their verdicts land, so
                # the work count (and CLIENT_MSGS/PROPAGATES metrics) stay
                # 1x regardless of backend
                return count + len(batch) - len(to_auth)
        return count + len(batch)

    def _answer_queries(self, queries: list[tuple[Request, str]]) -> None:
        """One read-plane batch for the tick's whole query set: cache
        hits, proof envelopes, and the batched digest hash happen once
        per tick, not once per query (reads/plane.py)."""
        outcomes = self.read_plane.answer_batch([q for q, _ in queries])
        for (request, frm), out in zip(queries, outcomes):
            if isinstance(out, InvalidClientRequest):
                self._client_send(RequestNack(identifier=request.identifier,
                                              req_id=request.req_id,
                                              reason=out.reason), frm)
            elif isinstance(out, Exception):
                # a malformed query must never take the prod loop down
                self._client_send(RequestNack(identifier=request.identifier,
                                              req_id=request.req_id,
                                              reason="malformed query"), frm)
            else:
                self._client_send(Reply(result=out), frm)

    def _answer_query(self, request: Request, frm: str) -> None:
        """Single-query seam kept for callers outside the prod loop."""
        self._answer_queries([(request, frm)])

    def _finish_client_auth(self, items: list[tuple[Request, str]],
                            verdicts) -> None:
        """Ack + propagate statically-valid requests whose signatures the
        device accepted (ref processRequest:2000 → recordAndPropagate)."""
        for (req, frm), ok in zip(items, verdicts):
            self._settle_client(req, frm, ok)
            self._settle_parked(req, ok)

    def _settle_parked(self, req: Request, ok: bool) -> None:
        """Deliver a landed verdict to everything parked on that digest:
        peer propagates become votes (same signed bytes — the digest covers
        the signature), parked client copies get the full client settle.
        Propagates of an already-executed request are dropped, NOT
        processed — process_propagate would resurrect request state for a
        committed txn (same hazard _finish_propagate_auth re-checks)."""
        parked = self._authing.pop(req.digest, [])
        if not parked:
            return
        executed = ok and req.digest not in self.propagator.requests \
            and self._executed_txn(req) is not None
        for entry in parked:
            if entry[0] == "prop":
                _, pmsg, pfrm = entry
                if not ok:
                    self.spylog.append(("suspicious_propagate", pfrm))
                elif not executed:
                    self.propagator.process_propagate(pmsg, pfrm)
            else:
                _, preq, pfrm = entry
                self._settle_client(preq, pfrm, ok)

    def _settle_client(self, req: Request, frm: str, ok: bool) -> None:
        if self.tracer.enabled:
            self.tracer.emit(tracing.AUTH, req.digest, {"ok": bool(ok)})
        if not ok:
            self._client_send(RequestNack(identifier=req.identifier,
                                          req_id=req.req_id,
                                          reason="signature verification failed"),
                              frm)
            return
        if self.action_manager is not None and \
                self.action_manager.is_action_type(req.txn_type):
            # actions execute on THIS node only: no propagate, no 3PC
            try:
                result = self.action_manager.process(req)
            except InvalidClientRequest as e:
                self._client_send(RequestNack(
                    identifier=req.identifier, req_id=req.req_id,
                    reason=e.reason), frm)
                return
            except UnauthorizedClientRequest as e:
                # well-formed but refused -> REJECT, never NACK
                self._client_send(Reject(
                    identifier=req.identifier, req_id=req.req_id,
                    reason=e.reason), frm)
                return
            self._client_send(Reply(result=result), frm)
            return
        # dedup: an already-executed request gets its Reply resent
        # (durable lookup via the seq-no DB, ref node.py:2000 seqNoMap)
        executed = self._executed_txn(req)
        if executed is not None:
            self._client_send(Reply(result=executed), frm)
            return
        self._client_send(RequestAck(identifier=req.identifier,
                                     req_id=req.req_id), frm)
        self.propagator.propagate(req, frm)

    def _executed_txn(self, req: Request) -> Optional[dict]:
        """Committed txn for a request that already executed, else None."""
        seq_no_db = self.c.db.get_store(SEQ_NO_DB_LABEL)
        if seq_no_db is None:
            return None
        raw = seq_no_db.try_get(req.payload_digest.encode())
        if raw is None:
            return None
        try:
            ledger_id, seq_no, _ = unpack(raw)
            return self.c.db.get_ledger(ledger_id).get_by_seq_no(seq_no)
        except Exception:
            return None

    # --- node pipeline ----------------------------------------------------

    def _service_propagates(self) -> int:
        # pipelined like the client path: finish the in-flight device
        # dispatch; while busy, keep the inbox queued (propagate votes are
        # order-insensitive, so interleaving with fresh drains is safe)
        self._prop_inflight, count = self._poll_inflight(
            self._prop_inflight, self._finish_propagate_auth)
        if self._prop_inflight is not None:
            return 0
        quota = self.config.REMOTES_MESSAGE_QUOTA
        batch, self._propagate_inbox = (self._propagate_inbox[:quota],
                                        self._propagate_inbox[quota:])
        verified: list[tuple[Propagate, str, Request]] = []
        to_auth: list[tuple[Propagate, str, Request]] = []
        for msg, frm in batch:
            if msg.request is None:
                # digest-only vote: nothing to authenticate (the sender is
                # transport-authenticated; the CONTENT is vouched for only
                # once a verified body lands) — count it directly
                digest = msg.digest
                if not digest:
                    continue
                seen = self._seen_propagates.setdefault(digest, {})
                if frm in seen:
                    continue
                seen[frm] = False
                state = self.propagator.requests.get(digest)
                if state is not None and state.executed:
                    continue     # late vote for an already-executed request
                self.propagator.process_digest_vote(digest, frm,
                                                    msg.sender_client)
                continue
            try:
                request = Request.from_dict(msg.request)
            except Exception:
                continue
            if msg.digest and msg.digest != request.digest:
                # body does not hash to the claimed digest: a lying
                # fetch responder or relay — drop, the fetch loop retries
                self.spylog.append(("suspicious_propagate", frm))
                continue
            seen = self._seen_propagates.setdefault(request.digest, {})
            if seen.get(frm):
                continue         # this sender already delivered a body
            seen[frm] = True
            state = self.propagator.requests.get(request.digest)
            if state is not None and state.request is not None:
                # signature was already verified when the body first landed
                verified.append((msg, frm, request))
            elif request.digest in self._authing:
                # same digest = same signed bytes (digest covers the
                # signature): a dispatch is already in flight, so park
                # this as a vote for when that verdict lands
                self._authing[request.digest].append(("prop", msg, frm))
            elif self._executed_txn(request) is not None:
                continue     # late propagate of an already-executed request
            else:
                # register BEFORE scanning the rest of the drain so later
                # same-digest propagates in this very batch park instead
                # of duplicating the device work
                self._authing[request.digest] = []
                to_auth.append((msg, frm, request))
        for msg, frm, _ in verified:
            self.propagator.process_propagate(msg, frm)
        if to_auth:
            self._prop_inflight = self._submit_auth(
                to_auth, [r for _, _, r in to_auth],
                self._finish_propagate_auth)
            if self._prop_inflight is not None:
                return count + len(batch) - len(to_auth)
        return count + len(batch)

    def _finish_propagate_auth(self, pending, verdicts) -> None:
        for (msg, frm, req), ok in zip(pending, verdicts):
            if not ok:
                self.spylog.append(("suspicious_propagate", frm))
                self._settle_parked(req, False)
                continue
            # verdicts can be up to MAX_AUTH_POLLS prods stale: a catchup
            # may have committed the request meanwhile — re-check the
            # executed guard the drain applied, or a late propagate would
            # resurrect request state for an already-executed txn
            # (_settle_parked applies the same guard: parked props drop,
            # parked clients get their executed-Reply via _settle_client)
            if req.digest not in self.propagator.requests and \
                    self._executed_txn(req) is not None:
                self._settle_parked(req, True)
                continue
            self.propagator.process_propagate(msg, frm)
            self._settle_parked(req, True)

    # --- pipelined device-auth plumbing -----------------------------------

    def _poll_inflight(self, inflight, finish):
        """-> (inflight', n_finished): poll a pending device dispatch,
        blocking once it has been polled MAX_AUTH_POLLS times (prod loops
        that spin faster than the device computes — MockTimer sims — must
        not starve the pipeline, and a wedged dispatch must surface)."""
        if inflight is None:
            return None, 0
        token, pending, polls = inflight
        verdicts = self.c.authenticator.collect_batch(
            token, wait=polls >= self.MAX_AUTH_POLLS)
        if verdicts is None:
            return (token, pending, polls + 1), 0
        finish(pending, verdicts)
        return None, len(pending)

    def _submit_auth(self, items, requests, finish):
        """Dispatch a signature batch; -> in-flight state or None if the
        verdicts were ready immediately (CPU backend)."""
        token = self.c.authenticator.submit_batch(requests)
        if self.tracer.enabled:
            # dispatch provenance: a supervised plane's token names its
            # route (dev / cpu / hedge); a plain CPU backend resolves
            # synchronously ("sync")
            self.tracer.emit(tracing.CRYPTO_DISPATCH, "",
                             {"n": len(requests),
                              "kind": getattr(token, "kind", "sync")})
        verdicts = self.c.authenticator.collect_batch(token, wait=False)
        if verdicts is None:
            return (token, items, 0)
        finish(items, verdicts)
        return None

    # --- ordered batches --------------------------------------------------

    def _service_ordered(self) -> int:
        done = 0
        while self._ordered_queue:
            drained, self._ordered_queue = self._ordered_queue, []
            to_exec: list[Ordered] = []
            # tracks the filter floor WITHIN this drain too: two copies of
            # the same re-certified batch can land in one drain window, and
            # comparing both against the pre-drain _last_executed_pp_seq
            # would double-commit (commit-out-of-order crash)
            exec_floor = self._last_executed_pp_seq
            for msg in drained:
                done += 1
                self.monitor.request_ordered(msg.inst_id, msg.req_idr)
                if msg.inst_id == 0:
                    for digest in msg.discarded:
                        self.monitor.req_tracker.drop(digest)
                if msg.inst_id != 0:
                    self.metrics.add_event(MetricsName.BACKUP_ORDERED)
                    self.spylog.append(("backup_ordered", msg))
                    continue
                if msg.pp_seq_no <= exec_floor:
                    # a batch ordered pre-view-change and re-certified after
                    # it can surface twice; the ledger effects are already
                    # durable
                    self.spylog.append(("duplicate_ordered_skipped",
                                        (msg.view_no, msg.pp_seq_no)))
                    continue
                to_exec.append(msg)
                exec_floor = msg.pp_seq_no
            if not to_exec:
                continue
            # GROUP COMMIT: ready batches commit under ONE write_batch
            # scope per store — the flush coalesces across batches
            # (catchup-style multi-batch commit). REPLIES go out only after
            # the scope closes: a client ack must never precede the durable
            # flush backing it. Coalescing is CAPPED (controller-steered):
            # a deep pipeline can stack dozens of ready batches, and an
            # unbounded scope would put the first batch's replies behind
            # the whole stack's flush.
            limit = max(1, (self.batch_controller.group_commit_max
                            if self.batch_controller is not None
                            else self.config.GROUP_COMMIT_MAX_BATCHES))
            while to_exec:
                chunk, to_exec = to_exec[:limit], to_exec[limit:]
                committed_per_msg: list[list[dict]] = []
                t0 = time.perf_counter()
                t0_timer = self.timer.get_current_time()
                with self.c.executor.group_commit():
                    for msg in chunk:
                        self.metrics.add_event(MetricsName.ORDERED_BATCH_SIZE,
                                               len(msg.req_idr))
                        with self.metrics.measure_time(
                                MetricsName.EXECUTE_BATCH_TIME):
                            committed_per_msg.append(self._commit_ordered(msg))
                        self._last_executed_pp_seq = msg.pp_seq_no
                self.metrics.add_event(MetricsName.COMMIT_DURABLE_TIME,
                                       time.perf_counter() - t0)
                self.metrics.add_event(MetricsName.GROUP_COMMIT_BATCHES,
                                       len(chunk))
                if (self.batch_controller is not None
                        and self.replicas.master.data.is_primary):
                    # flush span on the injectable timer (0 under mock
                    # time — deterministic): the controller's durable
                    # stage. Only the acting master primary feeds its
                    # controller — on every other node the loop would
                    # otherwise tick on durable-only samples and drift
                    # the knobs nobody reads there.
                    self.batch_controller.note_durable(
                        self.timer.get_current_time() - t0_timer,
                        len(chunk))
                if self.tracer.enabled:
                    # batch linkage rides pp_seq_no (Ordered carries no batch
                    # digest); wall duration only when the tracer allows it —
                    # perf_counter deltas are not replay-deterministic
                    data = {"seqs": [m.pp_seq_no for m in chunk]}
                    if self.tracer.wall_durations:
                        data["dur"] = time.perf_counter() - t0
                    self.tracer.emit(tracing.DURABLE, "", data)
                with self.metrics.measure_time(MetricsName.COMMIT_REPLY_TIME):
                    for msg, committed in zip(chunk, committed_per_msg):
                        self._reply_batch(msg, committed)
        return done

    def _commit_ordered(self, msg: Ordered) -> list[dict]:
        """Durable half of executeBatch:2661 — commit the ordered batch's
        writes (inside the caller's group-commit scope)."""
        batch = ThreePcBatch(
            ledger_id=msg.ledger_id, view_no=msg.view_no,
            pp_seq_no=msg.pp_seq_no, pp_time=msg.pp_time,
            valid_digests=tuple(msg.req_idr),
            state_root=bytes.fromhex(msg.state_root) if msg.state_root else b"",
            txn_root=bytes.fromhex(msg.txn_root) if msg.txn_root else b"",
            audit_txn_root=(bytes.fromhex(msg.audit_txn_root)
                            if msg.audit_txn_root else b""),
            primaries=tuple(self.replicas.master.data.primaries),
            node_reg=tuple(self.validators))
        committed = self.c.executor.commit_batch(batch)
        # advance the read plane: the txn root's tree size is knowable
        # only now (post-commit), and the batch's multi-sig — if the
        # aggregation already produced it — becomes the serving anchor;
        # either way the ledger's cached read results are invalidated
        self.read_plane.on_batch_committed(msg.ledger_id, msg.state_root,
                                           msg.txn_root)
        # ordering progress: any root-mismatch rejections before this
        # point no longer evidence OUR divergence
        self._divergence_primaries.clear()
        self.spylog.append(("executed", (msg.view_no, msg.pp_seq_no)))
        return committed

    def _reply_batch(self, msg: Ordered, committed: list[dict]) -> None:
        """Client-visible half of executeBatch: observer push, REPLY/Reject
        fan-out, request-state retirement — after the durable flush."""
        if committed and self.observable.observer_ids:
            reqs = []
            complete = True
            for digest in msg.req_idr:
                if digest in msg.discarded:
                    continue
                state = self.propagator.requests.get(digest)
                if state is None:
                    complete = False      # swept request: a partial push
                    break                 # would wedge observers on a root
                reqs.append(state.request.to_dict())      # mismatch forever
            if complete:
                # newest multi-sig for this ledger rides the push so
                # observers can anchor VERIFIED reads (they check it
                # against the pool BLS keys before adopting; it is
                # excluded from their f+1 push-content quorum — see
                # BatchCommitted.multi_sig). Prefer this batch's own
                # sig; a lagging aggregation falls back to the read
                # plane's current anchor.
                ms = None
                bls_store = self.c.db.bls_store
                if bls_store is not None and msg.state_root:
                    ms = bls_store.get(msg.state_root)
                if ms is None:
                    anchor = self.read_plane.anchor_for(msg.ledger_id)
                    ms = anchor.ms if anchor is not None else None
                self.observable.append_input(BatchCommitted(
                    requests=tuple(reqs), ledger_id=msg.ledger_id, inst_id=0,
                    view_no=msg.view_no, pp_seq_no=msg.pp_seq_no,
                    pp_time=msg.pp_time, state_root=msg.state_root,
                    txn_root=msg.txn_root,
                    seq_no_start=txn_lib.txn_seq_no(committed[0]),
                    seq_no_end=txn_lib.txn_seq_no(committed[-1]),
                    multi_sig=tuple(ms.to_list()) if ms is not None
                    else None))
            else:
                self.spylog.append(("observer_push_skipped",
                                    (msg.view_no, msg.pp_seq_no)))
        for txn in committed:
            digest = txn_lib.txn_digest(txn)
            state = self.propagator.requests.get(digest) if digest else None
            if state is not None and state.client_name is not None:
                self._client_send(Reply(result=txn), state.client_name)
                if self.tracer.enabled and digest:
                    self.tracer.emit(tracing.REPLY, digest,
                                     {"seq": msg.pp_seq_no})
            # Executed state is RETAINED (freed later by the TTL sweep):
            # peers may still MessageReq this PROPAGATE. Durable client-resend
            # dedup lives in the seq-no DB regardless.
            if digest:
                self.propagator.requests.mark_executed(digest)
                self._seen_propagates.pop(digest, None)
        for digest in msg.discarded:
            state = self.propagator.requests.get(digest)
            if state is not None and state.client_name is not None:
                self._client_send(Reject(identifier=state.request.identifier,
                                         req_id=state.request.req_id,
                                         reason="rejected by dynamic validation"),
                                  state.client_name)
            # discarded digests are still part of req_idr: lagging validators
            # must be able to fetch them to re-apply the batch, so they get
            # the same retention as executed ones
            self.propagator.requests.mark_executed(digest)
            self._seen_propagates.pop(digest, None)
        if msg.ledger_id == POOL_LEDGER_ID:
            self.pool_manager.pool_changed()

    # --- accessors --------------------------------------------------------

    @property
    def master_replica(self) -> Replica:
        return self.replicas.master

    @property
    def f(self) -> int:
        return self.quorums.f

    def validator_info(self) -> dict:
        """Operational snapshot (ref plenum/server/validator_info_tool.py):
        identity, pool view, per-ledger sizes/roots, 3PC position, catchup
        and connection state, metrics summary. Everything here is cheap to
        read — safe to poll."""
        master = self.master_replica
        ledgers = {}
        for ledger_id, ledger in self.c.db.ledgers():
            state = self.c.db.get_state(ledger_id)
            ledgers[ledger_id] = {
                "size": ledger.size,
                "uncommitted": ledger.uncommitted_size - ledger.size,
                "root": ledger.root_hash.hex(),
                "state_root": state.committed_head_hash.hex()
                if state is not None else None,
            }
        return {
            "name": self.name,
            "uptime": self.timer.get_current_time() - self.started_at,
            "validators": list(self.validators),
            "f": self.quorums.f,
            "connected": sorted(self.node_bus.connecteds),
            "blacklisted": sorted(self.blacklister.blacklisted),
            "view_no": master.data.view_no,
            "primaries": list(master.data.primaries),
            "is_primary": {r.inst_id: r.data.is_primary
                           for r in self.replicas},
            "last_ordered_3pc": tuple(master.last_ordered_3pc),
            "catchup_in_progress": self.leecher.is_running,
            "read_only_degraded": self.read_only_degraded,
            "instances": len(self.replicas),
            "ledgers": ledgers,
            "metrics": self.metrics.summary(),
            "monitor": self.monitor.stats(),
            "batch_controller": (self.batch_controller.trajectory()
                                 if self.batch_controller is not None
                                 else None),
        }
