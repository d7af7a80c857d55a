"""The 3PC ordering hot loop: PRE-PREPARE → PREPARE → COMMIT → Ordered.

Reference behavior: plenum/server/consensus/ordering_service.py:60 —
process_preprepare :501, process_prepare :223, process_commit :436, batch
creation send_3pc_batch :1961 / create_3pc_batch :2038, in-order emission
_do_order :1475, out-of-order commit stash :191,1642, uncommitted apply/revert
_apply_pre_prepare :1138 / _revert :1229, and the view-change re-ordering hooks
:2380-2455. Message admission mirrors ordering_service_msg_validator.py:
discard stale traffic, stash future-view / outside-watermark / catching-up
traffic under typed reasons and replay when the blocking condition clears.

Only the master instance applies requests to uncommitted state; backups order
the same traffic for the RBFT monitor comparison without touching state
(SURVEY.md §2.3).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.common.internal_messages import (MissingMessage,
                                                 NeedMasterCatchup,
                                                 NewViewCheckpointsApplied,
                                                 RaisedSuspicion, ReqKey,
                                                 RequestPropagates,
                                                 ViewChangeStarted)
from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID, DOMAIN_LEDGER_ID,
                                             VALID_LEDGER_IDS,
                                             Commit, Ordered, PrePrepare,
                                             Prepare)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.stashing import (DISCARD, PROCESS, STASH, StashReason,
                                        StashingRouter)
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.config import Config

from .batch_executor import AppliedBatch, BatchExecutor
from .batch_id import BatchID
from .bls_bft_replica import BlsBftReplica
from .consensus_shared_data import ConsensusSharedData


def _orig_view(pp: PrePrepare) -> int:
    """Original view of a (possibly re-ordered) batch; view 0 is a valid
    original view, so never use `or` here."""
    return pp.original_view_no if pp.original_view_no is not None else pp.view_no


class OrderingService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 executor: Optional[BatchExecutor],
                 bls: Optional[BlsBftReplica] = None,
                 config: Optional[Config] = None,
                 get_request: Optional[Callable[[str], Optional[Request]]] = None,
                 metrics=None, tracer=None, controller=None):
        self._data = data
        self._timer = timer
        # per-phase 3PC timing (ref metrics_collector.py's 3PC names):
        # key -> (t_preprepare, t_prepared); emitted at quorum transitions
        self._metrics = metrics
        # tracing plane: batch-keyed span events (pp send/recv, prepare
        # quorum, commit send, ordered, apply) — master instance only
        self._tracer = tracer if tracer is not None else tracing.NULL_TRACER
        self._phase_ts: dict[tuple[int, int], list] = {}
        self._bus = bus
        self._network = network
        self._executor = executor
        self._bls = bls
        self._config = config or Config()
        self._get_request = get_request or (lambda digest: None)
        # closed-loop batch controller (batch_controller.py): when present
        # its steered knobs replace the static Max3PCBatchSize /
        # Max3PCBatchWait / Max3PCBatchesInFlight reads, and the primary
        # feeds it timer-stamped batch-lifecycle samples
        self._controller = controller
        # (view, pp_seq_no) -> cut stamp on the injectable timer; feeds
        # the controller's cut -> commit-quorum span on the primary
        self._cut_ts: dict[tuple[int, int], float] = {}

        # 3PC logs (all keyed by (view_no, pp_seq_no))
        self.sent_preprepares: dict[tuple[int, int], PrePrepare] = {}
        self.prePrepares: dict[tuple[int, int], PrePrepare] = {}
        self.prepares: dict[tuple[int, int], dict[str, Prepare]] = {}
        self.commits: dict[tuple[int, int], dict[str, Commit]] = {}
        self.ordered: set[tuple[int, int]] = set()
        # (original_view, pp_seq_no) -> digest of every batch this node has
        # EXECUTED; re-ordered incarnations of these re-certify (vote) but
        # must never re-apply or re-emit Ordered (see _order)
        self._ordered_originals: dict[tuple[int, int], str] = {}
        self._commits_sent: set[tuple[int, int]] = set()
        self._stashed_ooo_commits: dict[tuple[int, int], PrePrepare] = {}
        # Old-view pre-prepares kept for re-ordering after a view change,
        # keyed by (original view, pp_seq_no).
        self.old_view_preprepares: dict[tuple[int, int], PrePrepare] = {}

        # Finalized requests awaiting batching (primary only), per ledger.
        self.request_queues: dict[int, OrderedDict] = {
            lid: OrderedDict() for lid in VALID_LEDGER_IDS}
        # Master-only stack of applied-but-unordered batches for revert.
        self._applied_unordered: list[tuple[int, BatchID]] = []
        # Node-installed persistence hook for backup primaries' last-sent
        # PRE-PREPARE seq-no (ref last_sent_pp_store_helper.py).
        self.on_backup_pp_sent = None

        # wrong-instance traffic is rejected by the accept pre-filter
        # before any dispatch bookkeeping (at f+1 instances, 8 of 9 router
        # dispatches on the shared bus are another instance's messages);
        # _validate keeps its own inst_id check for direct callers
        self._stasher = StashingRouter(
            accept=lambda m: getattr(m, "inst_id", self._data.inst_id)
            == self._data.inst_id)
        self._stasher.subscribe(PrePrepare, self.process_preprepare)
        self._stasher.subscribe(Prepare, self.process_prepare)
        self._stasher.subscribe(Commit, self.process_commit)
        self._stasher.subscribe_to(network)

        bus.subscribe(ReqKey, self.process_req_key)
        bus.subscribe(ViewChangeStarted, self.process_view_change_started)
        bus.subscribe(NewViewCheckpointsApplied,
                      self.process_new_view_checkpoints_applied)

        # ledger_id -> absolute deadline for the next freshness batch
        self._freshness_deadline: dict[int, float] = {}
        # (orig_view, pp_seq_no) -> cited digest: NewView batches we lack
        # locally and have re-requested from peers
        self._awaited_old_view: dict[tuple[int, int], str] = {}
        # request digests a NewView re-proposal is blocked on (the new
        # primary lacked them); fresh batch minting pauses until resolved
        self._awaiting_reproposal: set = set()
        # the last accepted NewView payload, re-run when an awaited old-view
        # pre-prepare arrives
        self._last_new_view_msg: Optional[NewViewCheckpointsApplied] = None
        # backup instances joining a new view adopt the first pre-prepare
        # they see as their position (ref _setup_last_ordered_for_non_master)
        self._needs_last_ordered_setup = False

    def stop(self) -> None:
        """Detach from the shared network bus (replica removal): a removed
        instance must not keep consuming 3PC messages as a zombie."""
        self._stasher.unsubscribe_from_buses()

    # ------------------------------------------------------------------ #
    # request intake                                                     #
    # ------------------------------------------------------------------ #

    def process_req_key(self, msg: ReqKey) -> None:
        """A finalized request became available for ordering."""
        req = self._get_request(msg.digest)
        if req is None:
            return
        ledger_id = (self._executor.ledger_id_for(req)
                     if self._executor else DOMAIN_LEDGER_ID)
        # queue VALUES are enqueue stamps (injectable timer): the partial-
        # batch wait is measured from the oldest queued request's own
        # stamp, so no code path can restart a waiting request's clock.
        # setdefault: a duplicate ReqKey must not refresh the stamp.
        self.request_queues.setdefault(ledger_id, OrderedDict()).setdefault(
            msg.digest, self._timer.get_current_time())
        self._stasher.process_all_stashed(StashReason.MISSING_REQUESTS)
        # a NewView re-proposal deferred on THIS request (the primary
        # lacked it): resume the pass — idempotent, skips batches already
        # re-proposed. Gating on the pending set matters: an unconditional
        # re-entry would rerun the pass during normal post-view-change
        # operation and reset pp_seq_no under in-flight fresh batches.
        if (msg.digest in self._awaiting_reproposal
                and self._last_new_view_msg is not None
                and self.is_primary):
            self.process_new_view_checkpoints_applied(
                self._last_new_view_msg)

    # ------------------------------------------------------------------ #
    # batch creation (primary)                                           #
    # ------------------------------------------------------------------ #

    @property
    def is_primary(self) -> bool:
        return self._data.is_primary

    def service(self) -> None:
        """Called each prod cycle: primaries turn queued requests into batches."""
        if not self.is_primary or self._data.waiting_for_new_view:
            self._freshness_deadline.clear()
            return
        if not self._data.is_participating:
            return
        if self._awaited_old_view or self._awaiting_reproposal:
            # a new primary must finish re-proposing the NewView's cited
            # batches before cutting fresh ones — a fresh batch slotted
            # between pending re-proposals applies out of seq order and
            # corrupts the uncommitted stack (found by the view-change fuzz)
            return
        self.send_3pc_batch()
        self._send_freshness_batches()

    def _send_freshness_batches(self) -> None:
        """The master primary orders an EMPTY batch on any ledger that has
        gone STATE_FRESHNESS_UPDATE_INTERVAL without an update, so BLS
        state signatures stay fresh and non-primaries can tell a quiet
        primary from a dead one (ref ordering_service.py:1991
        _send_3pc_freshness_batch + FreshnessChecker)."""
        if not self._data.is_master:
            return
        interval = self._config.STATE_FRESHNESS_UPDATE_INTERVAL
        if interval <= 0:
            return
        now = self._timer.get_current_time()
        for lid in list(self.request_queues):
            if lid == AUDIT_LEDGER_ID:
                continue      # the audit ledger only moves with real batches
            due = self._freshness_deadline.get(lid)
            if due is None:
                self._freshness_deadline[lid] = now + interval
            elif now >= due:
                self.send_3pc_batch(lid, force_empty=True)

    def send_3pc_batch(self, ledger_id: Optional[int] = None,
                       force_empty: bool = False) -> int:
        """Create and broadcast PRE-PREPAREs from queued requests
        (ref send_3pc_batch :1961). Returns number of batches sent."""
        sent = 0
        now = self._timer.get_current_time()
        # effective knobs: controller-steered when the loop is closed,
        # static config otherwise
        ctl = self._controller
        max_size = (ctl.batch_size if ctl is not None
                    else self._config.Max3PCBatchSize)
        max_wait = (ctl.batch_wait if ctl is not None
                    else self._config.Max3PCBatchWait)
        depth = (ctl.depth if ctl is not None
                 else self._config.Max3PCBatchesInFlight)
        ledgers = [ledger_id] if ledger_id is not None else list(self.request_queues)
        for lid in ledgers:
            queue = self.request_queues.setdefault(lid, OrderedDict())
            if not queue and not force_empty:
                continue
            # Partial batches wait up to the batch wait for more requests
            # (full ones cut immediately). The wait is measured from the
            # OLDEST queued request's own enqueue stamp (the queue value):
            # the previous per-ledger clock was re-armed every prod tick
            # that left leftovers behind — e.g. while the in-flight gate
            # held — so under a steady trickle a partial batch could wait
            # far past the configured bound.
            if (not force_empty and len(queue) < max_size
                    and now - next(iter(queue.values())) < max_wait):
                continue
            while queue or force_empty:
                if self._data.pp_seq_no + 1 > self._data.high_watermark:
                    break
                # bound the SPECULATIVE window: how far uncommitted applies
                # may run ahead of the last committed batch. Deep by
                # default (the watermark window above is the hard protocol
                # bound; revert-on-view-change unwinds the whole stack),
                # controller-steered so a saturated pool backs off.
                if (not force_empty and self._data.pp_seq_no
                        - self._data.last_ordered_3pc[1] >= depth):
                    break
                digests = []
                oldest_cut = now
                bodyless = []
                while queue and len(digests) < max_size:
                    digest, enq_ts = queue.popitem(last=False)
                    # finalize-without-body guard (digest-gossip): a batch
                    # must never cite a request whose body this primary
                    # does not hold — re-queue it and pull the body
                    if self._get_request(digest) is None:
                        bodyless.append(digest)
                    else:
                        digests.append(digest)
                        oldest_cut = min(oldest_cut, enq_ts)
                # Bodyless digests are re-queued with a FRESH stamp: they
                # cannot be batched until a body lands anyway, so the
                # restart is harmless, it throttles the RequestPropagates
                # retry below to once per batch wait, and a byzantine
                # never-arriving body cannot sit at the queue head aging
                # the wait gate (and the controller's queue-wait
                # attribution) forever.
                for digest in bodyless:
                    queue[digest] = now
                if bodyless:
                    self._bus.send(RequestPropagates(
                        bad_requests=tuple(bodyless)))
                if not digests and not force_empty:
                    break        # everything queued is awaiting its body
                # queue wait attributed from the oldest request actually
                # CUT (a stale bodyless head must not inflate the sample)
                self._send_one_batch(lid, digests,
                                     queue_wait=max(0.0, now - oldest_cut))
                sent += 1
                if force_empty:
                    break
        return sent

    def _send_one_batch(self, ledger_id: int, digests: list[str],
                        queue_wait: float = 0.0) -> None:
        reqs = [r for r in (self._get_request(d) for d in digests) if r is not None]
        pp_time = self._timer.get_current_time()
        view_no = self._data.view_no
        pp_seq_no = self._data.pp_seq_no + 1
        applied = self._apply(ledger_id, reqs, pp_time, view_no, pp_seq_no)
        # req_idr carries ALL digests in apply order (valid AND rejected):
        # validators must re-apply the exact same sequence or a rejection that
        # depends on an earlier request in the same batch would diverge;
        # `discarded` marks which of them dynamic validation refused.
        all_digests = tuple(r.digest for r in reqs)
        params = dict(
            inst_id=self._data.inst_id,
            view_no=view_no,
            pp_seq_no=pp_seq_no,
            pp_time=pp_time,
            req_idr=all_digests,
            discarded=tuple(applied.discarded),
            ledger_id=ledger_id,
            state_root=applied.state_root,
            txn_root=applied.txn_root,
            pool_state_root=applied.pool_state_root,
            audit_txn_root=applied.audit_txn_root,
        )
        params["digest"] = self._batch_digest(params)
        if self._bls is not None:
            params = self._bls.update_pre_prepare(params, self._last_state_root(ledger_id))
        pre_prepare = PrePrepare(**params)
        self._freshness_deadline[ledger_id] = \
            pp_time + self._config.STATE_FRESHNESS_UPDATE_INTERVAL
        self._data.pp_seq_no = pp_seq_no
        self._data.last_batch_timestamp = pp_time
        key = (view_no, pp_seq_no)
        self.sent_preprepares[key] = pre_prepare
        self.prePrepares[key] = pre_prepare
        if self._controller is not None:
            self._controller.note_batch_cut(queue_wait, len(digests))
            self._cut_ts[key] = pp_time
        if self._metrics is not None:
            self._phase_ts[key] = [self._timer.get_current_time(), None]
        if self._tracer.enabled:
            # reqs list links request digests -> this batch for waterfall
            # assembly; seq links the batch -> the durable flush event
            self._tracer.emit(tracing.PP_SENT, pre_prepare.digest,
                              {"seq": pp_seq_no, "ledger": ledger_id,
                               "reqs": list(all_digests)})
        batch_id = BatchID(view_no, _orig_view(pre_prepare),
                           pp_seq_no, pre_prepare.digest)
        self._data.preprepare_batch(batch_id)
        if self._data.is_master:
            self._applied_unordered.append((ledger_id, batch_id))
        elif self.on_backup_pp_sent is not None:
            # backup primaries have no audit trail to restore from; the
            # node persists their last-sent seq-no so a restart resumes
            # the numbering instead of re-issuing pp_seq_no 1
            # (ref last_sent_pp_store_helper.py)
            self.on_backup_pp_sent(self._data.inst_id, view_no, pp_seq_no)
        self._network.send(pre_prepare)

    def _apply(self, ledger_id, reqs, pp_time, view_no, pp_seq_no) -> AppliedBatch:
        if self._data.is_master and self._executor is not None:
            # primaries resolution is the executor's: the audit ledger is
            # the exact historical record (write_manager._resolve_primaries)
            return self._timed_apply(
                ledger_id, reqs, pp_time, view_no, pp_seq_no,
                primaries=(list(self._data.primaries)
                           if view_no == self._data.view_no else None))
        digests = tuple(r.digest for r in reqs)
        return AppliedBatch("", "", "", "", digests, ())

    def _timed_apply(self, ledger_id, reqs, pp_time, view_no, pp_seq_no,
                     primaries=None) -> AppliedBatch:
        """executor.apply_batch under the commit-path apply-stage timer —
        every uncommitted apply (fresh batch, peer pre-prepare, view-change
        re-apply) lands in the same stage bucket."""
        t0 = time.perf_counter()
        try:
            return self._executor.apply_batch(
                ledger_id, reqs, pp_time, view_no, pp_seq_no,
                primaries=primaries)
        finally:
            if self._metrics is not None:
                self._metrics.add_event(MetricsName.COMMIT_APPLY_TIME,
                                        time.perf_counter() - t0)
            if self._tracer.enabled:
                # keyed by seq (the batch digest does not exist yet for a
                # fresh batch being minted); wall duration only when the
                # tracer allows it (replay determinism)
                data = {"seq": pp_seq_no, "n": len(reqs)}
                if self._tracer.wall_durations:
                    data["dur"] = time.perf_counter() - t0
                self._tracer.emit(tracing.APPLY, "", data)

    def _last_state_root(self, ledger_id: int) -> str:
        """State root of the previous batch on this ledger (what the previous
        multi-sig signed) — used to look up the sig to embed."""
        for key in sorted(self.prePrepares, reverse=True):
            pp = self.prePrepares[key]
            if pp.ledger_id == ledger_id and key in self.ordered:
                return pp.state_root
        return ""

    @staticmethod
    def _batch_digest(pp) -> str:
        """Digest binding the FULL batch content — req set, rejection set,
        roots, time, ledger — under its ORIGINAL view. Anything not bound
        here could be mutated by a lying MessageRep responder and still
        pass the f+1-prepare certification, framing the primary (or, on
        executor-less backups, forking the instance)."""
        import hashlib
        get = pp.get if isinstance(pp, dict) else \
            lambda k, d=None: getattr(pp, k, d)
        orig_view = get("original_view_no")
        view = orig_view if orig_view is not None else get("view_no")
        h = hashlib.sha256()
        h.update(f"{view}:{get('pp_seq_no')}:{get('ledger_id')}:"
                 f"{get('pp_time')!r}:".encode())
        for d in get("req_idr"):
            h.update(b"\x00" + d.encode())
        for d in get("discarded"):
            h.update(b"\x01" + d.encode())
        for root in (get("state_root"), get("txn_root"),
                     get("audit_txn_root"), get("pool_state_root")):
            h.update(b"\x02" + (root or "").encode())
        return h.hexdigest()

    # ------------------------------------------------------------------ #
    # admission control                                                  #
    # ------------------------------------------------------------------ #

    def _validate(self, msg) -> object:
        """PROCESS / DISCARD / STASH(reason) — ref ordering_service_msg_validator."""
        if msg.inst_id != self._data.inst_id:
            return DISCARD
        if not self._data.is_participating:
            return STASH(StashReason.CATCHING_UP)
        if msg.view_no < self._data.view_no:
            return DISCARD
        if msg.view_no > self._data.view_no:
            return STASH(StashReason.FUTURE_VIEW)
        if self._data.waiting_for_new_view:
            return STASH(StashReason.WAITING_FOR_NEW_VIEW)
        if (msg.view_no, msg.pp_seq_no) in self.ordered:
            return DISCARD
        if msg.pp_seq_no <= self._data.low_watermark:
            return DISCARD
        if msg.pp_seq_no > self._data.high_watermark:
            return STASH(StashReason.OUTSIDE_WATERMARKS)
        return PROCESS

    def _suspect(self, suspicion, sender: str) -> None:
        self._bus.send(RaisedSuspicion(inst_id=self._data.inst_id,
                                       code=suspicion.code,
                                       reason=f"{suspicion.reason} (from {sender})",
                                       sender=sender))

    # ------------------------------------------------------------------ #
    # PRE-PREPARE                                                        #
    # ------------------------------------------------------------------ #

    def process_preprepare(self, msg: PrePrepare, sender: str):
        verdict = self._validate(msg)
        if verdict is not PROCESS:
            return verdict
        if sender != self._data.primary_name:
            self._suspect(Suspicions.PPR_FRM_NON_PRIMARY, sender)
            return DISCARD
        key = (msg.view_no, msg.pp_seq_no)
        if key in self.prePrepares and self.prePrepares[key].digest != msg.digest:
            self._suspect(Suspicions.DUPLICATE_PPR_SENT, sender)
            return DISCARD
        # The digest must actually bind the batch content — everything
        # downstream (prepares, commits, message-req recovery) anchors on it.
        # Re-ordered batches keep the digest minted in their original view.
        if msg.digest != self._batch_digest(msg):
            self._suspect(Suspicions.PPR_DIGEST_WRONG, sender)
            return DISCARD
        if key in self.sent_preprepares:
            return PROCESS                         # our own broadcast echoed
        # Re-ordered batches legitimately carry their original timestamp; only
        # fresh batches face the clock-deviation check.
        is_reordered = (msg.original_view_no is not None
                        and msg.original_view_no != msg.view_no)
        now = self._timer.get_current_time()
        if (not is_reordered and
                abs(msg.pp_time - now) > self._config.ACCEPTABLE_DEVIATION_PREPREPARE_SECS):
            self._suspect(Suspicions.PPR_TIME_WRONG, sender)
            return DISCARD
        # A backup instance entering a new view adopts the first pre-prepare
        # it sees as its position — backup sequences have no cross-view
        # continuity guarantee, and without this a backup that lagged at
        # view-change time stalls forever (silently disabling the monitor's
        # master-vs-backup comparison). Ref _setup_last_ordered_for_non_master.
        if self._needs_last_ordered_setup and not self._data.is_master:
            if msg.pp_seq_no - 1 > self._data.last_ordered_3pc[1]:
                self._data.last_ordered_3pc = (msg.view_no, msg.pp_seq_no - 1)
                self._data.pp_seq_no = max(self._data.pp_seq_no,
                                           msg.pp_seq_no - 1)
            self._needs_last_ordered_setup = False
        # Expect strictly consecutive batches from one primary.
        expected = self._last_preprepared_seq() + 1
        if msg.pp_seq_no > expected:
            return STASH(StashReason.FUTURE_3PC)
        # All referenced requests must be finalized locally before we can apply.
        missing = [d for d in msg.req_idr if self._get_request(d) is None]
        if missing and self._data.is_master:
            self._bus.send(RequestPropagates(bad_requests=tuple(missing)))
            return STASH(StashReason.MISSING_REQUESTS)
        if self._bls is not None:
            fault = self._bls.validate_pre_prepare(msg, sender)
            if fault is not None:
                self._suspect(Suspicions.PPR_BLS_MULTISIG_WRONG, sender)
                return DISCARD
        return self._process_valid_preprepare(msg, sender)

    def _last_preprepared_seq(self) -> int:
        seqs = [k[1] for k in self.prePrepares if k[0] == self._data.view_no]
        floor = max(self._data.low_watermark, self._data.last_ordered_3pc[1])
        return max(seqs + [floor])

    def _process_valid_preprepare(self, msg: PrePrepare, sender: str):
        key = (msg.view_no, msg.pp_seq_no)
        # A re-ordered incarnation of a batch whose effects our state already
        # contains: either we executed it ourselves (digest recorded) or a
        # catchup advanced us past its seq_no. This pass only re-certifies it
        # into the new view (vote, count quorums) — never re-apply. If we
        # executed a DIFFERENT batch at this seq_no, voting would endorse a
        # fork — discard and let the suspicion machinery handle the primary.
        rerun = msg.pp_seq_no <= self._data.last_ordered_3pc[1]
        if rerun:
            known = self._ordered_originals.get(
                (_orig_view(msg), msg.pp_seq_no))
            if known is not None and known != msg.digest:
                self._suspect(Suspicions.PPR_DIGEST_WRONG, sender)
                return DISCARD
        # Re-apply the batch and cross-check every root (ref :871-931).
        if self._data.is_master and self._executor is not None and not rerun:
            reqs = [self._get_request(d) for d in msg.req_idr]
            # apply under the ORIGINAL view: the audit txn snapshots
            # (viewNo, primaries), and a re-ordered batch must reproduce the
            # audit root minted in its original view
            orig = _orig_view(msg)
            applied = self._timed_apply(
                msg.ledger_id, reqs, msg.pp_time, orig, msg.pp_seq_no,
                primaries=(list(self._data.primaries)
                           if orig == self._data.view_no else None))
            fault = None
            if tuple(applied.discarded) != tuple(msg.discarded):
                fault = Suspicions.PPR_REJECT_WRONG
            elif applied.state_root != msg.state_root:
                fault = Suspicions.PPR_STATE_WRONG
            elif applied.txn_root != msg.txn_root:
                fault = Suspicions.PPR_TXN_WRONG
            elif (msg.audit_txn_root and
                  applied.audit_txn_root != msg.audit_txn_root):
                fault = Suspicions.PPR_AUDIT_TXN_ROOT_WRONG
            if fault is not None:
                self._executor.revert_last_batch(msg.ledger_id)
                self._suspect(fault, sender)
                return DISCARD
            batch_id = BatchID(msg.view_no, _orig_view(msg),
                               msg.pp_seq_no, msg.digest)
            self._applied_unordered.append((msg.ledger_id, batch_id))
        else:
            batch_id = BatchID(msg.view_no, _orig_view(msg),
                               msg.pp_seq_no, msg.digest)
        self.prePrepares[key] = msg
        if self._metrics is not None:
            self._phase_ts[key] = [self._timer.get_current_time(), None]
        if self._tracer.enabled:
            self._tracer.emit(tracing.PP_RECV, msg.digest,
                              {"seq": msg.pp_seq_no, "frm": sender,
                               "reqs": list(msg.req_idr)})
        self._data.preprepare_batch(batch_id)
        # Commits that raced ahead of this pre-prepare: validate their BLS
        # sigs now that we know the signed roots; evict liars.
        if self._bls is not None:
            for voter, commit in list(self.commits.get(key, {}).items()):
                if self._bls.validate_commit(commit, voter, msg) is not None:
                    del self.commits[key][voter]
                    self._suspect(Suspicions.CM_BLS_WRONG, voter)
                else:
                    self._bls.process_commit(commit, voter)
        self._send_prepare(msg)
        # A stashed future pre-prepare may now be consecutive.
        self._stasher.process_all_stashed(StashReason.FUTURE_3PC)
        self._try_prepare_quorum(key)
        return PROCESS

    def _send_prepare(self, pp: PrePrepare) -> None:
        if self.is_primary:
            return                                  # primary never sends PREPARE
        prepare = Prepare(inst_id=pp.inst_id, view_no=pp.view_no,
                          pp_seq_no=pp.pp_seq_no, pp_time=pp.pp_time,
                          digest=pp.digest, state_root=pp.state_root,
                          txn_root=pp.txn_root, audit_txn_root=pp.audit_txn_root)
        self._network.send(prepare)
        # Our own vote counts toward the prepare quorum.
        key = (pp.view_no, pp.pp_seq_no)
        self.prepares.setdefault(key, {})[self._data.node_name] = prepare

    # ------------------------------------------------------------------ #
    # PREPARE                                                            #
    # ------------------------------------------------------------------ #

    def process_prepare(self, msg: Prepare, sender: str):
        verdict = self._validate(msg)
        if verdict is not PROCESS:
            return verdict
        if sender == self._data.primary_name:
            self._suspect(Suspicions.PR_FRM_PRIMARY, sender)
            return DISCARD
        key = (msg.view_no, msg.pp_seq_no)
        votes = self.prepares.setdefault(key, {})
        if sender in votes:
            if votes[sender].digest != msg.digest:
                self._suspect(Suspicions.DUPLICATE_PR_SENT, sender)
            return DISCARD
        pp = self.prePrepares.get(key)
        if pp is not None and msg.digest != pp.digest:
            self._suspect(Suspicions.PR_DIGEST_WRONG, sender)
            return DISCARD
        votes[sender] = msg
        if pp is None:
            self._maybe_request_preprepare(key)
        self._try_prepare_quorum(key)
        return PROCESS

    def _try_prepare_quorum(self, key: tuple[int, int]) -> None:
        pp = self.prePrepares.get(key)
        if pp is None or key in self._commits_sent:
            return
        votes = self.prepares.get(key, {})
        matching = sum(1 for p in votes.values() if p.digest == pp.digest)
        if not self._data.quorums.prepare.is_reached(matching):
            return
        self._data.prepare_batch(BatchID(pp.view_no, _orig_view(pp),
                                         pp.pp_seq_no, pp.digest))
        ts = self._phase_ts.get(key)
        if ts is not None and ts[1] is None:
            ts[1] = self._timer.get_current_time()
            self._metrics.add_event(MetricsName.PREPARE_PHASE_TIME,
                                    ts[1] - ts[0])
        if self._tracer.enabled:
            self._tracer.emit(tracing.PREPARE_QUORUM, pp.digest,
                              {"seq": key[1], "votes": matching})
        self._send_commit(pp, key)

    def _send_commit(self, pp: PrePrepare, key: tuple[int, int]) -> None:
        params = dict(inst_id=pp.inst_id, view_no=key[0], pp_seq_no=key[1])
        if self._bls is not None:
            params = self._bls.update_commit(params, pp)
        commit = Commit(**params)
        self._commits_sent.add(key)
        if self._tracer.enabled:
            self._tracer.emit(tracing.COMMIT_SENT, pp.digest,
                              {"seq": key[1]})
        self._network.send(commit)
        # Count our own commit vote.
        self.commits.setdefault(key, {})[self._data.node_name] = commit
        if self._bls is not None:
            self._bls.process_commit(commit, self._data.node_name)
        self._try_order(key)

    # ------------------------------------------------------------------ #
    # COMMIT                                                             #
    # ------------------------------------------------------------------ #

    def process_commit(self, msg: Commit, sender: str):
        verdict = self._validate(msg)
        if verdict is not PROCESS:
            # A COMMIT landing after its batch ordered is stale for 3PC but
            # may carry the BLS signature the pending multi-sig aggregation
            # is WAITING on: a batch orders at quorum n-f commits, and if a
            # bad signer is among those first arrivals the honest aggregate
            # falls short until a late sig lands — which used to be
            # discarded here, starving the retry forever (one Byzantine
            # signer suppressed multi-sigs on every node that counted its
            # commit toward the ordering quorum). Strictly this instance's
            # own sig-carrying commits (backup instances broadcast sig-less
            # commits that must not shadow the master's), and only the BLS
            # side sees them — the 3PC vote table stays untouched.
            if (verdict is DISCARD and self._bls is not None
                    and msg.inst_id == self._data.inst_id
                    and msg.bls_sig is not None):
                key = (msg.view_no, msg.pp_seq_no)
                pp = self.prePrepares.get(key)
                if (key in self.ordered and pp is not None
                        and self._bls.validate_commit(msg, sender, pp)
                        is None):
                    self._bls.process_commit(msg, sender)
            return verdict
        key = (msg.view_no, msg.pp_seq_no)
        votes = self.commits.setdefault(key, {})
        if sender in votes:
            return DISCARD
        pp = self.prePrepares.get(key)
        if pp is not None and self._bls is not None:
            fault = self._bls.validate_commit(msg, sender, pp)
            if fault is not None:
                self._suspect(Suspicions.CM_BLS_WRONG, sender)
                return DISCARD
        votes[sender] = msg
        # A commit arriving before its pre-prepare can't have its BLS sig
        # checked yet; _process_valid_preprepare re-validates stored votes, so
        # only validated sigs ever reach aggregation.
        if pp is not None and self._bls is not None:
            self._bls.process_commit(msg, sender)
        if pp is None:
            self._maybe_request_preprepare(key)
        self._try_order(key)
        return PROCESS

    # ------------------------------------------------------------------ #
    # missing-message recovery (ref message_req_processor.py)            #
    # ------------------------------------------------------------------ #

    def _maybe_request_preprepare(self, key: tuple[int, int]) -> None:
        """PREPARE votes certify a pre-prepare we never received (lost on the
        wire): ask peers for it instead of waiting for a full catchup."""
        votes = self.prepares.get(key, {})
        if not votes:
            return
        from collections import Counter
        digest, count = Counter(
            p.digest for p in votes.values()).most_common(1)[0]
        if not self._data.quorums.weak.is_reached(count):
            return
        self._bus.send(MissingMessage(
            msg_type="PREPREPARE",
            key={"inst_id": self._data.inst_id,
                 "view_no": key[0], "pp_seq_no": key[1]},
            inst_id=self._data.inst_id, dst=None, stash_data=(digest,)))

    def process_requested_preprepare(self, msg: PrePrepare) -> None:
        """A peer-served pre-prepare. NEVER taken on trust: it is only
        admitted if f+1 PREPARE votes we independently received certify its
        exact digest — a lying responder cannot inject state, because f+1
        matching prepares contain at least one honest vote for the real
        message."""
        key = (msg.view_no, msg.pp_seq_no)
        if key in self.ordered or key in self.prePrepares:
            return
        # The digest certified by the prepares must really hash THIS content —
        # otherwise a lying responder could attach the certified digest to a
        # mutated batch (different req_idr, roots, or time) and either frame
        # the primary or fork an executor-less backup.
        if msg.digest != self._batch_digest(msg):
            return
        votes = self.prepares.get(key, {})
        matching = sum(1 for p in votes.values() if p.digest == msg.digest)
        if not self._data.quorums.weak.is_reached(matching):
            return
        # Certified: run it through the NORMAL admission path (as if the
        # primary's original broadcast had just arrived) so every stash
        # reason — missing requests, catching up, watermarks — keeps its
        # usual replay semantics instead of silently dropping the recovery.
        self._stasher.dispatch(msg, self._data.primary_name)

    # ------------------------------------------------------------------ #
    # ordering                                                           #
    # ------------------------------------------------------------------ #

    def behind_evidence(self) -> Optional[int]:
        """Highest pp_seq_no with COMMITs from a weak quorum (f+1 distinct
        senders — at least one honest) strictly ahead of our next orderable
        position: proof a live pool is committing past this replica (it
        can never order those without recovering the gap). Weak, not full:
        a node that was down or syncing while the commits flew holds only
        a partial vote record (partition-heal fuzz seed 3362 sat forever
        behind a pool whose full-quorum messages it had half-missed).
        None when no such evidence exists."""
        last = self._data.last_ordered_3pc[1]
        votes_by_key: dict[tuple[int, int], set[str]] = {
            k: set(v) for k, v in self.commits.items() if k[1] > last + 1}
        # Commits the admission gate PARKED never reach self.commits, yet
        # a weak quorum of them is the same proof the pool committed past
        # us. The blind spot this closes (membership-churn fuzz): a node
        # whose stale registry makes it wait for a NEW_VIEW that will
        # never validate stashes the entire pool's ordering traffic under
        # WAITING_FOR_NEW_VIEW and looks "not behind" forever; likewise a
        # re-promoted straggler whose gap exceeds the watermark window
        # (OUTSIDE_WATERMARKS) or whose pool moved views (FUTURE_VIEW).
        for queue in self._stasher._queues.values():
            for message, args, _handler in queue:
                if isinstance(message, Commit) and message.pp_seq_no > last + 1:
                    votes_by_key.setdefault(
                        (message.view_no, message.pp_seq_no),
                        set()).add(args[0] if args else "")
        best = None
        for k, votes in votes_by_key.items():
            if self._data.quorums.weak.is_reached(len(votes)):
                best = k[1] if best is None else max(best, k[1])
        return best

    def _stage_batch(self, pp: PrePrepare) -> bool:
        """Re-stage an in-flight batch's uncommitted apply (the catchup
        re-apply twin of _process_valid_preprepare's admission apply):
        fetch requests, apply under the ORIGINAL view, cross-check every
        root the pre-prepare claims, consume the requests from the queues.
        -> False (with the apply reverted) when the batch cannot be staged
        faithfully — missing requests or non-reproducing roots."""
        reqs = [self._get_request(d) for d in pp.req_idr]
        if any(r is None for r in reqs):
            return False
        orig = _orig_view(pp)
        applied = self._timed_apply(
            pp.ledger_id, reqs, pp.pp_time, orig, pp.pp_seq_no,
            primaries=(list(self._data.primaries)
                       if orig == self._data.view_no else None))
        if (applied.state_root != pp.state_root
                or applied.txn_root != pp.txn_root
                or (pp.audit_txn_root
                    and applied.audit_txn_root != pp.audit_txn_root)):
            self._executor.revert_last_batch(pp.ledger_id)
            return False
        self._applied_unordered.append(
            (pp.ledger_id, BatchID(pp.view_no, orig,
                                   pp.pp_seq_no, pp.digest)))
        # catchup_started's revert re-queued these requests; they ride
        # THIS re-applied batch — leaving them queued would double-order
        # them in a later fresh batch (fuzz seed 45)
        for queue in self.request_queues.values():
            for d in pp.req_idr:
                queue.pop(d, None)
        return True

    def _can_order(self, key: tuple[int, int]) -> bool:
        if key in self.ordered:
            return False
        if self.prePrepares.get(key) is None:
            return False
        if key not in self._commits_sent:
            return False                 # we haven't prepared it ourselves yet
        votes = len(self.commits.get(key, {}))
        return self._data.quorums.commit.is_reached(votes)

    def _try_order(self, key: tuple[int, int]) -> None:
        if not self._can_order(key):
            return
        pp = self.prePrepares[key]
        # In-order constraint: pp_seq_no must directly follow the last ordered
        # batch; otherwise stash the completed commit (ref :191,1642).
        if key[1] != self._data.last_ordered_3pc[1] + 1:
            self._stashed_ooo_commits[key] = pp
            return
        self._order(key, pp)
        # Drain any consecutive stashed completions.
        while True:
            next_key = self._find_stashed_next()
            if next_key is None:
                break
            self._order(next_key, self._stashed_ooo_commits.pop(next_key))

    def _find_stashed_next(self):
        for k in sorted(self._stashed_ooo_commits):
            if k[1] == self._data.last_ordered_3pc[1] + 1 and self._can_order(k):
                return k
        return None

    def _order(self, key: tuple[int, int], pp: PrePrepare) -> None:
        ts = self._phase_ts.pop(key, None)
        if ts is not None and self._metrics is not None:
            now = self._timer.get_current_time()
            if ts[1] is not None:
                self._metrics.add_event(MetricsName.COMMIT_PHASE_TIME,
                                        now - ts[1])
            self._metrics.add_event(MetricsName.ORDERING_TIME, now - ts[0])
        t_cut = self._cut_ts.pop(key, None)
        if t_cut is not None and self._controller is not None:
            # cut -> commit quorum on the injectable timer: the 3PC span
            # sample the controller steers depth/size against
            self._controller.note_ordered(
                self._timer.get_current_time() - t_cut)
        if self._tracer.enabled:
            self._tracer.emit(tracing.ORDERED, pp.digest,
                              {"seq": key[1],
                               "votes": len(self.commits.get(key, {}))})
        orig_key = (_orig_view(pp), pp.pp_seq_no)
        rerun = self._ordered_originals.get(orig_key) == pp.digest
        self.ordered.add(key)
        self._ordered_originals[orig_key] = pp.digest
        self._data.last_ordered_3pc = key
        # Ordered requests must never be re-proposed from this node's queue.
        for queue in self.request_queues.values():
            for digest in pp.req_idr:
                queue.pop(digest, None)
        batch_id = BatchID(pp.view_no, _orig_view(pp),
                           pp.pp_seq_no, pp.digest)
        # NOTE: the batch's prepared/preprepared certificate deliberately
        # SURVIVES ordering (gc() drops it at checkpoint stabilization): a
        # view change before the covering checkpoint must still carry this
        # certificate, or peers that didn't order it can never recover it
        # and the new primary could even mint a different batch at this
        # seq_no (fork). Found by the seeded view-change fuzz.
        self._applied_unordered = [(lid, b) for (lid, b) in self._applied_unordered
                                   if b != batch_id]
        if self._bls is not None:
            self._bls.process_order(key, pp)
        if rerun:
            # already executed under its original view: this pass only
            # re-certified the batch into the new view's 3PC chain
            return
        discarded_set = set(pp.discarded)
        ordered = Ordered(inst_id=pp.inst_id, view_no=key[0],
                          pp_seq_no=key[1], pp_time=pp.pp_time,
                          req_idr=tuple(d for d in pp.req_idr
                                        if d not in discarded_set),
                          discarded=pp.discarded,
                          ledger_id=pp.ledger_id, state_root=pp.state_root,
                          txn_root=pp.txn_root,
                          audit_txn_root=pp.audit_txn_root,
                          original_view_no=pp.original_view_no)
        self._bus.send(ordered)

    # ------------------------------------------------------------------ #
    # revert / catchup / view change                                     #
    # ------------------------------------------------------------------ #

    def revert_unordered_batches(self) -> int:
        """Undo every applied-but-unordered batch, newest first (ref :1229)."""
        count = 0
        while self._applied_unordered:
            ledger_id, batch_id = self._applied_unordered.pop()
            if self._executor is not None and self._data.is_master:
                self._executor.revert_last_batch(ledger_id)
            # The certificate is NOT freed: a reverted-but-prepared batch
            # must keep appearing in this node's ViewChange messages across
            # ESCALATED view changes too (each escalation re-snapshots
            # data.prepared) — gc() at checkpoint stabilization is the only
            # legitimate certificate reaper.
            # Reverted requests go back in the queue (ref :2201) — they will
            # either be re-ordered from the old-view pre-prepare or re-batched.
            pp = self.prePrepares.get((batch_id.view_no, batch_id.pp_seq_no))
            if pp is not None:
                queue = self.request_queues.setdefault(ledger_id, OrderedDict())
                now = self._timer.get_current_time()
                for digest in pp.req_idr:
                    # re-enqueue with a fresh batch-wait stamp (the original
                    # enqueue time died with the reverted batch); setdefault
                    # so a digest already waiting keeps its older stamp
                    queue.setdefault(digest, now)
            count += 1
        return count

    def catchup_started(self) -> None:
        self.revert_unordered_batches()
        self._data.is_participating = False

    def caught_up_till_3pc(self, last_3pc: tuple[int, int]) -> None:
        """Adopt the 3PC position reached through catchup (ref :2223).

        The stable checkpoint is rounded DOWN to the CHK_FREQ boundary
        (ref checkpoint_service.py:137-139): claiming stability at an
        off-boundary seq-no the rest of the pool holds no certificate for
        deadlocks the next view change — NewViewBuilder.calc_checkpoint
        requires a strong quorum whose stable <= the selected checkpoint,
        and no candidate at the off-boundary height can exist. A node
        restored to seq 1 therefore reports stable 0 (which every node's
        'initial' checkpoint satisfies), not 1.
        """
        if last_3pc > self._data.last_ordered_3pc:
            chk = max(1, self._config.CHK_FREQ)
            boundary = last_3pc[1] // chk * chk
            self._data.last_ordered_3pc = last_3pc
            self._data.pp_seq_no = max(self._data.pp_seq_no, last_3pc[1])
            self._data.low_watermark = max(self._data.low_watermark, boundary)
            self._data.stable_checkpoint = max(self._data.stable_checkpoint,
                                               boundary)
        # Everything at or below the RESULTING position is history. The
        # bound is our CURRENT last_ordered, not the raw catchup target:
        # ordering can keep advancing while a (possibly stale-quorum)
        # catchup is in flight, and cleaning/re-staging against the lower
        # target re-staged batches whose effects were already committed —
        # the write manager then held phantom applies and crashed at the
        # next real commit ("commit out of order", partition-heal fuzz).
        # The pre-prepares themselves stay fetchable as old-view material:
        # a later NewView below a stable checkpoint may cite these exact
        # batches, and a pool where every retainer pruned them wedges all
        # re-proposal at the first unfetchable citation.
        pos = self._data.last_ordered_3pc[1]
        for k, pp in list(self.prePrepares.items()):
            if k[1] <= pos:
                orig = pp.original_view_no \
                    if pp.original_view_no is not None else k[0]
                self.old_view_preprepares[(orig, k[1])] = pp
        for store in (self.prePrepares, self.sent_preprepares,
                      self.prepares, self.commits):
            for k in [k for k in store if k[1] <= pos]:
                del store[k]
        self._stashed_ooo_commits = {
            k: v for k, v in self._stashed_ooo_commits.items()
            if k[1] > pos}
        # In-flight batches ABOVE the caught-up position lost their staged
        # applies when catchup_started reverted the uncommitted stack; the
        # stashed commits about to process would otherwise order them with
        # nothing staged to commit ("commit with no applied batches" —
        # partition-heal fuzz). Re-apply them in seq order via the shared
        # staging helper (same root cross-check as first admission).
        # ONLY current-view entries: a view-jump catchup (the node view is
        # adopted before this runs) leaves old-view pre-prepares that can
        # never order directly in this view — re-staging one would corrupt
        # the fresh uncommitted stack and make every later honest batch's
        # roots mismatch. They stay fetchable as old-view material.
        if self._data.is_master and self._executor is not None:
            applied_ids = {b for (_l, b) in self._applied_unordered}
            for key in sorted(self.prePrepares, key=lambda k: k[1]):
                pp = self.prePrepares[key]
                if key in self.ordered or key[0] != self._data.view_no:
                    continue
                if self._ordered_originals.get(
                        (_orig_view(pp), pp.pp_seq_no)) == pp.digest:
                    continue    # re-certified content: executed already
                bid = BatchID(pp.view_no, _orig_view(pp),
                              pp.pp_seq_no, pp.digest)
                if bid in applied_ids:
                    continue
                if not self._stage_batch(pp):
                    # cannot re-stage (requests gone, or roots no longer
                    # reproduce): this and every later in-flight batch is
                    # unrecoverable locally — drop them; the normal
                    # missing-PP recovery or the next NewView re-supplies
                    for k in [k for k in self.prePrepares
                              if k[1] >= key[1]
                              and k[0] == self._data.view_no
                              and k not in self.ordered]:
                        del self.prePrepares[k]
                    break
        self._data.is_participating = True
        if self._last_new_view_msg is not None:
            # a NewView accepted mid-catchup deferred its re-proposal
            # pass (see process_new_view_checkpoints_applied); run it on
            # the caught-up state before releasing the stashed traffic
            self.process_new_view_checkpoints_applied(
                self._last_new_view_msg)
        self._stasher.process_all_stashed(StashReason.CATCHING_UP)
        self._stasher.process_all_stashed(StashReason.OUTSIDE_WATERMARKS)
        # a catchup can JUMP views (audit adoption): messages stashed as
        # future-view are now current-view material — without this drain a
        # straggler that caught up mid-view never processes the 3PC
        # messages for the batches it missed (partition-heal fuzz); still-
        # future ones simply re-stash through _validate
        self._stasher.process_all_stashed(StashReason.FUTURE_VIEW)

    def process_view_change_started(self, msg: ViewChangeStarted) -> None:
        """Entering a view change: revert uncommitted work, remember old-view
        pre-prepares for possible re-ordering (ref :2380)."""
        self._phase_ts.clear()      # timings don't span views
        self._cut_ts.clear()        # controller spans don't span views
        self.revert_unordered_batches()
        # ALL pre-prepares (ordered ones too) become old-view material: a
        # NewView may cite an already-ordered batch, and both the re-sending
        # primary and the MessageReq server look it up by ORIGINAL view here
        for key, pp in self.prePrepares.items():
            orig = pp.original_view_no if pp.original_view_no is not None else key[0]
            self.old_view_preprepares[(orig, key[1])] = pp
        self.prePrepares = {k: v for k, v in self.prePrepares.items()
                            if k in self.ordered}
        self.sent_preprepares.clear()
        self.prepares.clear()
        self.commits.clear()
        self._commits_sent.clear()
        self._stashed_ooo_commits.clear()
        self._awaited_old_view.clear()
        self._awaiting_reproposal.clear()
        self._last_new_view_msg = None
        if not self._data.is_master:
            self._needs_last_ordered_setup = True

    def process_requested_old_view_preprepare(self, pp: PrePrepare) -> None:
        """A peer served an old-view pre-prepare the NewView cited but we
        lacked. Admitted ONLY if its digest matches the NewView citation
        (which a view-change quorum stands behind) and it binds its content."""
        orig = _orig_view(pp)
        key = (orig, pp.pp_seq_no)
        expected = self._awaited_old_view.get(key)
        if expected is None or pp.digest != expected:
            return
        if pp.digest != self._batch_digest(pp):
            return
        del self._awaited_old_view[key]
        self.old_view_preprepares[key] = pp
        if self._last_new_view_msg is not None:
            self.process_new_view_checkpoints_applied(self._last_new_view_msg)

    def process_new_view_checkpoints_applied(self, msg: NewViewCheckpointsApplied) -> None:
        """Re-order the prepared batches carried into the new view
        (ref process_new_view_checkpoints_applied :2380)."""
        self._last_new_view_msg = msg
        if not self._data.is_participating:
            # a view change can complete WHILE this replica catches up
            # (internal-bus traffic bypasses the wire stasher). Applying
            # re-proposals now would stage batches underneath a catchup
            # that writes the same txns straight to the ledgers — phantom
            # applies that crash the next real commit (partition-heal
            # fuzz seed 4175). Defer: caught_up_till_3pc re-enters with
            # the saved NewView once participation resumes.
            return
        self._awaiting_reproposal.clear()   # recomputed by this pass
        # Continue the sequence from what actually survives into the new view:
        # ordered prefix, selected checkpoint, re-ordered batches — and EVERY
        # seq_no the NewView cites, held locally or not. Minting a fresh batch
        # at a cited-but-locally-missing seq_no would be a consensus fork
        # (nodes that ordered the certified batch in the old view hold a
        # different txn at that seq). Only null-certified gaps may be reused.
        cited_seqs = [b[2] for b in msg.batches]
        self._data.pp_seq_no = max([self._data.last_ordered_3pc[1],
                                    msg.checkpoint[2]] + cited_seqs)
        # NOTE batches at or below our last_ordered are NOT skipped: a
        # lagging peer needs the whole quorum to re-run 3PC on them (we
        # vote without re-executing — see the rerun guards); skipping
        # here stranded laggards forever (found by the view-change fuzz).
        #
        # Pass 1: fetch EVERY missing old-view pre-prepare in parallel.
        todo = []
        for (_view, orig_view, pp_seq_no, digest) in sorted(
                msg.batches, key=lambda b: b[2]):
            if pp_seq_no <= msg.checkpoint[2]:
                continue      # below the quorum checkpoint: catchup ground
            if (self._data.view_no, pp_seq_no) in self.prePrepares:
                continue      # already re-ordered (idempotent re-entry)
            old_pp = self.old_view_preprepares.get((orig_view, pp_seq_no))
            if old_pp is None or old_pp.digest != digest:
                # ask peers for the certified old-view pre-prepare instead of
                # silently leaving the gap (ref OldViewPrePrepareRequest
                # ordering_service.py:2409); the rep is validated against the
                # NewView-cited digest before use
                self._awaited_old_view[(orig_view, pp_seq_no)] = digest
                self._bus.send(MissingMessage(
                    msg_type="OLD_VIEW_PREPREPARE",
                    key={"inst_id": self._data.inst_id,
                         "view_no": orig_view, "pp_seq_no": pp_seq_no},
                    inst_id=self._data.inst_id, dst=None))
                old_pp = None
            todo.append((orig_view, pp_seq_no, digest, old_pp))
        # Pass 2: re-send/apply STRICTLY in seq order, stopping at the first
        # still-missing batch — each reply re-enters this method, and
        # applying whatever happened to be available produced out-of-order
        # uncommitted applies (commit then crashed; found by the fuzz).
        for (orig_view, pp_seq_no, digest, old_pp) in todo:
            if old_pp is None:
                if pp_seq_no <= self._data.last_ordered_3pc[1]:
                    # Cited batch is unfetchable (e.g. the whole pool
                    # crash-restarted past it) but its effects are already
                    # in OUR committed state: nothing to re-run for us —
                    # skipping cannot fork us, PROVIDED what we ordered at
                    # this seq matches the citation when we still know it.
                    known = self._ordered_originals.get(
                        (orig_view, pp_seq_no))
                    if known is not None and known != digest:
                        # we ordered a DIFFERENT batch than the quorum
                        # certified (beyond-f damage): resync, don't vote
                        self._awaited_old_view.pop(
                            (orig_view, pp_seq_no), None)
                        self._bus.send(NeedMasterCatchup())
                        break
                    self._awaited_old_view.pop((orig_view, pp_seq_no), None)
                    continue
                break
            # These requests ride the re-ordered batch; don't re-batch them.
            for queue in self.request_queues.values():
                for d in old_pp.req_idr:
                    queue.pop(d, None)
            import dataclasses
            new_pp = dataclasses.replace(old_pp, view_no=self._data.view_no,
                                         original_view_no=orig_view)
            key = (self._data.view_no, pp_seq_no)
            # seq-based like _process_valid_preprepare: _ordered_originals is
            # in-memory only (empty after restart, trimmed by gc), but
            # last_ordered survives restart via the audit restore — a batch
            # at or below it is already in our committed state
            rerun = (pp_seq_no <= self._data.last_ordered_3pc[1]
                     or self._ordered_originals.get(
                         (orig_view, pp_seq_no)) == digest)
            if self.is_primary:
                if self._data.is_master and self._executor is not None \
                        and not rerun:
                    # the primary must HOLD every request to re-apply the
                    # cited batch faithfully; a gap (never propagated to
                    # us, or swept) is fetched and the re-proposal resumes
                    # from this seq when the requests land (process_req_key
                    # re-enters; strict order forbids skipping ahead) —
                    # applying with None holes crashed the write manager
                    # (byzantine fuzz seed 2453)
                    missing = tuple(d for d in new_pp.req_idr
                                    if self._get_request(d) is None)
                    if missing:
                        self._awaiting_reproposal = set(missing)
                        self._bus.send(
                            RequestPropagates(bad_requests=missing))
                        break
                self.sent_preprepares[key] = new_pp
                self.prePrepares[key] = new_pp
                self._data.pp_seq_no = max(self._data.pp_seq_no, pp_seq_no)
                if self._data.is_master and self._executor is not None \
                        and not rerun:
                    reqs = [self._get_request(d) for d in new_pp.req_idr]
                    self._timed_apply(
                        new_pp.ledger_id, reqs, new_pp.pp_time,
                        orig_view, pp_seq_no,
                        primaries=(list(self._data.primaries)
                                   if orig_view == self._data.view_no
                                   else None))
                    self._applied_unordered.append(
                        (new_pp.ledger_id,
                         BatchID(self._data.view_no, orig_view, pp_seq_no, digest)))
                self._data.preprepare_batch(
                    BatchID(self._data.view_no, orig_view, pp_seq_no, digest))
                self._network.send(new_pp)
            else:
                # Non-primaries re-admit the batch through the normal path when
                # the primary's re-sent PRE-PREPARE arrives; nothing to do now.
                self._data.pp_seq_no = max(self._data.pp_seq_no, pp_seq_no)
        self._stasher.process_all_stashed(StashReason.WAITING_FOR_NEW_VIEW)
        self._stasher.process_all_stashed(StashReason.FUTURE_VIEW)

    # ------------------------------------------------------------------ #
    # GC                                                                 #
    # ------------------------------------------------------------------ #

    def gc(self, stable_3pc: tuple[int, int]) -> None:
        """Drop 3PC log entries at or below a stabilized checkpoint."""
        seq = stable_3pc[1]
        for store in (self.prePrepares, self.sent_preprepares,
                      self.prepares, self.commits, self._phase_ts,
                      self._cut_ts):
            for k in [k for k in store if k[1] <= seq]:
                del store[k]
        # certificate lists follow the same lifetime as the 3PC logs
        self._data.preprepared = [b for b in self._data.preprepared
                                  if b.pp_seq_no > seq]
        self._data.prepared = [b for b in self._data.prepared
                               if b.pp_seq_no > seq]
        self.ordered = {k for k in self.ordered if k[1] > seq}
        self._ordered_originals = {k: v for k, v in
                                   self._ordered_originals.items()
                                   if k[1] > seq}
        self._stashed_ooo_commits = {k: v for k, v in
                                     self._stashed_ooo_commits.items()
                                     if k[1] > seq}
        self._commits_sent = {k for k in self._commits_sent if k[1] > seq}
        self.old_view_preprepares = {k: v for k, v in self.old_view_preprepares.items()
                                     if k[1] > seq}
        if self._bls is not None:
            self._bls.gc(stable_3pc)
        self._stasher.process_all_stashed(StashReason.OUTSIDE_WATERMARKS)
