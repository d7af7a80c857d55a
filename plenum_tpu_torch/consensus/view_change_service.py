"""View change: replace the primary while preserving every batch that could
have been ordered anywhere.

Reference behavior: plenum/server/consensus/view_change_service.py:28 —
on NeedViewChange each node bumps the view, reverts in-flight work
(ViewChangeStarted → OrderingService), broadcasts a ViewChange message carrying
its prepared/preprepared certificates and checkpoints (_build_view_change_msg
:141), and acks other nodes' ViewChange messages to the new primary. The new
primary, holding n-f ViewChange messages each backed by an ack quorum, runs
NewViewBuilder (:358): pick the highest checkpoint supported by a strong
quorum (calc_checkpoint :363), then for every pp_seq_no in the window select
the batch certified prepared by a strong quorum of non-contradicting votes and
preprepared by a weak quorum (calc_batches :398), stopping at the first
null-batch gap. Everyone validates the NewView against their own collected
votes and finishes (_finish_view_change :314).
"""
from __future__ import annotations

import hashlib
from typing import Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.internal_messages import (MissingMessage,
                                                 NeedViewChange,
                                                 VoteForViewChange,
                                                 NewViewAccepted,
                                                 NewViewCheckpointsApplied,
                                                 PrimarySelected,
                                                 RaisedSuspicion,
                                                 ViewChangeStarted)
from plenum_tpu_torch.common.node_messages import (Checkpoint, NewView, ViewChange,
                                             ViewChangeAck)
from plenum_tpu_torch.common.serialization import json_dumps
from plenum_tpu_torch.common.stashing import (DISCARD, PROCESS, STASH, StashReason,
                                        StashingRouter)
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.config import Config

from .batch_id import BatchID
from .consensus_shared_data import ConsensusSharedData
from .primary_selector import RoundRobinPrimariesSelector


def view_change_digest(vc: ViewChange) -> str:
    return hashlib.sha256(json_dumps(vc.to_dict()).encode()).hexdigest()


class NewViewBuilder:
    """Pure selection rules over a set of ViewChange votes (ref :358-493)."""

    def __init__(self, data: ConsensusSharedData):
        self._data = data

    def calc_checkpoint(self, vcs: list[ViewChange]) -> Optional[tuple]:
        best: Optional[tuple] = None
        for vc in vcs:
            for cp in vc.checkpoints:
                cp = tuple(cp)
                end = cp[2]
                # enough nodes could still use it (their stable <= end)
                usable = sum(1 for v in vcs if end >= v.stable_checkpoint)
                if not self._data.quorums.strong.is_reached(usable):
                    continue
                # enough nodes actually hold it
                holders = sum(1 for v in vcs if cp in {tuple(c) for c in v.checkpoints})
                if not self._data.quorums.strong.is_reached(holders):
                    continue
                if best is None or end > best[2]:
                    best = cp
        return best

    def calc_batches(self, cp: tuple, vcs: list[ViewChange]) -> Optional[list[BatchID]]:
        batches: list[BatchID] = []
        pp_seq_no = cp[2] + 1
        while pp_seq_no <= cp[2] + self._data.log_size:
            bid = self._find_batch(vcs, pp_seq_no)
            if bid is not None:
                batches.append(bid)
                pp_seq_no += 1
                continue
            if self._null_batch_certified(vcs, pp_seq_no):
                break                    # sequential ordering: stop at first gap
            return None                  # quorum not yet available
        return batches

    def _find_batch(self, vcs, pp_seq_no) -> Optional[BatchID]:
        # Among all certified candidates at this seq, pick the highest-view
        # certificate (PBFT selection rule: a batch prepared in a later view
        # supersedes earlier ones), tie-broken fully deterministically so the
        # primary and every validator compute the identical NewView.
        best: Optional[BatchID] = None
        for vc in vcs:
            for raw in vc.prepared:
                bid = BatchID.from_seq(raw)
                if bid.pp_seq_no != pp_seq_no:
                    continue
                if best is not None and (bid.view_no, bid.pp_view_no,
                                         bid.pp_digest) <= \
                        (best.view_no, best.pp_view_no, best.pp_digest):
                    continue
                if (self._prepared_certified(bid, vcs)
                        and self._preprepared_certified(bid, vcs)):
                    best = bid
        return best

    def _prepared_certified(self, bid: BatchID, vcs) -> bool:
        def not_contradicting(vc: ViewChange) -> bool:
            if bid.pp_seq_no <= vc.stable_checkpoint:
                return False
            for raw in vc.prepared:
                other = BatchID.from_seq(raw)
                if other.pp_seq_no != bid.pp_seq_no:
                    continue
                # A vote contradicts unless it is from an older view, or the
                # same view with identical identity.
                if other.view_no > bid.view_no:
                    return False
                if other.view_no >= bid.view_no and (
                        other.pp_digest != bid.pp_digest
                        or other.pp_view_no != bid.pp_view_no):
                    return False
            return True
        return self._data.quorums.strong.is_reached(
            sum(1 for vc in vcs if not_contradicting(vc)))

    def _preprepared_certified(self, bid: BatchID, vcs) -> bool:
        def witnessed(vc: ViewChange) -> bool:
            for raw in vc.preprepared:
                other = BatchID.from_seq(raw)
                if (other.pp_seq_no == bid.pp_seq_no
                        and other.pp_view_no == bid.pp_view_no
                        and other.pp_digest == bid.pp_digest
                        and other.view_no >= bid.view_no):
                    return True
            return False
        return self._data.quorums.weak.is_reached(
            sum(1 for vc in vcs if witnessed(vc)))

    def _null_batch_certified(self, vcs, pp_seq_no) -> bool:
        def has_no_prepare(vc: ViewChange) -> bool:
            if pp_seq_no <= vc.stable_checkpoint:
                return False
            return all(BatchID.from_seq(raw).pp_seq_no != pp_seq_no
                       for raw in vc.prepared)
        return self._data.quorums.strong.is_reached(
            sum(1 for vc in vcs if has_no_prepare(vc)))


class ViewChangeService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 config: Optional[Config] = None,
                 selector: Optional[RoundRobinPrimariesSelector] = None,
                 instance_count: int = 1,
                 rtt=None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self._selector = selector or RoundRobinPrimariesSelector()
        self._instance_count = instance_count
        self._builder = NewViewBuilder(data)
        # shared RTT estimate (node wires the catchup leecher's): a WAN
        # pool's view change legitimately takes many slow round trips —
        # the escalation timeout scales UP with measured RTT so a degraded
        # link doesn't read as a dead primary and storm view+2 escalations.
        # Never scales DOWN below the configured timeout: the flat config
        # stays the floor, so clean-LAN behavior is unchanged.
        self._rtt = rtt
        self._probe_backoff = None       # armed per view change
        # PBFT liveness: consecutive failed view changes DOUBLE the next
        # escalation timeout (reset on completion). Without growth, a WAN
        # where one view change takes 1.1x the flat timeout escalates
        # forever — each attempt aborted exactly before it can finish.
        self._escalations = 0

        # per view: author node -> ViewChange
        self._view_changes: dict[int, dict[str, ViewChange]] = {}
        # per view: vc digest -> set of ack'ing nodes
        self._acks: dict[int, dict[tuple[str, str], set[str]]] = {}
        self._new_view: Optional[NewView] = None
        # A NewView citing votes we haven't received yet, retried on each vote.
        self._pending_new_view: Optional[tuple[NewView, str]] = None

        self._stasher = StashingRouter()
        self._stasher.subscribe(ViewChange, self.process_view_change)
        self._stasher.subscribe(ViewChangeAck, self.process_view_change_ack)
        self._stasher.subscribe(NewView, self.process_new_view)
        self._stasher.subscribe_to(network)

        bus.subscribe(NeedViewChange, self.process_need_view_change)

    def set_instance_count(self, n: int) -> None:
        """Pool membership changed f: the NEXT view change selects this
        many primaries (ref adjustReplicas node.py:1260 — the instance
        count follows f, not the view)."""
        self._instance_count = n

    # --- starting a view change ------------------------------------------

    def process_need_view_change(self, msg: NeedViewChange) -> None:
        proposed = msg.view_no if msg.view_no is not None else self._data.view_no + 1
        if proposed <= self._data.view_no and self._data.view_no != 0:
            return
        self._start_view_change(proposed)

    def _start_view_change(self, proposed: int) -> None:
        self._data.view_no = proposed
        self._data.waiting_for_new_view = True
        self._new_view = None
        self._data.primaries = self._selector.select_primaries(
            proposed, self._instance_count, self._data.validators)
        # Snapshot the certificates BEFORE ViewChangeStarted: the ordering
        # service's revert clears the in-flight lists (ref _build_view_change_msg
        # :141 runs on pre-clean state).
        vc = ViewChange(
            view_no=proposed,
            stable_checkpoint=self._data.stable_checkpoint,
            prepared=tuple(b.to_list() for b in self._data.prepared),
            preprepared=tuple(b.to_list() for b in self._data.preprepared),
            checkpoints=tuple((c.view_no, c.seq_no_start, c.seq_no_end, c.digest)
                              for c in self._data.checkpoints),
        )
        # Votes for views this start skips past can never complete (only
        # the view we are WAITING in can finish) — retire them now, not
        # just in _finish: a node that escalates through many views
        # without ever finishing one otherwise accretes every dead view's
        # vote set (churn-soak bounded-growth violation: vc_votes grew
        # one full author-map per abandoned view).
        self._view_changes = {v: d for v, d in self._view_changes.items()
                              if v >= proposed}
        self._acks = {v: d for v, d in self._acks.items() if v >= proposed}
        self._bus.send(ViewChangeStarted(view_no=proposed))
        self._bus.send(PrimarySelected(view_no=proposed,
                                       primaries=tuple(self._data.primaries)))
        self._record_view_change(vc, self._data.node_name)
        self._network.send(vc)
        # Replay any ViewChange/NewView traffic that arrived before we moved.
        self._stasher.process_all_stashed(StashReason.FUTURE_VIEW)
        self._schedule_timeout(proposed)
        self._try_build_or_finish()

    def _new_view_timeout(self) -> float:
        """Escalation timeout: the flat config value, stretched (never
        shrunk) by the measured network RTT when adaptive timeouts are on.
        A view change is bounded by a handful of sequential round trips
        (VC broadcast -> acks -> NEW_VIEW), so `mult * rto` approximates
        the protocol's worst path on THIS network."""
        base = self._config.NEW_VIEW_TIMEOUT
        cap = getattr(self._config, "VC_TIMEOUT_MAX", 4 * base)
        if (self._rtt is not None
                and getattr(self._config, "VC_ADAPTIVE_TIMEOUTS", False)
                and self._rtt.srtt is not None):
            mult = getattr(self._config, "VC_RTT_TIMEOUT_MULT", 20.0)
            base = max(base, mult * self._rtt.timeout(
                floor=0.0, cap=cap, fallback=base))
        # binary growth per consecutive escalation (capped): attempt k
        # gets 2**k the budget, so SOME attempt outlives the network's
        # actual view-change latency no matter how wrong the config floor
        return min(cap, base * (2 ** min(self._escalations, 6)))

    def _schedule_timeout(self, view_no: int) -> None:
        timeout = self._new_view_timeout()

        def on_timeout():
            if self._data.waiting_for_new_view and self._data.view_no == view_no:
                # View change didn't complete: VOTE to escalate — through
                # the InstanceChange quorum, never unilaterally. A node that
                # jumps to view+1 alone strands itself views ahead of the
                # pool (found by the view-change fuzz: one node escalated to
                # view 11 while the quorum sat at 1). Ref: the reference
                # routes VC timeouts through instance changes too
                # (view_change_trigger_service + INSTANCE_CHANGE_TIMEOUT).
                self._escalations += 1      # next attempt gets 2x budget
                self._bus.send(VoteForViewChange(
                    suspicion_code=Suspicions.INSTANCE_CHANGE_TIMEOUT.code,
                    view_no=view_no + 1))
                self._schedule_timeout(view_no)     # keep voting while stuck
        self._timer.schedule(timeout, on_timeout)

        # Re-request probes: maybe only a MESSAGE was lost — far cheaper
        # to re-ask than to escalate views. The first probe fires at
        # half-time (as before); on a lossy WAN one probe is one more
        # coin-flip, so probes now REPEAT on a jittered exponential
        # backoff until the view change completes or escalates, each one
        # re-requesting the NEW_VIEW *and* any ViewChange votes a pending
        # NEW_VIEW cites that we still lack.
        from plenum_tpu_torch.common.backoff import ExponentialBackoff
        self._probe_backoff = ExponentialBackoff(
            base=timeout / 2, cap=timeout, jitter=0.3,
            salt=f"vc_probe/{self._data.node_name}/{view_no}")
        self._schedule_probe(view_no)

    def _schedule_probe(self, view_no: int) -> None:
        backoff = self._probe_backoff
        if backoff is None:
            return

        def probe():
            if (not self._data.waiting_for_new_view
                    or self._data.view_no != view_no
                    or self._probe_backoff is not backoff):
                return                       # completed or escalated past us
            if self._new_view is None:
                self._bus.send(MissingMessage(
                    msg_type="NEW_VIEW", key={"view_no": view_no},
                    inst_id=self._data.inst_id, dst=None))
            if self._pending_new_view is not None:
                nv, _ = self._pending_new_view
                held = self._view_changes.get(view_no, {})
                for author, _digest in nv.view_changes:
                    if author not in held:
                        self._bus.send(MissingMessage(
                            msg_type="VIEW_CHANGE",
                            key={"view_no": view_no, "author": author},
                            inst_id=self._data.inst_id, dst=None))
            self._schedule_probe(view_no)
        self._timer.schedule(backoff.next(), probe)

    # --- collecting votes -------------------------------------------------

    def process_view_change(self, msg: ViewChange, sender: str):
        if msg.view_no < self._data.view_no:
            return DISCARD
        if msg.view_no > self._data.view_no or not self._data.waiting_for_new_view:
            return STASH(StashReason.FUTURE_VIEW)
        self._record_view_change(msg, sender)
        # Ack the author's vote to the would-be primary (ref: acks routed to
        # the new primary so it can prove vote authenticity).
        primary = self._data.primary_name
        ack = ViewChangeAck(view_no=msg.view_no, name=sender,
                            digest=view_change_digest(msg))
        if primary == self._data.node_name:
            self.process_view_change_ack(ack, self._data.node_name)
        else:
            self._network.send(ack, dst=[primary])
        self._try_build_or_finish()
        return PROCESS

    def _record_view_change(self, vc: ViewChange, author: str) -> None:
        self._view_changes.setdefault(vc.view_no, {})[author] = vc

    def process_view_change_ack(self, msg: ViewChangeAck, sender: str):
        if msg.view_no < self._data.view_no:
            return DISCARD
        if msg.view_no > self._data.view_no or not self._data.waiting_for_new_view:
            return STASH(StashReason.FUTURE_VIEW)
        self._acks.setdefault(msg.view_no, {}).setdefault(
            (msg.name, msg.digest), set()).add(sender)
        self._try_build_or_finish()
        return PROCESS

    # --- primary: building NEW_VIEW --------------------------------------

    def _is_new_primary(self) -> bool:
        return self._data.primary_name == self._data.node_name

    def _acked(self, view_no: int, author: str, vc: ViewChange) -> bool:
        votes = self._acks.get(view_no, {}).get(
            (author, view_change_digest(vc)), set())
        # The author's own broadcast counts implicitly; n-f-1 others must agree.
        return self._data.quorums.view_change_ack.is_reached(len(votes))

    def _try_build_or_finish(self) -> None:
        if not self._data.waiting_for_new_view:
            return
        view_no = self._data.view_no
        if self._is_new_primary() and self._new_view is None:
            self._try_build_new_view(view_no)
        if self._pending_new_view is not None:
            nv, nv_sender = self._pending_new_view
            if nv.view_no == view_no:
                self._pending_new_view = None
                self.process_new_view(nv, nv_sender)
            else:
                self._pending_new_view = None
        self._try_finish(view_no)

    def _try_build_new_view(self, view_no: int) -> None:
        vcs_by_author = self._view_changes.get(view_no, {})
        confirmed = {a: vc for a, vc in vcs_by_author.items()
                     if a == self._data.node_name or self._acked(view_no, a, vc)}
        if not self._data.quorums.view_change.is_reached(len(confirmed)):
            return
        # The primary may cite ANY view-change quorum (PBFT: n-f suffice).
        # Try the full confirmed set first; if the builder cannot produce a
        # consistent selection — one diverged member's conflicting batch
        # citations can poison calc_batches FOREVER, storming view changes
        # with a healthy quorum present (partition-heal fuzz seed 15906) —
        # fall back to subsets that exclude possible outliers.
        need = self._data.quorums.view_change.value
        authors = sorted(confirmed)
        candidates: list[list] = [authors]
        if len(authors) > need:
            for drop in authors:                       # leave-one-out
                candidates.append([a for a in authors if a != drop])
            if len(authors) <= 8:                      # exact quorums
                import itertools
                candidates.extend(
                    list(c) for c in itertools.combinations(authors, need))
        seen: set = set()
        for subset in candidates:
            key = tuple(subset)
            if len(subset) < need or key in seen:
                continue
            seen.add(key)
            ordered = sorted((a, confirmed[a]) for a in subset)
            # Iterate votes in the SAME author-sorted order process_new_view
            # will reconstruct from the published view_changes tuple: the
            # builder's selection is iteration-order-sensitive, and any
            # divergence makes validators reject a correct NewView.
            vcs = [vc for _, vc in ordered]
            cp = self._builder.calc_checkpoint(vcs)
            if cp is None:
                continue
            batches = self._builder.calc_batches(cp, vcs)
            if batches is None:
                continue
            nv = NewView(view_no=view_no,
                         view_changes=tuple(
                             (a, view_change_digest(vc)) for a, vc in ordered),
                         checkpoint=cp,
                         batches=tuple(b.to_list() for b in batches))
            self._new_view = nv
            self._network.send(nv)
            self._finish(nv)
            return

    # --- everyone: accepting NEW_VIEW -------------------------------------

    def process_new_view(self, msg: NewView, sender: str):
        if msg.view_no < self._data.view_no:
            return DISCARD
        if msg.view_no > self._data.view_no or not self._data.waiting_for_new_view:
            return STASH(StashReason.FUTURE_VIEW)
        if sender != self._data.primary_name:
            self._bus.send(RaisedSuspicion(
                inst_id=self._data.inst_id,
                code=Suspicions.NEW_VIEW_INVALID.code,
                reason=f"NEW_VIEW from non-primary {sender}"))
            return DISCARD
        # The primary's selection is never taken on trust: re-run the builder
        # over the cited votes and require an identical result (ref
        # _finish_view_change validates NewView against local state).
        if not self._data.quorums.view_change.is_reached(len(msg.view_changes)):
            return self._reject_new_view("NEW_VIEW cites too few ViewChanges")
        own = self._view_changes.get(msg.view_no, {})
        cited: list[ViewChange] = []
        for author, digest in msg.view_changes:
            if author not in self._data.validators:
                return self._reject_new_view(f"NEW_VIEW cites unknown node {author}")
            vc = own.get(author)
            if vc is None:
                # Wait for the missing vote — and actively re-request it from
                # peers (any holder can serve it; the cited digest vouches).
                self._pending_new_view = (msg, sender)
                self._bus.send(MissingMessage(
                    msg_type="VIEW_CHANGE",
                    key={"view_no": msg.view_no, "author": author},
                    inst_id=self._data.inst_id, dst=None))
                return PROCESS
            if view_change_digest(vc) != digest:
                return self._reject_new_view(
                    f"NEW_VIEW cites a ViewChange by {author} that differs "
                    f"from the one we received")
            cited.append(vc)
        cp = self._builder.calc_checkpoint(cited)
        if cp is None or tuple(cp) != tuple(msg.checkpoint):
            return self._reject_new_view("NEW_VIEW checkpoint does not follow "
                                         "from the cited votes")
        batches = self._builder.calc_batches(cp, cited)
        if batches is None or [tuple(b.to_list()) for b in batches] != \
                [tuple(b) for b in msg.batches]:
            return self._reject_new_view("NEW_VIEW batches do not follow "
                                         "from the cited votes")
        self._pending_new_view = None
        self._finish(msg)
        return PROCESS

    def process_requested_view_change(self, vc: ViewChange, author: str) -> None:
        """A peer-served ViewChange vote. Safe to record under the claimed
        author without proof: it is only ever USED where its digest is checked
        against a NewView's citation (process_new_view) or against an ack
        quorum (_acked) — a forged vote fails both."""
        if not author or vc.view_no < self._data.view_no:
            return
        # NEVER overwrite a vote we already hold: an unsolicited forged rep
        # could otherwise evict the genuine vote and wedge every view change.
        if author in self._view_changes.get(vc.view_no, {}):
            return
        self._record_view_change(vc, author)
        self._try_build_or_finish()

    def process_requested_new_view(self, nv: NewView) -> None:
        """A peer-served NewView: identical full validation, minus the
        sender-is-primary check (the responder is a relay, and the content is
        re-derived from our own collected votes anyway)."""
        if nv.view_no != self._data.view_no or not self._data.waiting_for_new_view:
            return
        self.process_new_view(nv, self._data.primary_name or "")

    def _reject_new_view(self, why: str):
        self._bus.send(RaisedSuspicion(inst_id=self._data.inst_id,
                                       code=Suspicions.NEW_VIEW_INVALID.code,
                                       reason=why))
        return DISCARD

    def _try_finish(self, view_no: int) -> None:
        if self._new_view is not None and not self._is_new_primary():
            self._finish(self._new_view)

    def _finish(self, nv: NewView) -> None:
        """_finish_view_change :314 — leave the waiting state and hand the
        selected checkpoint + batches to checkpoint/ordering services."""
        if not self._data.waiting_for_new_view:
            return
        self._new_view = nv
        self._probe_backoff = None          # stand the re-request loop down
        self._escalations = 0               # completed: budget back to floor
        self._data.waiting_for_new_view = False
        self._bus.send(NewViewAccepted(view_no=nv.view_no,
                                       checkpoint=tuple(nv.checkpoint),
                                       batches=tuple(nv.batches)))
        # Old vote state is now garbage.
        self._view_changes = {v: d for v, d in self._view_changes.items()
                              if v > nv.view_no}
        self._acks = {v: d for v, d in self._acks.items() if v > nv.view_no}
