"""Turning suspicions into InstanceChange votes and votes into view changes.

Reference behavior: plenum/server/consensus/view_change_trigger_service.py:23
and server/view_change/instance_change_provider.py:30 — any local
VoteForViewChange (monitor degradation, primary disconnect, freshness stall,
protocol suspicion) becomes a broadcast InstanceChange for view+1; a quorum of
f+1 matching votes from distinct nodes starts the actual view change
(_try_start_view_change_by_instance_change :128). Votes expire after a TTL so
stale grievances can't combine across epochs, and they PERSIST across restart
(instance_change_provider.py:34-69 keeps them in the node-status DB) so a node
crash during a marginal f+1 accumulation doesn't reset the count.

Redesign note: the reference stamps votes with time.perf_counter and reloads
those stamps verbatim, so a restart (perf_counter restarts near zero) makes
old votes look FUTURE-dated and immortal until the interval catches up. Here
persisted stamps are wall-clock; on load each vote's wall age is converted
back into the node's TimerService timeline and anything older than the TTL is
dropped at the door.
"""
from __future__ import annotations

import time
from typing import Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.internal_messages import (NeedViewChange,
                                                 VoteForViewChange)
from plenum_tpu_torch.common.node_messages import InstanceChange
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.config import Config

from .consensus_shared_data import ConsensusSharedData


class InstanceChangeVoteStore:
    """Durable InstanceChange votes over the node-status KV.

    Key layout: b"ic/<view_no:08x>" -> msgpack {voter: wall_timestamp}.
    One row per proposed view keeps remove-on-view-change a single delete.
    """

    PREFIX = b"ic/"

    def __init__(self, kv, wall_now=time.time):
        self._kv = kv
        self._wall_now = wall_now

    def save_view(self, view_no: int, voters_wall_ts: dict[str, float]) -> None:
        key = self.PREFIX + b"%08x" % view_no
        if voters_wall_ts:
            self._kv.put(key, pack(voters_wall_ts))
        else:
            self.remove_view(view_no)

    def remove_view(self, view_no: int) -> None:
        try:
            self._kv.remove(self.PREFIX + b"%08x" % view_no)
        except KeyError:
            pass

    def load(self, ttl: float) -> dict[int, dict[str, float]]:
        """-> {view_no: {voter: age_seconds}}, TTL-filtered at load."""
        now = self._wall_now()
        out: dict[int, dict[str, float]] = {}
        for key, value in list(self._kv.iterator()):
            if not bytes(key).startswith(self.PREFIX):
                continue
            try:
                view_no = int(bytes(key)[len(self.PREFIX):], 16)
                votes = unpack(value)
            except Exception:   # corrupt row: skip, never brick startup
                continue
            kept = {voter: now - ts for voter, ts in votes.items()
                    if isinstance(ts, (int, float)) and 0 <= now - ts <= ttl}
            if kept:
                out[view_no] = kept
            else:
                self.remove_view(view_no)
        return out


class ViewChangeTriggerService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 config: Optional[Config] = None,
                 vote_store: Optional[InstanceChangeVoteStore] = None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self._store = vote_store
        # proposed view -> node -> vote timestamp (TimerService timeline)
        self._votes: dict[int, dict[str, float]] = {}
        # parallel wall-clock stamps, mirrored to the store (persistence
        # must survive a TimerService restart, which timer stamps don't)
        self._wall: dict[int, dict[str, float]] = {}

        if self._store is not None:
            self._load_persisted()

        bus.subscribe(VoteForViewChange, self.process_vote_for_view_change)
        network.subscribe(InstanceChange, self.process_instance_change)

    def _load_persisted(self) -> None:
        """Re-seat surviving votes in the fresh timer timeline: a vote with
        wall age A gets timer stamp now-A, so its remaining TTL keeps
        ticking from where the crash left it."""
        ttl = self._config.INSTANCE_CHANGE_TIMEOUT
        now_t = self._timer.get_current_time()
        now_w = time.time()
        for view_no, ages in self._store.load(ttl).items():
            if view_no <= self._data.view_no:
                self._store.remove_view(view_no)
                continue
            for voter, age in ages.items():
                self._votes.setdefault(view_no, {})[voter] = now_t - age
                self._wall.setdefault(view_no, {})[voter] = now_w - age

    # --- local suspicion → broadcast vote ---------------------------------

    def process_vote_for_view_change(self, msg: VoteForViewChange) -> None:
        proposed = msg.view_no if msg.view_no is not None else self._data.view_no + 1
        ic = InstanceChange(view_no=proposed, reason=msg.suspicion_code)
        self._record_vote(proposed, self._data.node_name)
        self._network.send(ic)
        self._try_start(proposed)

    # --- peer votes -------------------------------------------------------

    # An InstanceChange may propose any future view, and each distinct
    # proposed view costs a tracked dict + a persisted KV row. Unbounded,
    # a Byzantine peer could grow both without limit by walking view_no
    # upward; views this far beyond reality have no honest proposer.
    MAX_FUTURE_VIEWS = 128

    def process_instance_change(self, msg: InstanceChange, sender: str) -> None:
        if msg.view_no <= self._data.view_no:
            return
        if msg.view_no > self._data.view_no + self.MAX_FUTURE_VIEWS:
            return
        self._record_vote(msg.view_no, sender)
        self._try_start(msg.view_no)

    def _record_vote(self, view_no: int, voter: str) -> None:
        self._votes.setdefault(view_no, {})[voter] = self._timer.get_current_time()
        self._wall.setdefault(view_no, {})[voter] = time.time()
        if self._store is not None:
            self._store.save_view(view_no, self._wall[view_no])

    def _live_votes(self, view_no: int) -> int:
        now = self._timer.get_current_time()
        ttl = self._config.INSTANCE_CHANGE_TIMEOUT
        votes = self._votes.get(view_no, {})
        expired = [v for v, ts in votes.items() if now - ts > ttl]
        for voter in expired:
            del votes[voter]
            self._wall.get(view_no, {}).pop(voter, None)
        if expired and self._store is not None:
            self._store.save_view(view_no, self._wall.get(view_no, {}))
        return len(votes)

    def _drop_view(self, view_no: int) -> None:
        self._votes.pop(view_no, None)
        self._wall.pop(view_no, None)
        if self._store is not None:
            self._store.remove_view(view_no)

    def purge_stale(self) -> None:
        """Drop every tracked/persisted proposal at or below the current
        view. Called after restart restore: the service is constructed
        before the audit ledger restores view_no, so the constructor's
        `view_no <= data.view_no` filter ran against 0 and votes for
        since-completed views may have been reloaded."""
        for stale in [v for v in set(self._votes) | set(self._wall)
                      if v <= self._data.view_no]:
            self._drop_view(stale)

    def _try_start(self, view_no: int) -> None:
        if view_no <= self._data.view_no:
            return
        if self._data.quorums.propagate.is_reached(self._live_votes(view_no)):
            # f+1 nodes want this view: at least one is honest, so join.
            # Retire every proposal at or below it — those votes are spent.
            for stale in [v for v in self._votes if v <= view_no]:
                self._drop_view(stale)
            self._bus.send(NeedViewChange(view_no=view_no))
