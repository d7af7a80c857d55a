"""Primary-health watchdog: detect a dead or stalling primary and vote.

Reference behavior: the reference detects a bad master primary three ways —
primary disconnect (plenum/server/consensus/monitoring/
primary_connection_monitor_service.py, node.py:511), ordering stalls on
finalized requests (unordered-request checks via the monitor,
monitor.py:425), and state-freshness stalls (ordering_service.py:1991 +
suspicion STATE_SIGS_ARE_NOT_UPDATED). This service folds all three into
one watchdog on the master instance of every non-primary node:

- DISCONNECT (fast path): transport Connected/Disconnected events arrive
  on the ExternalBus; losing the primary's connection schedules a vote
  PRIMARY_DISCONNECT_TIMEOUT later (seconds, not the 30s+ stall windows),
  cancelled if the primary comes back first.
- ordering stall: work to order but no 3PC progress within
  ORDERING_PROGRESS_TIMEOUT.
- freshness: nothing ordered at all beyond the freshness interval.

Every vote rides the normal InstanceChange f+1 quorum, so a single slow
or partitioned node cannot force a view change alone.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.internal_messages import VoteForViewChange
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.common.timer import RepeatingTimer, TimerService
from plenum_tpu_torch.config import Config

from .consensus_shared_data import ConsensusSharedData


class PrimaryHealthService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 has_pending_work: Callable[[], bool],
                 config: Optional[Config] = None,
                 network: Optional[ExternalBus] = None,
                 rtt=None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._has_pending_work = has_pending_work
        self._config = config or Config()
        self._network = network
        # shared RTT estimate: a stall window tuned for a LAN reads a
        # merely-slow WAN primary as dead and storms view changes. The
        # configured timeouts stay the FLOOR (clean networks unchanged);
        # a measured slow network stretches them (VC_ADAPTIVE_TIMEOUTS).
        self._rtt = rtt

        self._progress_marker = data.last_ordered_3pc
        self._stall_since: Optional[float] = None
        now = timer.get_current_time()
        self._last_order_time = now
        self._ticker = RepeatingTimer(
            timer, self._config.PRIMARY_HEALTH_CHECK_FREQ, self.check)
        if network is not None:
            network.subscribe(ExternalBus.Disconnected,
                              self._on_peer_disconnected)
            network.subscribe(ExternalBus.Connected, self._on_peer_connected)

    def stop(self) -> None:
        self._ticker.stop()
        self._timer.cancel(self._disconnect_check)

    # --- primary-disconnect fast path --------------------------------- #

    def _on_peer_disconnected(self, msg, frm=None) -> None:
        if msg.name == self._data.primary_name and not self._data.is_primary:
            self._timer.cancel(self._disconnect_check)   # no double votes
            self._timer.schedule(self._config.PRIMARY_DISCONNECT_TIMEOUT,
                                 self._disconnect_check)

    def _on_peer_connected(self, msg, frm=None) -> None:
        if msg.name == self._data.primary_name:
            self._timer.cancel(self._disconnect_check)

    def _disconnect_check(self) -> None:
        """Fires PRIMARY_DISCONNECT_TIMEOUT after losing the primary; the
        state is re-validated at fire time (a view change may have picked a
        new primary, or the old one may be back), and the vote repeats on
        the same cadence while the primary stays gone."""
        primary = self._data.primary_name
        if (self._network is None or primary is None
                or self._data.is_primary
                or primary in self._network.connecteds):
            return      # resolved: reconnected, new primary, or we lead now
        if (not self._data.is_participating
                or self._data.waiting_for_new_view):
            # TRANSIENT (catchup / view change in flight): re-arm rather
            # than disarm — no new Disconnected event will fire for an
            # already-lost connection, and the primary may still be gone
            # when we finish syncing
            self._timer.schedule(self._config.PRIMARY_DISCONNECT_TIMEOUT,
                                 self._disconnect_check)
            return
        self._vote(Suspicions.PRIMARY_DISCONNECTED)
        self._timer.schedule(self._config.PRIMARY_DISCONNECT_TIMEOUT,
                             self._disconnect_check)

    # ------------------------------------------------------------------ #

    def check(self) -> None:
        now = self._timer.get_current_time()
        if self._data.last_ordered_3pc != self._progress_marker:
            self._progress_marker = self._data.last_ordered_3pc
            self._last_order_time = now
            self._stall_since = None
        if (not self._data.is_participating
                or self._data.waiting_for_new_view
                or self._data.is_primary):
            self._stall_since = None
            self._last_order_time = now
            return
        self._check_ordering_progress(now)
        self._check_freshness(now)

    def _stretch(self, flat: float, mult: float) -> float:
        """RTT-informed stall window: max(configured flat value, mult
        measured round trips) — ordering a batch is a few sequential
        broadcasts, so `mult * rto` bounds how long a HEALTHY primary can
        legitimately take on this network."""
        if (self._rtt is None or self._rtt.srtt is None
                or not getattr(self._config, "VC_ADAPTIVE_TIMEOUTS", False)):
            return flat
        cap = getattr(self._config, "VC_TIMEOUT_MAX", 4 * flat)
        return min(max(flat, cap), max(
            flat, mult * self._rtt.timeout(floor=0.0, cap=cap,
                                           fallback=flat)))

    def _check_ordering_progress(self, now: float) -> None:
        """Finalized-but-unordered work + no 3PC progress = stalled primary."""
        if not self._has_pending_work():
            self._stall_since = None
            return
        if self._stall_since is None:
            self._stall_since = now
            return
        timeout = self._stretch(self._config.ORDERING_PROGRESS_TIMEOUT,
                                mult=10.0)
        if now - self._stall_since >= timeout:
            self._vote(Suspicions.PRIMARY_STALLED)
            self._stall_since = now          # re-vote each timeout period

    def _check_freshness(self, now: float) -> None:
        """A live primary orders SOMETHING (a freshness batch at minimum)
        every STATE_FRESHNESS_UPDATE_INTERVAL; silence far beyond that means
        the primary is gone even if no client traffic is pending."""
        interval = self._config.STATE_FRESHNESS_UPDATE_INTERVAL
        if interval <= 0:
            return        # freshness disabled: mirror _send_freshness_batches
        limit = self._stretch(interval * 1.5, mult=10.0)
        if now - self._last_order_time >= limit:
            self._vote(Suspicions.STATE_SIGS_ARE_NOT_UPDATED)
            self._last_order_time = now      # re-vote cadence, not a reset

    def _vote(self, suspicion) -> None:
        self._bus.send(VoteForViewChange(suspicion_code=suspicion.code))
