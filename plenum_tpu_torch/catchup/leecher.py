"""Leecher state machines: per-ledger sync + whole-node catchup ordering.

Reference behavior: plenum/server/catchup/ledger_leecher_service.py:15 (one
ledger: cons-proof phase then catchup-rep phase) and
node_leecher_service.py:20-34 (the node-level state machine syncing ledgers
strictly in the order audit → pool → config → domain, node.py:142 — the audit
ledger first because it tells us how far the others should go, pool next
because it can change the validator set mid-catchup).
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID, CatchupRep,
                                             ConsistencyProof, CONFIG_LEDGER_ID,
                                             DOMAIN_LEDGER_ID, LedgerStatus,
                                             POOL_LEDGER_ID)
from plenum_tpu_torch.common.backoff import RttEstimator
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.execution.database_manager import DatabaseManager

from .cons_proof import ConsProofService
from .rep import CatchupRepService

CATCHUP_ORDER = (AUDIT_LEDGER_ID, POOL_LEDGER_ID, CONFIG_LEDGER_ID,
                 DOMAIN_LEDGER_ID)


class LedgerLeecherService:
    """Sync one ledger: agree on a target, then fetch+verify+apply."""

    def __init__(self, ledger_id: int, db: DatabaseManager, send: Callable,
                 timer: TimerService,
                 quorums_provider: Callable[[], Quorums],
                 peers_provider: Callable[[], list[str]],
                 on_txn_added: Callable[[int, dict], None],
                 on_complete: Callable[[int, Optional[tuple[int, int]]], None],
                 config=None,
                 rtt: Optional[RttEstimator] = None,
                 salt: str = ""):
        self.ledger_id = ledger_id
        self._on_complete = on_complete
        self._last_3pc: Optional[tuple[int, int]] = None
        self.cons_proof = ConsProofService(
            ledger_id, db, quorums_provider, send, self._on_target,
            timer=timer, config=config, rtt=rtt, salt=salt)
        self.rep = CatchupRepService(
            ledger_id, db, send, timer, peers_provider, on_txn_added,
            self._on_rep_complete, config=config, rtt=rtt, salt=salt)
        self.is_active = False

    def start(self) -> None:
        self.is_active = True
        self._last_3pc = None
        self.cons_proof.start()

    def stop(self) -> None:
        self.is_active = False
        self.cons_proof.stop()
        self.rep.stop()

    def _on_target(self, ledger_id: int, target) -> None:
        if target is None:           # already up to date
            self.is_active = False
            self._on_complete(ledger_id, None)
            return
        size, root_hex, last_3pc = target
        self._last_3pc = last_3pc
        self.rep.start(size, root_hex)

    def _on_rep_complete(self, ledger_id: int) -> None:
        self.is_active = False
        self._on_complete(ledger_id, self._last_3pc)


class NodeLeecherService:
    """Whole-node catchup: run ledger leechers in the canonical order."""

    def __init__(self, db: DatabaseManager, send: Callable,
                 timer: TimerService,
                 quorums_provider: Callable[[], Quorums],
                 peers_provider: Callable[[], list[str]],
                 on_txn_added: Callable[[int, dict], None],
                 on_catchup_complete: Callable[[Optional[tuple[int, int]]], None],
                 config=None, salt: str = "",
                 rtt: Optional[RttEstimator] = None):
        # ONE RTT estimate shared by every ledger's services (and, via the
        # node, by the view-change timeout): round-trip time is a property
        # of the network, not of a ledger id
        self.rtt = rtt if rtt is not None else RttEstimator()
        self._db = db
        self._on_catchup_complete = on_catchup_complete
        self.leechers: dict[int, LedgerLeecherService] = {
            lid: LedgerLeecherService(lid, db, send, timer, quorums_provider,
                                      peers_provider, on_txn_added,
                                      self._ledger_done, config=config,
                                      rtt=self.rtt, salt=salt)
            for lid in CATCHUP_ORDER if db.get_ledger(lid) is not None}
        self.is_running = False
        self._order: list[int] = [lid for lid in CATCHUP_ORDER
                                  if lid in self.leechers]
        self._idx = 0
        self._last_3pc: Optional[tuple[int, int]] = None

    # --- control -----------------------------------------------------------

    def start(self) -> None:
        if self.is_running:
            return
        self.is_running = True
        self._idx = 0
        self._last_3pc = None
        self._start_current()

    def stop(self) -> None:
        self.is_running = False
        for leecher in self.leechers.values():
            leecher.stop()

    # --- watchdog / reporting seams ----------------------------------------

    def progress_key(self) -> tuple:
        """Changes whenever ANY observable catchup progress happens:
        phase index, the active ledger's applied size, pending reps and
        request rounds. The node's watchdog compares two snapshots an
        interval apart — equality means a genuine stall."""
        if not self.is_running or self._idx >= len(self._order):
            return ("idle",)
        lid = self._order[self._idx]
        leecher = self.leechers[lid]
        ledger = self._db.get_ledger(lid)
        rep = leecher.rep
        return (self._idx, ledger.size, len(rep._reps),
                rep.stats["rounds"], leecher.cons_proof.rounds)

    def kick(self) -> None:
        """Watchdog nudge: force the active phase to re-request NOW
        (stall accounting included) instead of waiting out its timer."""
        if not self.is_running or self._idx >= len(self._order):
            return
        leecher = self.leechers[self._order[self._idx]]
        if leecher.rep.is_running:
            leecher.rep._note_stalls()
            leecher.rep._request_missing()
        elif leecher.cons_proof._running:
            # disarm the pending timer first: _on_retry clears the armed
            # flag on entry (its own timer entry is consumed when it
            # fires), so an out-of-band call would otherwise leave the
            # old schedule live and fork a second retry loop per kick
            leecher.cons_proof._cancel_retry()
            leecher.cons_proof._on_retry()

    @property
    def diverged(self) -> bool:
        return any(l.rep.diverged for l in self.leechers.values())

    def round_stats(self) -> dict:
        """Aggregated across ledgers, for metrics/anomaly context."""
        out = {"rounds": 0, "provider_switches": 0, "stalls": 0}
        for leecher in self.leechers.values():
            for k in out:
                out[k] += leecher.rep.stats[k]
            out["rounds"] += max(0, leecher.cons_proof.rounds - 1)
        return out

    def _start_current(self) -> None:
        if self._idx >= len(self._order):
            self.is_running = False
            self._on_catchup_complete(self._last_3pc)
            return
        self.leechers[self._order[self._idx]].start()

    def _ledger_done(self, ledger_id: int,
                     last_3pc: Optional[tuple[int, int]]) -> None:
        if not self.is_running:
            return
        if last_3pc is not None and (self._last_3pc is None or
                                     last_3pc > self._last_3pc):
            self._last_3pc = last_3pc
        self._idx += 1
        self._start_current()

    # --- message routing ----------------------------------------------------

    def process_ledger_status(self, msg: LedgerStatus, frm: str) -> None:
        leecher = self.leechers.get(msg.ledger_id)
        if leecher is not None:
            leecher.cons_proof.process_ledger_status(msg, frm)

    def process_consistency_proof(self, msg: ConsistencyProof, frm: str) -> None:
        leecher = self.leechers.get(msg.ledger_id)
        if leecher is not None:
            leecher.cons_proof.process_consistency_proof(msg, frm)

    def process_catchup_rep(self, msg: CatchupRep, frm: str) -> None:
        leecher = self.leechers.get(msg.ledger_id)
        if leecher is not None:
            leecher.rep.process_catchup_rep(msg, frm)
