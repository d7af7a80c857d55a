"""Consistency-proof gathering: agree on the catchup target.

Reference behavior: plenum/server/catchup/cons_proof_service.py:24 — broadcast
our LedgerStatus; if n-f-1 peers answer with an equal status we are already
up to date; otherwise f+1 ConsistencyProofs naming the same (size, root)
fix the catchup target. The f+1 quorum suffices because at least one of the
proofs comes from an honest node, and the Merkle verification of the catchup
replies is what actually protects integrity.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.backoff import ExponentialBackoff, RttEstimator
from plenum_tpu_torch.common.node_messages import ConsistencyProof, LedgerStatus
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.execution.database_manager import DatabaseManager


class ConsProofService:
    def __init__(self, ledger_id: int, db: DatabaseManager,
                 quorums_provider: Callable[[], Quorums],
                 send: Callable,
                 on_target: Callable[[int, Optional[tuple[int, str, tuple[int, int]]]], None],
                 timer: Optional[TimerService] = None,
                 retry_timeout: float = 5.0,
                 config=None,
                 rtt: Optional[RttEstimator] = None,
                 salt: str = ""):
        """on_target(ledger_id, None) = already up to date;
        on_target(ledger_id, (size, root_hex, (view_no, pp_seq_no)))."""
        self.ledger_id = ledger_id
        self._db = db
        self._quorums = quorums_provider
        self._send = send
        self._on_target = on_target
        self._running = False
        self._timer = timer
        self._retry_timeout = retry_timeout
        # Adaptive re-request pacing: the first retry waits an
        # RTT-informed timeout (srtt + 4*rttvar, clamped), consecutive
        # fruitless retries back off exponentially with seeded jitter up
        # to CATCHUP_RETRY_MAX. A flat timeout is wrong in BOTH
        # directions — see common/backoff.py. Falls back to the flat
        # `retry_timeout` when CATCHUP_ADAPTIVE_TIMEOUTS is off.
        self._adaptive = bool(getattr(config, "CATCHUP_ADAPTIVE_TIMEOUTS",
                                      False)) if config is not None else False
        self._retry_min = getattr(config, "CATCHUP_RETRY_MIN", 0.25)
        self._retry_max = getattr(config, "CATCHUP_RETRY_MAX", 30.0)
        self._rtt = rtt if rtt is not None else RttEstimator()
        self._backoff = ExponentialBackoff(
            base=retry_timeout, cap=self._retry_max,
            jitter=0.3, salt=f"cons_proof/{salt}/{ledger_id}")
        self._sent_at: Optional[float] = None
        self.rounds = 0          # status broadcasts this catchup round
        self._retry_armed = False
        self._same_status: set[str] = set()
        self._proofs: dict[tuple[int, str], set[str]] = {}
        # (size, root) -> {(view_no, pp_seq_no) -> voters}: the 3PC position
        # needs its own f+1 quorum — a single Byzantine peer echoing the
        # honest size/root must not get to pick the pool's 3PC key
        # (ref cons_proof_service.py _get_last_txn_3PC_key)
        self._last_3pc_votes: dict[tuple[int, str],
                                   dict[tuple[int, int], set[str]]] = {}

    def start(self) -> None:
        self._running = True
        self._same_status.clear()
        self._proofs.clear()
        self._last_3pc_votes.clear()
        self._backoff.reset()
        self.rounds = 0
        self._broadcast_status()
        # re-broadcast until a quorum forms (ref ConsistencyProofsTimeout
        # re-request): lost replies or peers that were themselves mid-sync
        # when we asked must not stall this catchup forever — the leecher
        # has no other wakeup (found by the partition-heal fuzz: a second
        # catchup whose one-shot LedgerStatus went unanswered hung the
        # node in is_running=True with ordering paused)
        self._arm_retry()

    def _broadcast_status(self) -> None:
        ledger = self._db.get_ledger(self.ledger_id)
        self.rounds += 1
        if self._timer is not None:
            self._sent_at = self._timer.get_current_time()
        self._send(LedgerStatus(ledger_id=self.ledger_id,
                                txn_seq_no=ledger.size,
                                merkle_root=ledger.root_hash.hex(),
                                view_no=None, pp_seq_no=None), None)

    def _note_reply(self) -> None:
        """First answer to the outstanding broadcast: fold its round trip
        into the shared RTT estimate (later answers to the same broadcast
        measure peer spread, not the link — skip them)."""
        if self._sent_at is not None and self._timer is not None:
            self._rtt.note(self._timer.get_current_time() - self._sent_at)
            self._sent_at = None

    def _retry_delay(self) -> float:
        if not self._adaptive:
            return self._retry_timeout
        return self._backoff.next(base=self._rtt.timeout(
            floor=self._retry_min, cap=self._retry_max,
            fallback=self._retry_timeout))

    def _arm_retry(self) -> None:
        if self._timer is None:
            return
        self._cancel_retry()
        self._timer.schedule(self._retry_delay(), self._on_retry)
        self._retry_armed = True

    def _cancel_retry(self) -> None:
        if self._retry_armed and self._timer is not None:
            self._timer.cancel(self._on_retry)
            self._retry_armed = False

    def _on_retry(self) -> None:
        self._retry_armed = False
        if not self._running:
            return
        self._broadcast_status()
        self._arm_retry()

    def stop(self) -> None:
        self._running = False
        self._cancel_retry()

    def process_ledger_status(self, msg: LedgerStatus, frm: str) -> None:
        """A peer telling us ITS status in response to ours."""
        if not self._running or msg.ledger_id != self.ledger_id:
            return
        self._note_reply()
        ledger = self._db.get_ledger(self.ledger_id)
        if msg.txn_seq_no <= ledger.size and \
                (msg.txn_seq_no < ledger.size or
                 msg.merkle_root == ledger.root_hash.hex()):
            self._same_status.add(frm)
            if self._quorums().checkpoint.is_reached(len(self._same_status)):
                self._finish(None)       # n-f-1 peers agree we are current

    def process_consistency_proof(self, msg: ConsistencyProof, frm: str) -> None:
        if not self._running or msg.ledger_id != self.ledger_id:
            return
        self._note_reply()
        ledger = self._db.get_ledger(self.ledger_id)
        if msg.seq_no_end <= ledger.size:
            return
        key = (msg.seq_no_end, msg.new_merkle_root)
        self._proofs.setdefault(key, set()).add(frm)
        if msg.view_no is not None and msg.pp_seq_no is not None:
            self._last_3pc_votes.setdefault(key, {}).setdefault(
                (msg.view_no, msg.pp_seq_no), set()).add(frm)
        if self._quorums().consistency_proof.is_reached(len(self._proofs[key])):
            self._finish((key[0], key[1], self._quorumed_3pc(key)))

    def _quorumed_3pc(self, key) -> Optional[tuple[int, int]]:
        """Minimum 3PC key with f+1 matching non-None votes, else None
        (then catchup proceeds without adopting a 3PC position)."""
        quorum = self._quorums().weak
        quorumed = [pos for pos, voters in self._last_3pc_votes.get(key, {}).items()
                    if quorum.is_reached(len(voters))]
        return min(quorumed) if quorumed else None

    def _finish(self, target) -> None:
        self._running = False
        self._cancel_retry()
        self._on_target(self.ledger_id, target)
