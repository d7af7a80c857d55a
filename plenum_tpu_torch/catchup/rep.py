"""Catchup replies: ranged requests split across peers, Merkle-verified apply.

Reference behavior: plenum/server/catchup/catchup_rep_service.py:18 +
node_leecher_service.py:186-244 — the missing txn range is split evenly across
available peers, each chunk arrives as a CatchupRep, chunks are applied
strictly in order, and every applied prefix is verified against the agreed
target root via the shipped consistency proof; a chunk that fails verification
is discarded and re-requested from a different peer.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.backoff import ExponentialBackoff, RttEstimator
from plenum_tpu_torch.common.node_messages import CatchupRep, CatchupReq
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.execution.database_manager import DatabaseManager
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier


class CatchupRepService:
    def __init__(self, ledger_id: int, db: DatabaseManager,
                 send: Callable, timer: TimerService,
                 peers_provider: Callable[[], list[str]],
                 on_txn_added: Callable[[int, dict], None],
                 on_complete: Callable[[int], None],
                 retry_timeout: float = 5.0,
                 config=None,
                 rtt: Optional[RttEstimator] = None,
                 salt: str = ""):
        self.ledger_id = ledger_id
        self._db = db
        self._send = send
        self._timer = timer
        self._peers = peers_provider
        self._on_txn_added = on_txn_added
        self._on_complete = on_complete
        self._retry_timeout = retry_timeout
        self._verifier = MerkleVerifier()
        self._running = False
        self.diverged = False    # set when every peer conflicts (see below)
        self._target_size = 0
        self._target_root = ""
        # pending reps: start_seq -> (end_seq, [txns], proof, frm)
        self._reps: dict[int, tuple[int, list[dict], tuple, str]] = {}
        self._blacklisted_peers: set[str] = set()
        self._retry_scheduled = False
        self._attempt = 0        # rotates peer assignment across retries
        # --- progress watchdog (provider switching on stall) ---
        # Verification failures already blacklist (the peer LIED); a peer
        # that merely STALLS — accepts the CatchupReq and never answers —
        # previously cost a silent flat-timeout round every retry, forever
        # if rotation kept landing chunks on it. Now every fruitless
        # retry gives each peer asked in that pass a strike; at
        # STALL_STRIKES the peer is sidelined for this round and its
        # ranges re-split across the rest (sidelining ALL peers clears
        # the sideline — a wholly-partitioned node keeps asking).
        self.STALL_STRIKES = 2
        self._stall_strikes: dict[str, int] = {}
        self._sidelined_peers: set[str] = set()
        self._asked_last_pass: set[str] = set()
        self._progress_marker: Optional[tuple[int, int]] = None
        self.stats = {"rounds": 0, "provider_switches": 0, "stalls": 0}
        # adaptive pacing, same policy as ConsProofService
        self._adaptive = bool(getattr(config, "CATCHUP_ADAPTIVE_TIMEOUTS",
                                      False)) if config is not None else False
        self._retry_min = getattr(config, "CATCHUP_RETRY_MIN", 0.25)
        self._retry_max = getattr(config, "CATCHUP_RETRY_MAX", 30.0)
        self._rtt = rtt if rtt is not None else RttEstimator()
        self._backoff = ExponentialBackoff(
            base=retry_timeout, cap=self._retry_max,
            jitter=0.3, salt=f"catchup_rep/{salt}/{ledger_id}")
        self._pass_sent_at: Optional[float] = None

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self, target_size: int, target_root_hex: str) -> None:
        ledger = self._db.get_ledger(self.ledger_id)
        self._running = True
        self.diverged = False
        self._blacklisted_peers.clear()   # fresh round, fresh chances
        self._sidelined_peers.clear()
        self._stall_strikes.clear()
        self._asked_last_pass.clear()
        self._progress_marker = None
        self._backoff.reset()
        self._target_size = target_size
        self._target_root = target_root_hex
        self._reps.clear()
        if ledger.size >= target_size:
            self._finish()
            return
        self._request_missing()

    def stop(self) -> None:
        self._running = False
        self._cancel_retry()

    # --- requesting -------------------------------------------------------

    def _covered_seqs(self) -> set[int]:
        out = set()
        for start, (end, _, _, _) in self._reps.items():
            out.update(range(start, end + 1))
        return out

    def _request_missing(self) -> None:
        """Split [ledger.size+1, target] across usable peers (ref :186-244).

        The retry timer is re-armed on EVERY pass while the service runs —
        even when nothing looks missing right now — because a pending rep
        that covers a range may still fail verification at apply time, and
        without a live timer the service would stall permanently."""
        if not self._running:
            return
        self._schedule_retry()
        ledger = self._db.get_ledger(self.ledger_id)
        start, end = ledger.size + 1, self._target_size
        covered = self._covered_seqs()
        missing = [s for s in range(start, end + 1) if s not in covered]
        if not missing:
            return
        usable = [p for p in self._peers()
                  if p not in self._blacklisted_peers
                  and p not in self._sidelined_peers]
        if not usable:
            # every provider sidelined/blacklisted: clear the SOFT
            # sideline (stalls may have been our own partition) and try
            # the full non-blacklisted set again — only proven liars
            # stay out
            self._sidelined_peers.clear()
            self._stall_strikes.clear()
            usable = [p for p in self._peers()
                      if p not in self._blacklisted_peers] \
                or list(self._peers())
        peers = usable
        if not peers:
            return
        # contiguous runs of missing seq_nos, round-robined over peers
        runs: list[tuple[int, int]] = []
        run_start = prev = missing[0]
        for s in missing[1:]:
            if s != prev + 1:
                runs.append((run_start, prev))
                run_start = s
            prev = s
        runs.append((run_start, prev))
        split: list[tuple[int, int]] = []
        for lo, hi in runs:
            n = len(peers)
            size = max(1, (hi - lo + 1 + n - 1) // n)
            while lo <= hi:
                split.append((lo, min(lo + size - 1, hi)))
                lo += size
        # Rotate assignment each pass: a peer that silently declines (it is
        # itself behind the target) or times out must not be re-asked for the
        # same chunk forever — only verification failures blacklist.
        self._attempt += 1
        self.stats["rounds"] += 1
        self._asked_last_pass = set()
        self._progress_marker = (ledger.size, len(self._reps))
        self._pass_sent_at = self._timer.get_current_time()
        for i, (lo, hi) in enumerate(split):
            peer = peers[(i + self._attempt - 1) % len(peers)]
            self._asked_last_pass.add(peer)
            self._send(CatchupReq(ledger_id=self.ledger_id,
                                  seq_no_start=lo, seq_no_end=hi,
                                  catchup_till=self._target_size),
                       [peer])

    def _retry_delay(self) -> float:
        if not self._adaptive:
            return self._retry_timeout
        return self._backoff.next(base=self._rtt.timeout(
            floor=self._retry_min, cap=self._retry_max,
            fallback=self._retry_timeout))

    def _schedule_retry(self) -> None:
        self._cancel_retry()
        self._timer.schedule(self._retry_delay(), self._on_retry_timeout)
        self._retry_scheduled = True

    def _cancel_retry(self) -> None:
        if getattr(self, "_retry_scheduled", False):
            self._timer.cancel(self._on_retry_timeout)
            self._retry_scheduled = False

    def _on_retry_timeout(self) -> None:
        self._retry_scheduled = False
        if not self._running:
            return
        self._note_stalls()
        self._request_missing()

    def _note_stalls(self) -> None:
        """A retry fired with NOTHING new since the last request pass:
        everyone asked in that pass gets a stall strike; repeat offenders
        are sidelined so the next pass re-splits their ranges across
        responsive providers (the watchdog half of 'switch providers when
        a chosen node stalls or lies' — lies blacklist at verification)."""
        ledger = self._db.get_ledger(self.ledger_id)
        if self._progress_marker is None or \
                (ledger.size, len(self._reps)) != self._progress_marker:
            return
        self.stats["stalls"] += 1
        for peer in self._asked_last_pass:
            strikes = self._stall_strikes.get(peer, 0) + 1
            self._stall_strikes[peer] = strikes
            if strikes >= self.STALL_STRIKES and \
                    peer not in self._sidelined_peers:
                self._sidelined_peers.add(peer)
                self.stats["provider_switches"] += 1

    # --- receiving --------------------------------------------------------

    def process_catchup_rep(self, msg: CatchupRep, frm: str) -> None:
        if not self._running or msg.ledger_id != self.ledger_id:
            return
        seqs = sorted(int(s) for s in msg.txns if s.isdigit())
        if not seqs:
            return
        # keep only contiguous, in-range reps (a seeder never sends gaps)
        if seqs != list(range(seqs[0], seqs[-1] + 1)) or \
                seqs[-1] > self._target_size:
            return
        # a well-formed answer: this provider is alive (stall strikes
        # clear), the link round trip feeds the adaptive retry pacing,
        # and the backoff ladder restarts from its floor (progress)
        if self._pass_sent_at is not None:
            self._rtt.note(self._timer.get_current_time()
                           - self._pass_sent_at)
            self._pass_sent_at = None
        self._stall_strikes.pop(frm, None)
        self._backoff.reset()
        if seqs[0] not in self._reps:
            self._reps[seqs[0]] = (seqs[-1],
                                   [msg.txns[str(s)] for s in seqs],
                                   tuple(msg.cons_proof), frm)
        self._try_apply()

    def _try_apply(self) -> None:
        """Apply reps strictly in order. Each rep is verified against the
        agreed target root BEFORE commit: stage the chunk, then check that
        the staged root at the chunk's end is consistent with the target via
        the rep's consistency proof (or equals it when the range closes).
        A bad chunk is dropped, its sender sidelined, and the range
        re-requested elsewhere — nothing unverified ever commits."""
        ledger = self._db.get_ledger(self.ledger_id)
        while self._running:
            next_seq = ledger.size + 1
            if next_seq > self._target_size:
                break
            # Find a pending rep covering next_seq. Reps may OVERLAP already-
            # applied txns (honest timeout re-splits use different chunk
            # boundaries): trim the applied prefix instead of demanding an
            # exact start match, and drop fully-stale reps — the reference
            # applies any txn with seqNo > ledger size from any rep
            # (catchup_rep_service.py).
            chosen = None
            for start in sorted(self._reps):
                end, txns, proof, frm = self._reps[start]
                if end < next_seq:
                    del self._reps[start]        # entirely applied: stale
                    continue
                if start <= next_seq:
                    chosen = (start, end, txns, proof, frm)
                break    # earliest usable rep found, or a gap before it
            if chosen is None:
                break
            start, end, txns, proof, frm = chosen
            del self._reps[start]
            txns = txns[next_seq - start:]       # trim applied prefix
            ledger.append_txns_to_uncommitted(txns)
            root_at_end = ledger.uncommitted_root_hash
            if end == self._target_size:
                ok = root_at_end.hex() == self._target_root
            else:
                try:
                    ok = self._verifier.verify_consistency(
                        end, self._target_size, root_at_end,
                        bytes.fromhex(self._target_root),
                        [bytes.fromhex(h) for h in proof])
                except (ValueError, TypeError):
                    ok = False
            if not ok:
                ledger.discard_txns(len(txns))
                self._blacklisted_peers.add(frm)
                usable = [p for p in self._peers()
                          if p not in self._blacklisted_peers]
                if not usable:
                    # EVERY peer's chunk fails verification against the
                    # f+1-agreed target: our own committed prefix conflicts
                    # with the pool's chain. This is divergence beyond
                    # append-repair — it can only arise outside the fault
                    # model (e.g. >f simultaneous crash-restarts evaporate
                    # the in-memory prepared certificates a lone commit
                    # relied on; found by the partition-heal fuzz). Loud
                    # and terminal for this catchup round: operators must
                    # repair (resync from a snapshot / truncate the
                    # divergent suffix), not watch a silent retry loop.
                    import logging
                    logging.getLogger(__name__).error(
                        "ledger %s: committed prefix (size %d) conflicts "
                        "with the quorum target (size %d, root %s) — "
                        "divergence beyond append-repair; catchup aborted",
                        self.ledger_id, ledger.size, self._target_size,
                        self._target_root)
                    self.diverged = True
                    self._finish()
                    return
                self._request_missing()
                return
            committed, _ = ledger.commit_txns(len(txns))
            for txn in committed:
                self._on_txn_added(self.ledger_id, txn)
        if ledger.size >= self._target_size:
            self._finish()

    def _finish(self) -> None:
        self._running = False
        self._cancel_retry()
        self._on_complete(self.ledger_id)
