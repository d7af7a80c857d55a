"""Observer framework: push committed batches to non-validator followers.

Reference behavior: plenum/server/observer/observable.py:11 (the node-side
registry + policy that fans BatchCommitted out to registered observers) and
observer/observer_node.py + observer_sync_policy_each_batch.py (the follower
that applies each batch to its own ledger copy).

The node-side Observable subscribes nothing by itself: Node._execute_batch
calls append_input() after commit, and the policy decides who gets the
message. The follower side (NodeObserver) re-derives the ledger from the
batch's request list and REFUSES batches whose claimed txn root does not
match what its own Merkle tree computes — an observer is untrusted-input
tolerant even though it trusts the pool's ordering.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional

from plenum_tpu_torch.common.node_messages import BatchCommitted
from plenum_tpu_torch.common.serialization import signing_serialize


class Observable:
    """Node-side observer registry + each-batch send policy.

    Registrations arrive over the client stack (OBSERVER_REGISTER op, see
    Node._service_client_msgs) keyed by the client connection id; pushes to
    a disconnected id are silently dropped by the stack. The registry is
    capped — anyone can connect a client socket, so unbounded registration
    would be a free memory/egress amplifier — with FIFO eviction (a dead
    registration can't block live ones forever; an evicted live observer
    re-registers on its next reconnect).
    """

    MAX_OBSERVERS = 16

    def __init__(self, send: Callable[[Any, str], None],
                 close: Optional[Callable[[str], None]] = None,
                 send_many: Optional[Callable[[Any, list], None]] = None):
        self._send = send
        self._close = close          # drops the evicted CONNECTION so the
        # observer's redial+re-register loop fires; without it an evicted
        # follower would sit on a silent socket forever
        # pack-once broadcast seam (ClientStack.send_many); falls back to
        # per-observer send when the transport offers none
        self._send_many = send_many
        self._observers: dict[str, str] = {}      # observer id -> policy

    def add_observer(self, observer_id: str,
                     policy: str = "each_batch") -> None:
        if policy != "each_batch":
            raise ValueError(f"unknown observer policy {policy!r}")
        # re-registration refreshes recency (pop + insert moves to the
        # dict's end), so FIFO eviction removes the LONGEST-UNREFRESHED
        # id, not the longest-lived legitimate observer
        self._observers.pop(observer_id, None)
        if len(self._observers) >= self.MAX_OBSERVERS:
            oldest = next(iter(self._observers))
            del self._observers[oldest]
            if self._close is not None:
                self._close(oldest)
        self._observers[observer_id] = policy

    def remove_observer(self, observer_id: str) -> None:
        self._observers.pop(observer_id, None)

    @property
    def observer_ids(self) -> list[str]:
        return list(self._observers)

    def append_input(self, batch: BatchCommitted) -> None:
        if self._send_many is not None:
            self._send_many(batch, list(self._observers))
            return
        for observer_id in self._observers:
            self._send(batch, observer_id)


class NodeObserver:
    """Follower: applies each pushed batch to its own ledgers/states.

    Built from the same NodeBootstrap components as a validator (minus
    consensus); process_batch is idempotent and gap-safe: batches at or
    below the ledger's size are ignored, a batch leaving a gap is rejected
    (the caller should catch up out of band, same as the reference's
    can_process check in observer_sync_policy_each_batch.py).

    Data quorum (ref plenum/server/quorums.py:38 observer_data = f+1): a
    batch is applied only once f+1 DISTINCT validators have pushed
    CONTENT-IDENTICAL copies — root re-derivation alone binds the chain
    but cannot stop a lone Byzantine validator from feeding a
    self-consistent fabricated batch; with f+1 matching pushes at least
    one comes from an honest validator. Each validator holds one vote per
    (ledger, seq range) — a re-push with different content replaces its
    earlier vote, so one peer can never grow the buffer. f=0 (the default,
    for single-trusted-feed library use) applies on the first push.
    """

    def __init__(self, components, f: int = 0):
        self.c = components
        self.f = f
        self.last_applied: dict[int, int] = {}
        # (ledger, seq_no_start) -> {validator: (content digest, batch)}.
        # Keyed by START only (which the gap check pins to ledger.size+1),
        # so the buffer holds at most one entry per ledger and one vote per
        # validator — a Byzantine peer varying seq_no_end just replaces its
        # own vote instead of minting new buckets
        self._votes: dict[tuple, dict[str, tuple[str, BatchCommitted]]] = {}

    def process_batch(self, batch: BatchCommitted, frm: str = "") -> bool:
        ledger = self.c.db.get_ledger(batch.ledger_id)
        if ledger is None:
            return False
        if batch.seq_no_end <= ledger.size:
            return False                            # already have it
        if batch.seq_no_start != ledger.size + 1:
            return False                            # gap: needs catchup

        key = (batch.ledger_id, batch.seq_no_start)
        # quorum content excludes the advisory multi_sig attachment:
        # honest validators legitimately aggregate DIFFERENT commit-sig
        # subsets, and voting on it would split identical batches into
        # separate buckets and starve the f+1 quorum. The sig is
        # self-verifying (checked against the pool BLS keys by the
        # observer's read gate), so it needs verification, not agreement.
        digest = hashlib.sha256(
            signing_serialize(batch.quorum_dict())).hexdigest()
        votes = self._votes.setdefault(key, {})
        votes[frm] = (digest, batch)
        if sum(1 for d, _ in votes.values() if d == digest) < self.f + 1:
            return False                            # buffered, no quorum yet
        applied = self._apply_batch(batch)
        if applied:
            # quorum consumed; every start now at or below the ledger size
            # is settled, so the buffer stays bounded by in-flight ranges
            self._votes = {k: v for k, v in self._votes.items()
                           if not (k[0] == batch.ledger_id
                                   and k[1] <= batch.seq_no_end)}
        return applied

    def _apply_batch(self, batch: BatchCommitted) -> bool:
        from plenum_tpu_torch.common.request import Request
        from plenum_tpu_torch.execution.write_manager import ThreePcBatch

        # re-run the write pipeline: apply -> compare roots -> commit
        requests = [Request.from_dict(r) for r in batch.requests]
        valid, _rejected, roots = self.c.write_manager.apply_batch(
            batch.ledger_id, requests, batch.pp_time, batch.view_no,
            batch.pp_seq_no)
        if roots["txn_root"] != batch.txn_root or \
                roots["state_root"] != batch.state_root:
            # claimed roots don't match recomputation: refuse and revert.
            # (The audit ledger is NOT compared: its txns snapshot primaries,
            # which a follower has no view of — same scope as the reference's
            # each-batch policy, which replays domain/pool data only.)
            self.c.write_manager.revert_last_batch(batch.ledger_id)
            return False
        self.c.write_manager.commit_batch(ThreePcBatch(
            ledger_id=batch.ledger_id, view_no=batch.view_no,
            pp_seq_no=batch.pp_seq_no, pp_time=batch.pp_time,
            valid_digests=tuple(r.digest for r in valid),
            state_root=bytes.fromhex(roots["state_root"])
            if roots["state_root"] else b"",
            txn_root=bytes.fromhex(roots["txn_root"])
            if roots["txn_root"] else b"",
            audit_txn_root=bytes.fromhex(roots["audit_txn_root"])
            if roots["audit_txn_root"] else b"",
            primaries=(), node_reg=()))
        self.last_applied[batch.ledger_id] = batch.seq_no_end
        return True

    def catch_up(self, batch: BatchCommitted, fetch_txn,
                 limit: int = 10_000) -> bool:
        """Fill the gap below `batch` and apply the batch ATOMICALLY.

        fetch_txn(ledger_id, seq_no) -> committed txn dict or None (the
        transport is typically a GET_TXN query via PoolClient). Fetched txns
        are staged UNCOMMITTED; the pushed batch is then applied on top and
        its roots — which bind the ENTIRE preceding chain through the Merkle
        tree — are compared against the push. Nothing commits until the
        comparison passes; on any mismatch or missing txn every staged
        change is discarded, so a Byzantine fetch peer can stall this
        observer but never corrupt it (same invariant as validator catchup:
        plenum_tpu_torch/catchup/rep.py verify-before-commit).
        """
        from plenum_tpu_torch.common.request import Request
        from plenum_tpu_torch.execution.write_manager import ThreePcBatch

        ledger = self.c.db.get_ledger(batch.ledger_id)
        state = self.c.db.get_state(batch.ledger_id)
        if ledger is None or batch.seq_no_end <= ledger.size:
            return False
        prev_state_root = state.head_hash if state is not None else None

        def discard(n_pulled: int) -> bool:
            if n_pulled:
                ledger.discard_txns(n_pulled)
                if state is not None and prev_state_root is not None:
                    state.revert_to_head(prev_state_root)
            return False

        pulled = 0
        while ledger.size + pulled + 1 < batch.seq_no_start:
            if pulled >= limit:
                return discard(pulled)
            txn = fetch_txn(batch.ledger_id, ledger.size + pulled + 1)
            if txn is None:
                return discard(pulled)
            ledger.append_txns_to_uncommitted([txn])
            self.c.write_manager.apply_committed_txn(
                batch.ledger_id, txn, committed=False)
            pulled += 1

        requests = [Request.from_dict(r) for r in batch.requests]
        valid, _rejected, roots = self.c.write_manager.apply_batch(
            batch.ledger_id, requests, batch.pp_time, batch.view_no,
            batch.pp_seq_no)
        if roots["txn_root"] != batch.txn_root or \
                roots["state_root"] != batch.state_root:
            self.c.write_manager.revert_last_batch(batch.ledger_id)
            return discard(pulled)
        if pulled:
            ledger.commit_txns(pulled)
        self.c.write_manager.commit_batch(ThreePcBatch(
            ledger_id=batch.ledger_id, view_no=batch.view_no,
            pp_seq_no=batch.pp_seq_no, pp_time=batch.pp_time,
            valid_digests=tuple(r.digest for r in valid),
            state_root=bytes.fromhex(roots["state_root"])
            if roots["state_root"] else b"",
            txn_root=bytes.fromhex(roots["txn_root"])
            if roots["txn_root"] else b"",
            audit_txn_root=bytes.fromhex(roots["audit_txn_root"])
            if roots["audit_txn_root"] else b"",
            primaries=(), node_reg=()))
        self.last_applied[batch.ledger_id] = batch.seq_no_end
        return True
