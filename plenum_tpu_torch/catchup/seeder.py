"""Seeder: serve ledger status, consistency proofs, and catchup ranges.

Reference behavior: plenum/server/catchup/seeder_service.py:14 — every node
answers peers' LedgerStatus with either its own status (peer is current) or a
ConsistencyProof from the peer's size to ours; answers CatchupReq with the
requested txn range plus the Merkle consistency proof that lets the leecher
verify the range against the agreed target root (process_catchup_req:49).
"""
from __future__ import annotations

from typing import Callable

from plenum_tpu_torch.common.node_messages import (CatchupRep, CatchupReq,
                                             ConsistencyProof, LedgerStatus)
from plenum_tpu_torch.execution.database_manager import DatabaseManager


class SeederService:
    def __init__(self, db: DatabaseManager,
                 send: Callable,
                 last_3pc: Callable[[], tuple[int, int]],
                 max_batch: int = 50):
        self._db = db
        self._send = send                     # send(msg, dst)
        self._last_3pc = last_3pc
        self._max_batch = max_batch

    def process_ledger_status(self, msg: LedgerStatus, frm: str) -> None:
        if msg.is_reply:
            return                    # an acknowledgment, not a status query
        ledger = self._db.get_ledger(msg.ledger_id)
        if ledger is None:
            return
        view_no, pp_seq_no = self._last_3pc()
        if msg.txn_seq_no >= ledger.size:
            # peer is as current as us (or ahead): echo our own status
            self._send(LedgerStatus(
                ledger_id=msg.ledger_id, txn_seq_no=ledger.size,
                merkle_root=ledger.root_hash.hex(),
                view_no=view_no, pp_seq_no=pp_seq_no, is_reply=True), frm)
            return
        proof = ledger.consistency_proof(msg.txn_seq_no, ledger.size) \
            if msg.txn_seq_no > 0 else []
        self._send(ConsistencyProof(
            ledger_id=msg.ledger_id,
            seq_no_start=msg.txn_seq_no,
            seq_no_end=ledger.size,
            view_no=view_no, pp_seq_no=pp_seq_no,
            old_merkle_root=msg.merkle_root,
            new_merkle_root=ledger.root_hash.hex(),
            hashes=tuple(proof)), frm)

    def process_catchup_req(self, msg: CatchupReq, frm: str) -> None:
        ledger = self._db.get_ledger(msg.ledger_id)
        if ledger is None:
            return
        if ledger.size < msg.catchup_till:
            # We cannot anchor a consistency proof at the leecher's agreed
            # target root (we don't have those txns yet), so any rep we send
            # would fail verification and get this honest node blacklisted.
            # Decline; the leecher's retry timer re-splits across other peers.
            return
        end = min(msg.seq_no_end, ledger.size, msg.seq_no_start + self._max_batch - 1)
        if end < msg.seq_no_start:
            return
        txns = {str(i): ledger.get_by_seq_no(i)
                for i in range(msg.seq_no_start, end + 1)}
        # Ship the consistency proof from the chunk's end to the agreed
        # target size: after appending the chunk, the leecher's root at size
        # `end` plus this proof must reproduce the target root, which verifies
        # EVERY txn of the prefix (not just the last one).
        proof = ledger.consistency_proof(end, msg.catchup_till) \
            if msg.catchup_till > end else []
        self._send(CatchupRep(ledger_id=msg.ledger_id, txns=txns,
                              cons_proof=tuple(proof)), frm)
