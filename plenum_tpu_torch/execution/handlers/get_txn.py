"""GET_TXN read handler: fetch any committed txn with a Merkle proof.

Reference behavior: plenum/server/request_handlers/get_txn_handler.py — a
query naming (ledgerId, seqNo) answers with the committed txn plus the
ledger's Merkle inclusion proof, so a single node's reply suffices
(docs/source/main.md:24).
"""
from __future__ import annotations

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, VALID_LEDGER_IDS
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution.txn import GET_TXN

from .base import ReadRequestHandler


class GetTxnHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_TXN, DOMAIN_LEDGER_ID)

    def static_validation(self, request: Request) -> None:
        from plenum_tpu_torch.execution.exceptions import InvalidClientRequest
        op = request.operation
        if not isinstance(op.get("data"), int) or op["data"] < 1:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       "GET_TXN needs a positive seqNo in data")
        # an invalid ledgerId is a malformed query -> NACK; silently
        # coercing it to DOMAIN would answer a DIFFERENT question than
        # the client asked (and let a proof for the wrong ledger verify)
        ledger_id = op.get("ledgerId", DOMAIN_LEDGER_ID)
        if ledger_id not in VALID_LEDGER_IDS:
            raise InvalidClientRequest(
                request.identifier, request.req_id,
                f"GET_TXN ledgerId must be one of {list(VALID_LEDGER_IDS)}, "
                f"got {ledger_id!r}")

    def get_result(self, request: Request) -> dict:
        op = request.operation
        ledger_id = op.get("ledgerId", DOMAIN_LEDGER_ID)
        seq_no = op["data"]
        ledger = self.db.get_ledger(ledger_id)
        result = {"type": GET_TXN, "ledgerId": ledger_id, "seqNo": seq_no,
                  "data": None}
        if ledger is None or seq_no > ledger.size:
            return result
        result["data"] = ledger.get_by_seq_no(seq_no)
        result["merkle_proof"] = ledger.merkle_info(seq_no)
        return result
