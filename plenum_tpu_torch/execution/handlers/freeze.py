"""Ledger-freeze handlers (config ledger).

Reference behavior: plenum/server/request_handlers/ledgers_freeze/ — trustees
can freeze retired ledgers (no further writes, catchup skips them) and anyone
can query the frozen set, which records each frozen ledger's final root/size.
"""
from __future__ import annotations

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import GET_FROZEN_LEDGERS, LEDGERS_FREEZE

from .base import ReadRequestHandler
from .taa import _ConfigWriteHandler

KEY_FROZEN = b"frozen_ledgers"
_PROTECTED = (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
              AUDIT_LEDGER_ID)


class LedgersFreezeHandler(_ConfigWriteHandler):
    def __init__(self, db, nym_handler=None):
        super().__init__(db, LEDGERS_FREEZE, nym_handler)

    def static_validation(self, request: Request) -> None:
        op = request.operation
        lids = op.get("ledgers_ids")
        self._require(isinstance(lids, (list, tuple)) and
                      all(isinstance(i, int) for i in lids), request,
                      "LEDGERS_FREEZE needs a list of ledger ids")
        self._require(not any(i in _PROTECTED for i in lids), request,
                      "base ledgers cannot be frozen")

    def gen_txn(self, request: Request) -> dict:
        return txn_lib.new_txn(
            LEDGERS_FREEZE,
            {"ledgers_ids": request.operation["ledgers_ids"]}, request)

    def update_state(self, txn: dict, is_committed: bool) -> None:
        raw = self.state.get(KEY_FROZEN, committed=False)
        frozen = unpack(raw) if raw is not None else {}
        for lid in txn_lib.txn_data(txn)["ledgers_ids"]:
            ledger = self.db.get_ledger(lid)
            frozen[str(lid)] = {
                "ledger": ledger.root_hash.hex() if ledger else None,
                "state": (self.db.get_state(lid).committed_head_hash.hex()
                          if self.db.get_state(lid) else None),
                "seq_no": ledger.size if ledger else 0}
        self.state.set(KEY_FROZEN, pack(frozen))

    def is_frozen(self, ledger_id: int) -> bool:
        raw = self.state.get(KEY_FROZEN, committed=True)
        return raw is not None and str(ledger_id) in unpack(raw)


class GetFrozenLedgersHandler(ReadRequestHandler):
    def __init__(self, db):
        super().__init__(db, GET_FROZEN_LEDGERS, CONFIG_LEDGER_ID)

    def get_result(self, request: Request) -> dict:
        raw = self.state.get(KEY_FROZEN, committed=True)
        return {"type": GET_FROZEN_LEDGERS,
                "data": unpack(raw) if raw is not None else {}}
