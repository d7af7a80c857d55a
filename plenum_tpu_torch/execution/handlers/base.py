"""Request-handler seams.

Reference behavior: plenum/server/request_handlers/handler_interfaces/ —
a write handler owns (txn_type, ledger_id) and contributes static validation,
dynamic (state-dependent) validation, txn construction, and state updates;
a read handler answers queries from committed state. The manager dispatches by
txn type (write_request_manager.py:113), so handlers stay single-purpose and
the registry is the extension point (plugins register more handlers).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution.database_manager import DatabaseManager
from plenum_tpu_torch.execution.exceptions import InvalidClientRequest


class RequestHandler(ABC):
    txn_type: str
    ledger_id: int

    def __init__(self, db: DatabaseManager, txn_type: str, ledger_id: int):
        self.db = db
        self.txn_type = txn_type
        self.ledger_id = ledger_id

    @property
    def ledger(self):
        return self.db.get_ledger(self.ledger_id)

    @property
    def state(self):
        return self.db.get_state(self.ledger_id)


class WriteRequestHandler(RequestHandler):
    def static_validation(self, request: Request) -> None:
        """Schema-level checks; raise InvalidClientRequest."""

    def dynamic_validation(self, request: Request, pp_time: Optional[int]) -> None:
        """State-dependent checks against uncommitted state; raise
        UnauthorizedClientRequest to Reject."""

    @abstractmethod
    def gen_txn(self, request: Request) -> dict:
        """Operation -> txn envelope (no seqNo/time yet)."""

    @abstractmethod
    def update_state(self, txn: dict, is_committed: bool) -> None:
        """Apply the txn to the (uncommitted) state trie."""

    # --- shared validation helpers ---------------------------------------

    def _require(self, cond: bool, request: Request, why: str) -> None:
        if not cond:
            raise InvalidClientRequest(request.identifier, request.req_id, why)


class ReadRequestHandler(RequestHandler):
    @abstractmethod
    def get_result(self, request: Request) -> dict:
        """Answer a query from committed state (single-node, proof-backed)."""
