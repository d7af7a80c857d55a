"""Action requests: privileged node-local operations outside consensus.

Reference behavior: plenum/server/request_managers/action_request_manager.py
+ action_req_handler seams — a third request family besides writes and
reads: an ACTION is authenticated like any request but executes on the
receiving node only (no propagation, no 3PC, no ledger txn). The reference's
canonical actions live downstream (indy-node POOL_RESTART); plenum itself
ships the dispatch machinery, which this module reproduces, plus a built-in
VALIDATOR_INFO action (the reference exposes the same data via
validator_info_tool on a schedule; on-demand via an action is the natural
query surface here).

Authorization: actions are privileged — only a TRUSTEE or STEWARD identity
from domain state may invoke them (ref indy-node restart authorization).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution.exceptions import (InvalidClientRequest,
                                                   UnauthorizedClientRequest)
from plenum_tpu_torch.execution.txn import STEWARD, TRUSTEE

VALIDATOR_INFO_ACTION = "119"     # indy action txn-type family


class ActionRequestHandler(ABC):
    txn_type: str

    def static_validation(self, request: Request) -> None:
        """Schema checks; raise InvalidClientRequest."""

    @abstractmethod
    def execute(self, request: Request) -> dict:
        """Perform the action on THIS node; returns the reply result dict."""


class ValidatorInfoAction(ActionRequestHandler):
    txn_type = VALIDATOR_INFO_ACTION

    def __init__(self, node):
        self._node = node

    def execute(self, request: Request) -> dict:
        return {"type": self.txn_type, "data": self._node.validator_info()}


class ActionRequestManager:
    """Registry + dispatch for action handlers (ref
    action_request_manager.py). Role authorization is centralized here."""

    MAX_TRACKED_IDENTITIES = 10_000

    def __init__(self, get_role=None):
        self._handlers: dict[str, ActionRequestHandler] = {}
        # did -> role string, from committed domain state
        self._get_role = get_role or (lambda did: None)
        # did -> highest req_id executed: actions write no txn, so the
        # seq-no-DB dedup that protects writes can't apply — without this a
        # captured signed action request would replay forever
        self._last_req_id: dict[str, int] = {}

    def register_handler(self, handler: ActionRequestHandler) -> None:
        self._handlers[handler.txn_type] = handler

    def is_action_type(self, txn_type: Optional[str]) -> bool:
        return txn_type in self._handlers

    def process(self, request: Request) -> dict:
        """Validate + authorize + execute; raises Invalid/Unauthorized."""
        handler = self._handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       f"unknown action {request.txn_type!r}")
        handler.static_validation(request)
        role = self._get_role(request.identifier)
        if role not in (TRUSTEE, STEWARD):
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                "actions require a TRUSTEE or STEWARD identity")
        if request.req_id <= self._last_req_id.get(request.identifier, 0):
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                "stale action req_id (replay?)")
        if request.identifier not in self._last_req_id and \
                len(self._last_req_id) >= self.MAX_TRACKED_IDENTITIES:
            self._last_req_id.pop(next(iter(self._last_req_id)))
        # delete+insert keeps the dict ordered by recency (approximate LRU),
        # so eviction hits the longest-idle identity, not an active one
        self._last_req_id.pop(request.identifier, None)
        self._last_req_id[request.identifier] = request.req_id
        return handler.execute(request)
