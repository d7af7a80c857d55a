"""Read-request manager: query dispatch.

Reference behavior: plenum/server/request_managers/read_request_manager.py —
queries never enter consensus; a single node answers from committed state,
attaching state proofs / Merkle proofs + the BLS multi-sig so the client can
trust one reply (node.py:2074 process_query).
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution.exceptions import InvalidClientRequest
from plenum_tpu_torch.execution.handlers.base import ReadRequestHandler


class ReadRequestManager:
    def __init__(self):
        self._handlers: dict[str, ReadRequestHandler] = {}

    def register_handler(self, handler: ReadRequestHandler) -> None:
        self._handlers[handler.txn_type] = handler

    def is_query_type(self, txn_type: Optional[str]) -> bool:
        return txn_type in self._handlers

    def static_validation(self, request: Request) -> None:
        handler = self._handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       f"unknown query type {request.txn_type!r}")
        validate = getattr(handler, "static_validation", None)
        if callable(validate):
            validate(request)

    def get_result(self, request: Request) -> dict:
        handler = self._handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(request.identifier, request.req_id,
                                       f"unknown query type {request.txn_type!r}")
        return handler.get_result(request)
