"""Request-rejection exceptions.

Reference behavior: plenum/common/exceptions.py — InvalidClientRequest (static
validation, -> RequestNack) vs UnauthorizedClientRequest / rejection during
dynamic validation (-> Reject). The split matters on the wire: a NACK means
"malformed, never entered consensus"; a REJECT means "well-formed but refused
by the current state".
"""
from __future__ import annotations


class RequestRejectedError(Exception):
    """Base for request refusals."""

    def __init__(self, identifier=None, req_id=None, reason: str = ""):
        self.identifier = identifier
        self.req_id = req_id
        self.reason = reason
        super().__init__(reason)


class InvalidClientRequest(RequestRejectedError):
    """Static validation failure -> RequestNack."""


class UnauthorizedClientRequest(RequestRejectedError):
    """Dynamic validation / authorization failure -> Reject."""
