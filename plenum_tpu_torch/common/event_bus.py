"""Internal and external message buses.

Reference behavior: plenum/common/event_bus.py:6,11 — InternalBus is in-process
typed pub/sub between services of one node; ExternalBus fronts the network and
carries (message, sender/receiver) pairs. All consensus services talk only to
these buses, which is what makes the engine testable without sockets
(SURVEY.md §4 seam (a)).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional


class Router:
    """Dispatch messages to handlers subscribed by message type (incl. bases)."""

    def __init__(self):
        self._handlers: dict[type, list[Callable]] = {}

    def subscribe(self, message_type: type, handler: Callable) -> Callable[[], None]:
        self._handlers.setdefault(message_type, []).append(handler)
        def unsubscribe():
            try:
                self._handlers[message_type].remove(handler)
            except (KeyError, ValueError):
                pass
        return unsubscribe

    def handlers_for(self, message: Any) -> list[Callable]:
        result = []
        for klass in type(message).__mro__:
            result.extend(self._handlers.get(klass, ()))
        return result


class InternalBus(Router):
    """Synchronous in-process pub/sub between a node's services."""

    def send(self, message: Any, *args) -> None:
        for handler in self.handlers_for(message):
            handler(message, *args)


class ExternalBus(Router):
    """Network-facing bus: incoming messages arrive as (msg, frm); outgoing
    messages go through a send handler installed by the owning stack."""

    ALL_CONNECTED = None  # dst=None == broadcast

    class Connected(NamedTuple):
        name: str

    class Disconnected(NamedTuple):
        name: str

    def __init__(self, send_handler: Callable[[Any, Any], None]):
        super().__init__()
        # send_handler(msg, dst): dst is None (broadcast) or list of names
        self._send_handler = send_handler
        self.connecteds: set[str] = set()
        # admission predicate over the sender; installed by the node to drop
        # traffic from blacklisted peers before ANY service sees it
        # (ref server/blacklister.py enforcement in the node msg pipelines)
        self._incoming_filter: Callable[[str], bool] = lambda frm: True

    def send(self, message: Any, dst=None) -> None:
        if isinstance(dst, str):
            dst = [dst]
        self._send_handler(message, dst)

    def set_incoming_filter(self, accept_frm: Callable[[str], bool],
                            accept_msg: Optional[
                                Callable[[Any, str], bool]] = None) -> None:
        """accept_frm gates by sender alone; accept_msg, when given, may
        ADDITIONALLY admit a (message, sender) the sender gate refused —
        the seam that lets catchup-serving traffic from a known-but-not-
        yet-validator node (membership churn: a joiner syncing to join)
        through a validators-only bus without opening consensus quorums
        to non-members."""
        self._incoming_filter = accept_frm
        self._incoming_msg_filter = accept_msg

    def process_incoming(self, message: Any, frm: str) -> None:
        if not self._incoming_filter(frm):
            msg_filter = getattr(self, "_incoming_msg_filter", None)
            if msg_filter is None or not msg_filter(message, frm):
                return
        for handler in self.handlers_for(message):
            handler(message, frm)

    def update_connecteds(self, connecteds: set[str]) -> None:
        newly = connecteds - self.connecteds
        lost = self.connecteds - connecteds
        self.connecteds = set(connecteds)
        for name in sorted(newly):
            self.process_incoming(self.Connected(name), name)
        for name in sorted(lost):
            self.process_incoming(self.Disconnected(name), name)
