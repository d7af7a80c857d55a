"""Stashing router: messages that can't be processed yet are stashed under a
reason code and replayed when the blocking condition clears.

Reference behavior: plenum/common/stashing_router.py — handlers return either
PROCESS/DISCARD or (STASH, reason); `process_all_stashed(reason)` replays.
"""
from __future__ import annotations

from collections import deque
from enum import IntEnum
from typing import Any, Callable, Optional, Tuple


class StashReason(IntEnum):
    CATCHING_UP = 1
    FUTURE_VIEW = 2
    OUTSIDE_WATERMARKS = 3
    WAITING_FOR_NEW_VIEW = 4
    FUTURE_3PC = 5
    MISSING_REQUESTS = 6


PROCESS = None
DISCARD = "DISCARD"


def STASH(reason: StashReason) -> Tuple[str, StashReason]:
    return ("STASH", reason)


class StashingRouter:
    """Wraps an ExternalBus subscription: the handler's return value decides
    whether the message was processed, discarded, or stashed for later."""

    def __init__(self, limit: int = 100000,
                 accept: Optional[Callable[[Any], bool]] = None):
        self._limit = limit
        # cheap pre-filter run BEFORE any dispatch bookkeeping: on a shared
        # node bus every instance's router sees every 3PC message, and at
        # f+1 instances 8 of 9 dispatches used to pay handler + verdict
        # resolution just to discard on the inst_id check
        self._accept = accept
        self._queues: dict[StashReason, deque] = {}
        self._handlers: dict[type, Callable] = {}
        self._bus_unsubs: list[Callable[[], None]] = []
        # BOUNDED debug trail: under the deep pipeline a busy pool discards
        # wrong-instance/stale traffic at wire rate, and an unbounded list
        # was a slow leak ON EVERY REPLICA
        self.discarded: deque = deque(maxlen=1000)

    def subscribe(self, message_type: type, handler: Callable) -> None:
        if message_type in self._handlers:
            raise ValueError(f"handler already registered for {message_type.__name__}")
        self._handlers[message_type] = handler

    def subscribe_to(self, bus) -> None:
        for message_type in list(self._handlers):
            self._bus_unsubs.append(bus.subscribe(message_type, self.dispatch))

    def unsubscribe_from_buses(self) -> None:
        """Detach from every bus this router subscribed to (replica removal:
        a detached instance must not keep processing wire messages)."""
        for unsub in self._bus_unsubs:
            unsub()
        self._bus_unsubs.clear()

    def dispatch(self, message: Any, *args) -> None:
        if self._accept is not None and not self._accept(message):
            return
        handler = None
        for klass in type(message).__mro__:
            if klass in self._handlers:
                handler = self._handlers[klass]
                break
        if handler is None:
            return
        result = handler(message, *args)
        self._resolve(result, message, args, handler)

    def _resolve(self, result, message, args, handler) -> None:
        if result is PROCESS:
            return
        if result == DISCARD or (isinstance(result, tuple) and result[0] == DISCARD):
            reason = result[1] if isinstance(result, tuple) and len(result) > 1 else ""
            self.discarded.append((message, args, reason))
            return
        if isinstance(result, tuple) and result[0] == "STASH":
            queue = self._queues.setdefault(result[1], deque())
            if len(queue) < self._limit:
                queue.append((message, args, handler))
            else:
                self.discarded.append((message, args, f"stash overflow ({result[1].name})"))

    def process_all_stashed(self, reason: Optional[StashReason] = None) -> int:
        reasons = [reason] if reason is not None else list(self._queues)
        processed = 0
        for r in reasons:
            queue = self._queues.get(r)
            if not queue:
                continue
            pending, self._queues[r] = queue, deque()
            while pending:
                message, args, handler = pending.popleft()
                result = handler(message, *args)
                self._resolve(result, message, args, handler)
                processed += 1
        return processed

    def stash_size(self, reason: Optional[StashReason] = None) -> int:
        if reason is not None:
            return len(self._queues.get(reason, ()))
        return sum(len(q) for q in self._queues.values())
