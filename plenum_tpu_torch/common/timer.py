"""Timer services: every delay/timeout in the framework goes through a
TimerService so tests can run on mock time.

Reference behavior: plenum/common/timer.py:13,27,60 (TimerService, QueueTimer,
RepeatingTimer) — the determinism seam called out in SURVEY.md §4/§5.
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from heapq import heappush, heappop
from typing import Callable


class TimerService(ABC):
    @abstractmethod
    def get_current_time(self) -> float: ...

    @abstractmethod
    def schedule(self, delay: float, callback: Callable[[], None]) -> None: ...

    @abstractmethod
    def cancel(self, callback: Callable[[], None]) -> None: ...


class QueueTimer(TimerService):
    """Heap-scheduled timer driven by an injectable wall clock.

    `service()` fires all callbacks whose deadline has passed; the node's prod
    loop calls it every cycle.
    """

    def __init__(self, get_current_time: Callable[[], float] = time.perf_counter):
        self._get_current_time = get_current_time
        # latched at each service(): every read within one prod cycle sees
        # the SAME timestamp (the cycle start). Determinism requirement: a
        # recorded run replays tick-by-tick under a mock clock, and any
        # mid-cycle wall-clock read (e.g. a batch's pp_time, which enters
        # the 3PC digest) would diverge between live and replay.
        self._frozen_now: float | None = None
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0  # tie-break so equal deadlines fire FIFO
        self._cancelled: set[int] = set()
        # Keyed by the callback itself, NOT id(): `self.method` builds a fresh
        # bound-method object on every attribute access, so id()-keying would
        # make cancel(self.method) a silent no-op (bound methods of the same
        # object+function compare and hash equal).
        self._ids: dict[Callable, list[int]] = {}  # callback -> seq numbers

    def get_current_time(self) -> float:
        if self._frozen_now is not None:
            return self._frozen_now
        return self._get_current_time()

    def schedule(self, delay: float, callback: Callable[[], None]) -> None:
        self._seq += 1
        heappush(self._heap, (self.get_current_time() + delay, self._seq, callback))
        self._ids.setdefault(callback, []).append(self._seq)

    def cancel(self, callback: Callable[[], None]) -> None:
        for seq in self._ids.pop(callback, []):
            self._cancelled.add(seq)

    def service(self) -> int:
        """Fire due callbacks; returns how many fired."""
        fired = 0
        self._frozen_now = self._get_current_time()
        now = self._frozen_now
        while self._heap and self._heap[0][0] <= now:
            _, seq, cb = heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            seqs = self._ids.get(cb)
            if seqs and seq in seqs:
                seqs.remove(seq)
                if not seqs:
                    del self._ids[cb]
            cb()
            fired += 1
        return fired

    @property
    def size(self) -> int:
        return sum(1 for (_, s, _) in self._heap if s not in self._cancelled)


class MockTimer(QueueTimer):
    """Deterministic timer for tests: time only moves when advanced."""

    def __init__(self, start: float = 0.0):
        self._now = start
        super().__init__(get_current_time=lambda: self._now)

    def get_current_time(self) -> float:
        return self._now            # mock time is already cycle-frozen

    def advance(self, delta: float) -> None:
        self.set_time(self._now + delta)

    def set_time(self, value: float) -> None:
        # Step through intermediate deadlines so RepeatingTimers fire each period.
        while self._heap and self._heap[0][0] <= value:
            self._now = max(self._now, self._heap[0][0])
            self.service()
        self._now = value

    def advance_until(self, value: float) -> None:
        self.set_time(value)

    def set_time_no_service(self, value: float) -> None:
        """Jump the clock WITHOUT stepping through intermediate deadlines.
        The replayer pairs this with one service() call so due callbacks
        fire in a batch at the jump target — exactly how a live QueueTimer
        services them at the next prod cycle's frozen time."""
        self._now = max(self._now, value)

    def run_to_completion(self, max_events: int = 10000) -> None:
        for _ in range(max_events):
            if not self._heap:
                return
            self.set_time(self._heap[0][0])


class RepeatingTimer:
    """Re-schedules `callback` every `interval` until stopped."""

    def __init__(self, timer: TimerService, interval: float,
                 callback: Callable[[], None], active: bool = True):
        assert interval > 0
        self._timer = timer
        self._interval = interval
        self._callback = callback
        self._active = False
        # A distinct wrapper per RepeatingTimer so cancel() only hits us.
        def _tick():
            if self._active:
                self._callback()
                if self._active:  # callback may have stopped us
                    self._timer.schedule(self._interval, self._tick)
        self._tick = _tick
        if active:
            self.start()

    def start(self) -> None:
        if not self._active:
            self._active = True
            self._timer.schedule(self._interval, self._tick)

    def stop(self) -> None:
        self._active = False
        self._timer.cancel(self._tick)

    def update_interval(self, interval: float) -> None:
        assert interval > 0
        self._interval = interval
