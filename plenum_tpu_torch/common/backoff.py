"""Retry pacing primitives: jittered exponential backoff + RTT-adaptive
timeouts.

Reference behavior being hardened: the repo's retry loops (tcp_stack dial
loop, catchup cons-proof/rep re-requests, view-change NEW_VIEW probes)
all used FLAT or synchronized-doubling timers. Two failure modes follow:

* stampedes — every peer's `RETRY_MIN -> RETRY_MAX` doubling is the same
  deterministic sequence, so a pool-wide restart has n-1 dialers knocking
  on each recovering node at the same instants;
* flat-timeout stalls — a 5 s catchup retry under a 50 ms LAN wastes two
  orders of magnitude per lost message, while the same 5 s under an 8 s
  degraded-WAN round trip re-asks before any answer can land.

`ExponentialBackoff` fixes the first (deterministic seeded jitter: replay
identical per (salt), decorrelated across salts). `RttEstimator` fixes the
second (RFC 6298-style srtt + 4*rttvar retransmission timeout, clamped).
Both are pure and clockless so sims, replays, and the asyncio transport
share them unchanged.
"""
from __future__ import annotations

import random
import zlib
from typing import Optional, Union


class ExponentialBackoff:
    """Jittered truncated binary exponential backoff.

    delay(attempt) = U * min(cap, base * factor**attempt)  with
    U ~ uniform[1-jitter, 1] drawn from a PRNG seeded by `salt` — two
    backoffs with different salts desynchronize, the same salt replays
    byte-identically.
    """

    def __init__(self, base: float, cap: float, factor: float = 2.0,
                 jitter: float = 0.5,
                 salt: Union[str, bytes, int] = 0):
        if isinstance(salt, str):
            salt = salt.encode()
        if isinstance(salt, bytes):
            salt = zlib.crc32(salt)
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = max(0.0, min(1.0, jitter))
        self._rng = random.Random(salt)
        self.attempt = 0

    def next(self, base: Optional[float] = None) -> float:
        """Delay for the current attempt (then advance). `base` overrides
        the configured floor for this draw — callers with an adaptive
        (RTT-informed) base pass it here while keeping the growth/jitter
        schedule."""
        b = self.base if base is None else base
        raw = min(self.cap, b * (self.factor ** self.attempt))
        self.attempt += 1
        u = 1.0 - self.jitter * self._rng.random()
        return max(0.0, raw * u)

    def reset(self) -> None:
        """Progress was made: the next failure starts from the floor again
        (the jitter PRNG keeps advancing — resets must not re-synchronize
        two peers that reset at the same moment)."""
        self.attempt = 0


class RttEstimator:
    """RFC 6298-shaped retransmission-timeout estimator.

    note(rtt) folds a measured round trip into srtt/rttvar; timeout()
    returns srtt + 4*rttvar clamped to [floor, cap] (fallback before any
    sample). Pure arithmetic — callers own the clock."""

    ALPHA = 0.125
    BETA = 0.25

    def __init__(self):
        self.srtt: Optional[float] = None
        self.rttvar: float = 0.0
        self.samples = 0

    def note(self, rtt: float) -> None:
        if rtt < 0:
            return
        self.samples += 1
        if self.srtt is None:
            self.srtt = rtt
            self.rttvar = rtt / 2
            return
        self.rttvar = ((1 - self.BETA) * self.rttvar
                       + self.BETA * abs(self.srtt - rtt))
        self.srtt = (1 - self.ALPHA) * self.srtt + self.ALPHA * rtt

    def timeout(self, floor: float, cap: float,
                fallback: Optional[float] = None) -> float:
        """Adaptive wait-before-retry. Unmeasured links fall back to
        `fallback` (or cap): a fresh node must not retry-storm a WAN it
        has never timed."""
        if self.srtt is None:
            base = cap if fallback is None else fallback
        else:
            base = self.srtt + 4 * self.rttvar
        return max(floor, min(cap, base))
