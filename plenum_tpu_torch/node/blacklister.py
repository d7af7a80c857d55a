"""Peer blacklisting: convert protocol suspicions into ignored peers.

Reference behavior: plenum/server/blacklister.py (SimpleBlacklister) +
node.py:2854-2944 (reportSuspiciousNode) — suspicions that implicate the
PRIMARY become view-change votes; suspicions that implicate an ordinary peer
get that peer blacklisted (its traffic dropped at ingress). Tests whitelist
intentionally-faulty nodes so scenarios don't cascade (test_node.py:88-98).

Unlike the reference's forever-blacklist, entries here EXPIRE after a TTL:
a node that blacklists f+1 peers (e.g. a wave of spoofed traffic before
transport auth caught up, or a bug on the peer's side) would otherwise
sever itself from quorum PERMANENTLY — self-inflicted isolation is a worse
failure mode than re-admitting a misbehaving peer for another round of
suspicion. Found by the wire-protocol fuzz.
"""
from __future__ import annotations

from typing import Callable, Optional

DEFAULT_TTL = 120.0


class Blacklister:
    def __init__(self, whitelist: tuple[str, ...] = (),
                 ttl: float = DEFAULT_TTL,
                 now: Optional[Callable[[], float]] = None):
        # peer -> (expiry, suspicion codes)
        self._blacklisted: dict[str, tuple[float, list[int]]] = {}
        self._whitelist: set[str] = set(whitelist)
        self._ttl = ttl
        self._now = now or (lambda: 0.0)

    def blacklist(self, peer: str, code: int = 0) -> bool:
        """Returns True if the peer is now (or already was) blacklisted."""
        if peer in self._whitelist:
            return False
        expiry = self._now() + self._ttl
        _, codes = self._blacklisted.get(peer, (0.0, []))
        self._blacklisted[peer] = (expiry, codes + [code])
        return True

    def is_blacklisted(self, peer: str) -> bool:
        entry = self._blacklisted.get(peer)
        if entry is None:
            return False
        if self._now() >= entry[0]:
            del self._blacklisted[peer]       # TTL expired: re-admit
            return False
        return True

    def whitelist(self, peer: str) -> None:
        """Forgive + exempt a peer (test fault-injection needs this)."""
        self._whitelist.add(peer)
        self._blacklisted.pop(peer, None)

    @property
    def blacklisted(self) -> dict[str, list[int]]:
        now = self._now()
        return {p: codes for p, (exp, codes) in self._blacklisted.items()
                if now < exp}
