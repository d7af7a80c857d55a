"""Byzantine quorum arithmetic.

Reference behavior: plenum/server/quorums.py:15-39 — every vote threshold in the
protocol derives from the pool size n and the tolerated faults f = floor((n-1)/3).
"""
from dataclasses import dataclass, field


def faults(n: int) -> int:
    """Max Byzantine faults tolerated by an n-node pool: f = floor((n-1)/3)."""
    return (n - 1) // 3


@dataclass(frozen=True)
class Quorum:
    value: int

    def is_reached(self, votes: int) -> bool:
        return votes >= self.value


class Quorums:
    """All protocol vote thresholds for a pool of n nodes.

    Mirrors the quorum table of the reference (quorums.py:15-39): propagate f+1,
    prepare n-f-1, commit n-f, view_change n-f, checkpoint n-f-1, etc.
    """

    def __init__(self, n: int):
        self.n = n
        self.f = faults(n)
        f = self.f
        self.propagate = Quorum(f + 1)
        self.prepare = Quorum(n - f - 1)
        self.commit = Quorum(n - f)
        self.reply = Quorum(f + 1)
        self.view_change = Quorum(n - f)
        self.view_change_ack = Quorum(n - f - 1)
        self.view_change_done = Quorum(n - f)
        self.election = Quorum(n - f)
        self.checkpoint = Quorum(n - f - 1)
        self.timestamp = Quorum(f + 1)
        self.bls_signatures = Quorum(n - f)
        self.observer_data = Quorum(f + 1)
        self.consistency_proof = Quorum(f + 1)
        self.ledger_status = Quorum(n - f - 1)
        self.backup_instance_faulty = Quorum(f + 1)
        self.weak = Quorum(f + 1)
        self.strong = Quorum(n - f)

    def __repr__(self):
        return f"Quorums(n={self.n}, f={self.f})"
