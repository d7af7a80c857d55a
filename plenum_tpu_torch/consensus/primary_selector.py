"""Primary selection: deterministic round-robin over the validator registry.

Reference behavior: plenum/server/consensus/primary_selector.py:11,52 — the
master primary for view v is validators[v mod N]; backup instance i takes the
next rank (v + i) mod N. All nodes compute the same list locally; nothing is
negotiated.
"""
from __future__ import annotations


class RoundRobinPrimariesSelector:
    def select_primaries(self, view_no: int, instance_count: int,
                         validators: list[str]) -> list[str]:
        n = len(validators)
        if n == 0:
            return []
        return [validators[(view_no + i) % n] for i in range(instance_count)]

    def select_master_primary(self, view_no: int, validators: list[str]) -> str:
        return self.select_primaries(view_no, 1, validators)[0]
