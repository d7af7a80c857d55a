"""BatchID: the identity of one 3PC batch across view changes.

Reference behavior: plenum/server/consensus/batch_id.py — a batch keeps its
original view number (`pp_view_no`) when re-ordered in a later view, so
prepared certificates survive view changes intact.
"""
from __future__ import annotations

from typing import NamedTuple


class BatchID(NamedTuple):
    view_no: int        # view in which the batch is being ordered now
    pp_view_no: int     # view in which its PRE-PREPARE was originally created
    pp_seq_no: int
    pp_digest: str

    def to_list(self) -> list:
        return [self.view_no, self.pp_view_no, self.pp_seq_no, self.pp_digest]

    @classmethod
    def from_seq(cls, items) -> "BatchID":
        return cls(int(items[0]), int(items[1]), int(items[2]), str(items[3]))
