"""BatchExecutor implementation over real ledgers/state.

Bridges the consensus engine's narrow seam (consensus/batch_executor.py,
mirroring ordering_service.py:1138 _apply_pre_prepare / :1229 _revert) to the
WriteRequestManager. Roots cross the seam as hex strings (consensus compares
them against PRE-PREPARE fields); bytes stay inside the execution layer.
"""
from __future__ import annotations

from typing import Sequence

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.consensus.batch_executor import AppliedBatch, BatchExecutor
from plenum_tpu_torch.execution.write_manager import ThreePcBatch, WriteRequestManager


class LedgerBatchExecutor(BatchExecutor):
    def __init__(self, write_manager: WriteRequestManager):
        self.write_manager = write_manager

    def apply_batch(self, ledger_id: int, requests: Sequence[Request],
                    pp_time: float, view_no: int, pp_seq_no: int,
                    primaries=None) -> AppliedBatch:
        valid, rejected, roots = self.write_manager.apply_batch(
            ledger_id, requests, pp_time, view_no, pp_seq_no,
            primaries=primaries)
        return AppliedBatch(
            state_root=roots["state_root"],
            txn_root=roots["txn_root"],
            pool_state_root=roots["pool_state_root"],
            audit_txn_root=roots["audit_txn_root"],
            valid_digests=tuple(r.digest for r in valid),
            discarded=tuple(r.digest for r, _ in rejected))

    def revert_last_batch(self, ledger_id: int) -> None:
        self.write_manager.revert_last_batch(ledger_id)

    def ledger_id_for(self, request: Request) -> int:
        return self.write_manager.ledger_id_for(request)

    def commit_batch(self, batch: ThreePcBatch) -> list[dict]:
        return self.write_manager.commit_batch(batch)

    def group_commit(self):
        """Context manager: stretch ONE durable flush per store across all
        commit_batch calls made inside the scope (multi-batch group
        commit — the node drains every ready Ordered under one scope)."""
        return self.write_manager.db.group_commit()
