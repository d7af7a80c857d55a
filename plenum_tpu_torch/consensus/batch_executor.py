"""Execution seam between consensus and the request-execution layer.

Reference behavior: the OrderingService applies requests to *uncommitted*
ledger/state before consensus completes (ordering_service.py:1138
_apply_pre_prepare via write_manager.apply_request) and reverts them on
rejection or view change (:1229 _revert). Consensus only sees this narrow
protocol; the real implementation is the WriteRequestManager + batch handlers
(plenum_tpu_torch/execution/), and tests drive consensus with the in-memory stub.
"""
from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from contextlib import nullcontext
from typing import NamedTuple, Optional, Sequence

from plenum_tpu_torch.common.request import Request


class AppliedBatch(NamedTuple):
    state_root: str                 # uncommitted state root AFTER apply (base58/hex)
    txn_root: str                   # uncommitted txn-ledger root AFTER apply
    pool_state_root: str
    audit_txn_root: str
    valid_digests: tuple[str, ...]  # requests applied
    discarded: tuple[str, ...]      # requests rejected by dynamic validation


class BatchExecutor(ABC):
    """What consensus needs from the execution layer — nothing more."""

    @abstractmethod
    def apply_batch(self, ledger_id: int, requests: Sequence[Request],
                    pp_time: float, view_no: int, pp_seq_no: int,
                    primaries=None) -> AppliedBatch:
        """Dynamic-validate + apply to uncommitted ledger/state; returns
        roots. view_no/primaries are the batch's ORIGINAL view and its
        primaries (audit-txn reproducibility across re-ordering)."""

    @abstractmethod
    def revert_last_batch(self, ledger_id: int) -> None:
        """Undo the most recently applied uncommitted batch for this ledger."""

    @abstractmethod
    def ledger_id_for(self, request: Request) -> int:
        """Which ledger a request's txn type writes to."""

    def group_commit(self):
        """Context manager grouping every durable write issued inside into
        one atomic flush per store. Executors without durable storage
        (this default) make it a no-op scope."""
        return nullcontext(self)


class SimBatchExecutor(BatchExecutor):
    """Deterministic in-memory executor for consensus unit/sim tests: the
    'state' is a hash chain over applied request digests, so identical request
    streams yield identical roots on every node — and nothing else."""

    def __init__(self, reject: Optional[set[str]] = None):
        self.applied: list[tuple[int, tuple[str, ...]]] = []   # (ledger_id, digests)
        self.committed: list[tuple[str, ...]] = []
        self.reject = reject or set()
        self._roots: dict[int, str] = {}

    def _root(self, ledger_id: int) -> str:
        return self._roots.get(ledger_id, "genesis")

    def apply_batch(self, ledger_id, requests, pp_time, view_no, pp_seq_no,
                    primaries=None):
        valid, discarded = [], []
        for req in requests:
            (discarded if req.digest in self.reject else valid).append(req.digest)
        mix = self._root(ledger_id) + "".join(valid) + str(pp_seq_no)
        new_root = hashlib.sha256(mix.encode()).hexdigest()
        self.applied.append((ledger_id, tuple(valid)))
        prev = self._roots.copy()
        self._roots[ledger_id] = new_root
        self._prev_roots = getattr(self, "_prev_roots", [])
        self._prev_roots.append(prev)
        return AppliedBatch(state_root=new_root,
                            txn_root=new_root[:32],
                            pool_state_root=self._root(0),
                            audit_txn_root=new_root[32:],
                            valid_digests=tuple(valid),
                            discarded=tuple(discarded))

    def revert_last_batch(self, ledger_id: int) -> None:
        for i in range(len(self.applied) - 1, -1, -1):
            if self.applied[i][0] == ledger_id:
                self.applied.pop(i)
                self._roots = self._prev_roots.pop(i)
                return
        raise ValueError(f"no applied batch for ledger {ledger_id}")

    def ledger_id_for(self, request: Request) -> int:
        from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
        return DOMAIN_LEDGER_ID
