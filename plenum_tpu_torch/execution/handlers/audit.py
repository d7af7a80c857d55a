"""Audit-ledger txn construction and recovery queries.

Reference behavior: plenum/server/request_handlers/audit_handler.py +
batch_handlers/audit_batch_handler.py:83-231 and docs/source/audit_ledger.md —
every ordered 3PC batch appends one audit txn snapshotting (view_no,
pp_seq_no, per-ledger sizes and roots, primaries, node reg). Deltas are stored
as integer back-references ("same as N batches ago") to keep txns small. The
audit ledger is the recovery spine: on restart/catchup a node restores 3PC
position, primaries, and node registry from the last audit txn
(node.py:1830,1875).

The audit ledger has no state trie — its Merkle root itself is consensus-
checked via the PRE-PREPARE's audit_txn_root.
"""
from __future__ import annotations

from typing import Optional, Sequence

from plenum_tpu_torch.common.node_messages import AUDIT_LEDGER_ID
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import AUDIT


def build_audit_txn(db, view_no: int, pp_seq_no: int, pp_time: float,
                    ledger_id: int, primaries: Sequence[str],
                    node_reg: Sequence[str],
                    last_audit: Optional[dict]) -> dict:
    """Snapshot every ledger's uncommitted size/root for this batch."""
    ledger_sizes: dict[str, int] = {}
    ledger_roots: dict[str, object] = {}
    state_roots: dict[str, str] = {}
    last_data = txn_lib.txn_data(last_audit) if last_audit else {}
    for lid, ledger in db.ledgers():
        if lid == AUDIT_LEDGER_ID:
            continue
        key = str(lid)
        # uncommitted_size is the TOTAL (committed + staged): the snapshot
        # must not depend on how much a node happens to have committed yet
        size = ledger.uncommitted_size
        ledger_sizes[key] = size
        prev_size = last_data.get("ledgerSize", {}).get(key)
        if prev_size == size and last_audit is not None:
            # unchanged since the previous audit txn: store a back-reference
            prev_root = last_data.get("ledgerRoot", {}).get(key)
            delta = prev_root + 1 if isinstance(prev_root, int) else 1
            ledger_roots[key] = delta
        else:
            ledger_roots[key] = ledger.uncommitted_root_hash.hex()
        state = db.get_state(lid)
        if state is not None:
            state_roots[key] = state.head_hash.hex()
    data = {"viewNo": view_no,
            "ppSeqNo": pp_seq_no,
            "ledgerId": ledger_id,
            "ledgerSize": ledger_sizes,
            "ledgerRoot": ledger_roots,
            "stateRoot": state_roots,
            "primaries": list(primaries),
            "nodeReg": list(node_reg)}
    txn = txn_lib.new_txn(AUDIT, data)
    txn_lib.set_txn_time(txn, int(pp_time))
    return txn


def resolve_ledger_root(audit_ledger, audit_txn: dict, ledger_id: int) -> Optional[str]:
    """Follow integer back-references to the actual root hex for a ledger."""
    key = str(ledger_id)
    seen = 0
    txn = audit_txn
    while txn is not None and seen < audit_ledger.size + 2:
        root = txn_lib.txn_data(txn).get("ledgerRoot", {}).get(key)
        if isinstance(root, str):
            return root
        if not isinstance(root, int):
            return None
        back_seq = txn_lib.txn_seq_no(txn) - root
        if back_seq < 1:
            return None
        txn = audit_ledger.get_by_seq_no(back_seq)
        seen += 1
    return None


def iter_audit_newest_first(audit_ledger, limit: int = 600):
    """Audit txns newest-first: staged (uncommitted) first, then committed
    by descending seq_no, bounded — the one shared walk every audit-trail
    recovery path uses (3PC restore, primaries resolution, BLS epochs)."""
    n = 0
    for txn in reversed(list(audit_ledger.uncommitted_txns)):
        if n >= limit:
            return
        n += 1
        yield txn
    for seq in range(audit_ledger.size, 0, -1):
        if n >= limit:
            return
        n += 1
        yield audit_ledger.get_by_seq_no(seq)


def node_reg_at_pool_root(audit_ledger, pool_root_hex: str,
                          max_scan: int = 600) -> Optional[list]:
    """Node registry in force at a given POOL state root, from the audit
    trail. Used to judge an embedded BLS multi-sig by the quorum rules of
    the pool size it was created under — the first PRE-PREPARE after a
    membership change legitimately carries a sig whose participant count
    satisfies the OLD n - f (see bls_bft_replica.validate_pre_prepare)."""
    for txn in iter_audit_newest_first(audit_ledger, max_scan):
        data = txn_lib.txn_data(txn)
        if data.get("stateRoot", {}).get("0") == pool_root_hex:
            return data.get("nodeReg")
    return None


def last_audit_txn(audit_ledger) -> Optional[dict]:
    if audit_ledger.size == 0:
        return None
    return audit_ledger.get_by_seq_no(audit_ledger.size)


def last_audited_view(audit_ledger) -> tuple[int, int, list[str]]:
    """-> (view_no, pp_seq_no, primaries) from the last audit txn, for
    restart recovery (ref node.py:1830 select_primaries_on_catchup_complete)."""
    txn = last_audit_txn(audit_ledger)
    if txn is None:
        return 0, 0, []
    data = txn_lib.txn_data(txn)
    return data.get("viewNo", 0), data.get("ppSeqNo", 0), \
        list(data.get("primaries", []))
