"""Suspicion codes: every protocol violation a node can observe.

Reference behavior: plenum/server/suspicion_codes.py — numbered codes attached
to InstanceChange votes and blacklist reports so operators can tell WHY a node
voted for a view change or blacklisted a peer.
"""
from __future__ import annotations

from typing import NamedTuple


class Suspicion(NamedTuple):
    code: int
    reason: str


class Suspicions:
    PPR_FRM_NON_PRIMARY = Suspicion(1, "PRE-PREPARE from a non-primary")
    PR_FRM_PRIMARY = Suspicion(2, "PREPARE from the primary")
    DUPLICATE_PPR_SENT = Suspicion(3, "duplicate PRE-PREPARE for a 3PC key")
    DUPLICATE_PR_SENT = Suspicion(4, "duplicate PREPARE from one sender")
    DUPLICATE_CM_SENT = Suspicion(5, "duplicate COMMIT from one sender")
    PPR_DIGEST_WRONG = Suspicion(6, "PRE-PREPARE request digest mismatch")
    PR_DIGEST_WRONG = Suspicion(7, "PREPARE digest mismatch")
    PPR_REJECT_WRONG = Suspicion(8, "PRE-PREPARE rejected-request set mismatch")
    PPR_STATE_WRONG = Suspicion(9, "PRE-PREPARE state root mismatch")
    PPR_TXN_WRONG = Suspicion(10, "PRE-PREPARE txn root mismatch")
    PR_STATE_WRONG = Suspicion(11, "PREPARE state root mismatch")
    PR_TXN_WRONG = Suspicion(12, "PREPARE txn root mismatch")
    PPR_TIME_WRONG = Suspicion(13, "PRE-PREPARE time outside acceptable deviation")
    CM_BLS_WRONG = Suspicion(14, "COMMIT carries an invalid BLS signature")
    PPR_BLS_MULTISIG_WRONG = Suspicion(15, "PRE-PREPARE carries invalid BLS multi-sig")
    PRIMARY_DEGRADED = Suspicion(20, "master primary throughput degraded")
    PRIMARY_DISCONNECTED = Suspicion(21, "primary disconnected")
    PRIMARY_STALLED = Suspicion(22, "no expected freshness batch from primary")
    INSTANCE_CHANGE_TIMEOUT = Suspicion(23, "view change failed to complete in time")
    STATE_SIGS_ARE_NOT_UPDATED = Suspicion(24, "state freshness not updated in time")
    PPR_AUDIT_TXN_ROOT_WRONG = Suspicion(25, "PRE-PREPARE audit txn root mismatch")
    CATCHUP_NEEDED = Suspicion(26, "node fell behind checkpoint quorum")
    BACKUP_INSTANCE_STALLED = Suspicion(27, "backup instance ordering stalled")
    PRIMARY_DEMOTED = Suspicion(28, "primary demoted from the validator set")
    NEW_VIEW_INVALID = Suspicion(30, "NEW_VIEW message failed validation")
    INVALID_REQ_SIGNATURE = Suspicion(31, "client request signature invalid")

    @classmethod
    def get_by_code(cls, code: int) -> Suspicion:
        for value in vars(cls).values():
            if isinstance(value, Suspicion) and value.code == code:
                return value
        return Suspicion(code, "unknown suspicion")
