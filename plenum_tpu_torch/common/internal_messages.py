"""Internal bus events between a node's services (never hit the wire).

Reference behavior: plenum/common/messages/internal_messages.py — ~40 event
types; the ones here cover the ordering / checkpoint / view-change / catchup
interactions built so far.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional


class RequestPropagates(NamedTuple):
    bad_requests: tuple


class ReqKey(NamedTuple):
    """Finalized request forwarded to replica queues."""
    digest: str


class ApplyNewView(NamedTuple):
    view_no: int


class NeedViewChange(NamedTuple):
    view_no: Optional[int] = None


class ViewChangeStarted(NamedTuple):
    view_no: int


class NewViewAccepted(NamedTuple):
    view_no: int
    checkpoint: tuple
    batches: tuple


class NewViewCheckpointsApplied(NamedTuple):
    view_no: int
    checkpoint: tuple
    batches: tuple


class VoteForViewChange(NamedTuple):
    suspicion_code: int
    view_no: Optional[int] = None


class NodeNeedViewChange(NamedTuple):
    view_no: int


class PrimarySelected(NamedTuple):
    view_no: int
    primaries: tuple


class CheckpointStabilized(NamedTuple):
    inst_id: int
    last_stable_3pc: tuple


class NeedBackupCatchup(NamedTuple):
    inst_id: int
    caught_up_till_3pc: tuple


class NeedMasterCatchup(NamedTuple):
    pass


class CatchupStarted(NamedTuple):
    pass


class CatchupFinished(NamedTuple):
    last_caught_up_3pc: tuple
    master_last_ordered: tuple


class LedgerCatchupStarted(NamedTuple):
    ledger_id: int


class LedgerCatchupComplete(NamedTuple):
    ledger_id: int
    num_caught_up: int
    last_3pc: Optional[tuple] = None


class ParticipatingStatus(NamedTuple):
    participating: bool


class BackupSetupLastOrdered(NamedTuple):
    inst_id: int


class RaisedSuspicion(NamedTuple):
    inst_id: int
    code: int
    reason: str
    sender: str = ""       # peer whose message raised the suspicion


class MissingMessage(NamedTuple):
    msg_type: str
    key: Any
    inst_id: int
    dst: Optional[list]
    stash_data: Optional[tuple] = None


class Cleanup(NamedTuple):
    pass


class MasterReorderedAfterVC(NamedTuple):
    pass
