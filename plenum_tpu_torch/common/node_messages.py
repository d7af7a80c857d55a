"""The node-to-node and node-to-client wire protocol.

Reference behavior: plenum/common/messages/node_messages.py — ~40 typed messages
discriminated by `op`. Field names here are snake_case but carry the same
content: 3PC messages are keyed by (inst_id, view_no, pp_seq_no); COMMIT carries
the sender's BLS signature over the state root (ref :205-209); PRE-PREPARE
carries the previous batch's aggregated multi-sig (ref :118).
"""
from __future__ import annotations

from typing import Any, Optional

from .message_base import MessageBase, wire_message

# Ledger ids (ref plenum/server/node.py:142 — catchup order audit, pool, config, domain)
AUDIT_LEDGER_ID = 3
POOL_LEDGER_ID = 0
CONFIG_LEDGER_ID = 2
DOMAIN_LEDGER_ID = 1
VALID_LEDGER_IDS = (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID, AUDIT_LEDGER_ID)


class ThreePhaseMsg(MessageBase):
    """Common shape of PRE-PREPARE / PREPARE / COMMIT."""
    def validate(self) -> None:
        self._require(self.inst_id >= 0, "inst_id must be >= 0")
        self._require(self.view_no >= 0, "view_no must be >= 0")
        self._require(self.pp_seq_no >= 1, "pp_seq_no must be >= 1")


@wire_message
class PrePrepare(ThreePhaseMsg):
    typename = "PREPREPARE"
    inst_id: int
    view_no: int
    pp_seq_no: int
    pp_time: float
    req_idr: tuple[str, ...]          # digests of requests in this batch
    discarded: tuple[str, ...]        # digests rejected during dynamic validation
    digest: str                       # batch digest
    ledger_id: int
    state_root: str                   # uncommitted state root AFTER applying batch
    txn_root: str                     # uncommitted txn-ledger root AFTER applying batch
    pool_state_root: str = ""
    audit_txn_root: str = ""
    bls_multi_sig: Optional[tuple] = None   # prev batch's aggregated sig (ref bls update_pre_prepare)
    original_view_no: Optional[int] = None  # set when re-ordered after view change


@wire_message
class Prepare(ThreePhaseMsg):
    typename = "PREPARE"
    inst_id: int
    view_no: int
    pp_seq_no: int
    pp_time: float
    digest: str
    state_root: str
    txn_root: str
    audit_txn_root: str = ""


@wire_message
class Commit(ThreePhaseMsg):
    typename = "COMMIT"
    inst_id: int
    view_no: int
    pp_seq_no: int
    bls_sig: Optional[str] = None     # sender's BLS sig over the state root (ref :205)
    bls_sigs: Optional[dict] = None   # per-ledger sigs (multi-sig-per-ledger mode)


@wire_message
class Checkpoint(MessageBase):
    typename = "CHECKPOINT"
    inst_id: int
    view_no: int
    seq_no_start: int
    seq_no_end: int
    digest: str                       # audit-ledger root at seq_no_end (ref checkpoint_service.py:147)

    def validate(self) -> None:
        self._require_non_negative("inst_id", "view_no")
        self._require(self.seq_no_end >= self.seq_no_start >= 0, "bad checkpoint range")


@wire_message
class InstanceChange(MessageBase):
    typename = "INSTANCE_CHANGE"
    view_no: int                      # proposed view
    reason: int                       # suspicion code

    def validate(self) -> None:
        self._require_non_negative("view_no")


@wire_message
class ViewChange(MessageBase):
    typename = "VIEW_CHANGE"
    view_no: int
    stable_checkpoint: int
    # BatchID 4-tuples: (view_no, pp_view_no, pp_seq_no, pp_digest)
    prepared: tuple[tuple[int, int, int, str], ...]
    preprepared: tuple[tuple[int, int, int, str], ...]
    checkpoints: tuple[tuple[int, int, int, str], ...]  # Checkpoint tuples (view,start,end,digest)

    def validate(self) -> None:
        self._require_non_negative("view_no", "stable_checkpoint")


@wire_message
class ViewChangeAck(MessageBase):
    typename = "VIEW_CHANGE_ACK"
    view_no: int
    name: str                         # author of the ViewChange being acked
    digest: str


@wire_message
class NewView(MessageBase):
    typename = "NEW_VIEW"
    view_no: int
    view_changes: tuple[tuple[str, str], ...]      # (author, vc digest)
    checkpoint: tuple[int, int, int, str]          # selected stable checkpoint
    batches: tuple[tuple[int, int, int, str], ...]  # BatchIDs to re-order in the new view


@wire_message
class Ordered(MessageBase):
    """Replica → node: a batch reached commit quorum (internal but serializable)."""
    typename = "ORDERED"
    inst_id: int
    view_no: int
    pp_seq_no: int
    pp_time: float
    req_idr: tuple[str, ...]
    discarded: tuple[str, ...]
    ledger_id: int
    state_root: str
    txn_root: str
    audit_txn_root: str = ""
    original_view_no: Optional[int] = None


@wire_message
class Propagate(MessageBase):
    """Request-dissemination vote. Two shapes share the op (wire compat):
    full-body (`request` set — the legacy form, still what the digest-
    designated disseminator and MessageRep fetch replies carry) and
    digest-only (`digest` set, no body — every other node's vote under
    digest-gossip; the digest is the sha256 request digest, so a vote is
    ~100 B instead of a full re-serialized request body)."""
    typename = "PROPAGATE"
    request: Optional[dict] = None    # full client request dict (body form)
    sender_client: Optional[str] = None
    digest: str = ""                  # request digest (digest-only form)

    def validate(self) -> None:
        self._require(self.request is not None or self.digest != "",
                      "needs a request body or a digest")


@wire_message
class PropagateBatch(MessageBase):
    """One prod tick's propagate traffic coalesced into a single envelope:
    digest-only votes ride as compact (digest, sender_client) pairs,
    full bodies as nested Propagate dicts — so the n^2 propagate *message
    count* (framing, from_dict, inbox handling) amortizes across every
    request in flight in the same tick."""
    typename = "PROPAGATE_BATCH"
    votes: tuple[tuple[str, Optional[str]], ...] = ()
    bodies: tuple[dict, ...] = ()

    def validate(self) -> None:
        self._require(bool(self.votes) or bool(self.bodies),
                      "empty propagate batch")
        for d, _client in self.votes:
            self._require(bool(d), "vote with empty digest")


@wire_message
class LedgerStatus(MessageBase):
    typename = "LEDGER_STATUS"
    ledger_id: int
    txn_seq_no: int
    merkle_root: str
    view_no: Optional[int] = None
    pp_seq_no: Optional[int] = None
    # True on a seeder's acknowledgment so the peer's seeder does not answer
    # an answer (status ping-pong between two up-to-date nodes)
    is_reply: bool = False

    def validate(self) -> None:
        self._require_non_negative("ledger_id", "txn_seq_no", "view_no", "pp_seq_no")


@wire_message
class ConsistencyProof(MessageBase):
    typename = "CONSISTENCY_PROOF"
    ledger_id: int
    seq_no_start: int
    seq_no_end: int
    view_no: int
    pp_seq_no: int
    old_merkle_root: str
    new_merkle_root: str
    hashes: tuple[str, ...]

    def validate(self) -> None:
        self._require_non_negative("ledger_id", "seq_no_start", "seq_no_end",
                                   "view_no", "pp_seq_no")


@wire_message
class CatchupReq(MessageBase):
    typename = "CATCHUP_REQ"
    ledger_id: int
    seq_no_start: int
    seq_no_end: int
    catchup_till: int

    def validate(self) -> None:
        self._require_non_negative("ledger_id")
        self._require(1 <= self.seq_no_start <= self.seq_no_end,
                      "bad catchup range")


@wire_message
class CatchupRep(MessageBase):
    typename = "CATCHUP_REP"
    ledger_id: int
    txns: dict                        # seq_no(str) -> txn dict
    cons_proof: tuple[str, ...]


@wire_message
class MessageReq(MessageBase):
    typename = "MESSAGE_REQUEST"
    msg_type: str
    params: dict


@wire_message
class MessageRep(MessageBase):
    typename = "MESSAGE_RESPONSE"
    msg_type: str
    params: dict
    msg: Optional[dict] = None


@wire_message
class RequestAck(MessageBase):
    typename = "REQACK"
    identifier: str
    req_id: int


@wire_message
class RequestNack(MessageBase):
    typename = "REQNACK"
    identifier: str
    req_id: int
    reason: str


@wire_message
class Reject(MessageBase):
    typename = "REJECT"
    identifier: str
    req_id: int
    reason: str


@wire_message
class LoadShed(MessageBase):
    """Explicit admission-control refusal from the ingress plane
    (ingress/plane.py): the request was never queued — shed-before-wedge.
    Distinct from REQNACK (which judges the request itself): a shed says
    nothing about validity, only that the front door is over its
    watermark, so a client may retry after backing off."""
    typename = "LOAD_SHED"
    identifier: str
    req_id: int
    reason: str
    retry_after: float = 0.0          # advisory client backoff (seconds)

    def validate(self) -> None:
        self._require_non_negative("retry_after")


@wire_message
class Reply(MessageBase):
    typename = "REPLY"
    result: dict                      # committed txn incl. seq_no, merkle proof


@wire_message
class Batch(MessageBase):
    """Transport-level coalescing of several messages (ref common/batched.py)."""
    typename = "BATCH"
    messages: tuple[dict, ...]


@wire_message
class BackupInstanceFaulty(MessageBase):
    """Vote that a BACKUP protocol instance has stalled (ref
    server/backup_instance_faulty_processor.py + node_messages
    BackupInstanceFaulty): f+1 distinct voters remove the instance."""
    typename = "BACKUP_INSTANCE_FAULTY"
    view_no: int
    inst_id: int
    reason: int                       # suspicion code

    def validate(self) -> None:
        self._require_non_negative("view_no", "reason")
        self._require(self.inst_id >= 1,
                      "only backup instances (inst_id >= 1) can be "
                      "voted faulty")


@wire_message
class BatchCommitted(MessageBase):
    """Observer push of a committed batch (ref node_messages.py:496)."""
    typename = "BATCH_COMMITTED"
    requests: tuple[dict, ...]
    ledger_id: int
    inst_id: int
    view_no: int
    pp_seq_no: int
    pp_time: float
    state_root: str
    txn_root: str
    seq_no_start: int
    seq_no_end: int
    # newest BLS multi-signature the pushing validator holds for this
    # ledger (MultiSignature.to_list()), so observers can anchor verified
    # reads (ingress/observer_reads.py). OPTIONAL and EXCLUDED from the
    # observer's f+1 content quorum: honest validators legitimately
    # aggregate different COMMIT-sig subsets (different participant
    # lists), and the sig is self-verifying against the pool BLS keys —
    # it needs verification, not agreement.
    multi_sig: Optional[tuple] = None

    def quorum_dict(self) -> dict:
        """The content the observer push quorum votes on (multi_sig
        stripped — see field comment)."""
        d = self.to_dict()
        d.pop("multi_sig", None)
        return d


@wire_message
class ObservedData(MessageBase):
    typename = "OBSERVED_DATA"
    msg_type: str
    msg: dict


@wire_message
class Telemetry(MessageBase):
    """Best-effort fleet-telemetry snapshot (observability/snapshot.py):
    one node's periodic health/counters payload shipped to whichever
    peer hosts a FleetAggregator. It carries no protocol state, is never
    re-requested, and a receiver without an aggregator attached simply
    drops it. (It rides the SAME bus/outbox as consensus traffic — there
    is no transport-level prioritization; the volume budget is one
    compact snapshot per TELEMETRY_INTERVAL.)"""
    typename = "TELEMETRY"
    snapshot: dict


def three_pc_key(msg) -> tuple[int, int]:
    return (msg.view_no, msg.pp_seq_no)
