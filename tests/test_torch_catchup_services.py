"""The port's copy of tests/test_catchup_services.py, run on plenum_tpu_torch.

Unit tests for catchup service hardening:

- ConsProofService must quorum the 3PC key itself (f+1 matching non-None
  votes, minimum quorumed key) — one Byzantine peer echoing the honest
  (size, root) must not pick the pool's 3PC position
  (ref cons_proof_service.py _get_last_txn_3PC_key).
- CatchupRepService must apply reps that overlap already-applied txns
  (trim the prefix), drop fully-stale reps, and keep the retry timer armed
  while running (ref catchup_rep_service.py applies seqNo > ledger size).
- SeederService must decline a CatchupReq it cannot prove to catchup_till
  rather than ship a rep that gets an honest lagging peer blacklisted.
"""
import pytest

from plenum_tpu_torch.catchup.cons_proof import ConsProofService
from plenum_tpu_torch.catchup.rep import CatchupRepService
from plenum_tpu_torch.catchup.seeder import SeederService
from plenum_tpu_torch.common.node_messages import (CatchupRep, CatchupReq,
                                             ConsistencyProof)
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.ledger.ledger import Ledger

LID = 1


class DbStub:
    def __init__(self, ledger):
        self._ledger = ledger

    def get_ledger(self, ledger_id):
        return self._ledger if ledger_id == LID else None


def make_txns(n):
    return [{"seq": i, "payload": f"txn-{i}"} for i in range(1, n + 1)]


def proof_msg(source: Ledger, from_size: int, view_no, pp_seq_no):
    return ConsistencyProof(
        ledger_id=LID, seq_no_start=0, seq_no_end=source.size,
        view_no=view_no, pp_seq_no=pp_seq_no,
        old_merkle_root="", new_merkle_root=source.root_hash.hex(),
        hashes=tuple(source.consistency_proof(from_size, source.size))
        if from_size > 0 else ())


# --- ConsProofService: 3PC key quorum ----------------------------------------

class ConsProofHarness:
    def __init__(self, n=4):
        self.ledger = Ledger()
        self.targets = []
        self.svc = ConsProofService(
            LID, DbStub(self.ledger), lambda: Quorums(n),
            send=lambda msg, dst: None,
            on_target=lambda lid, target: self.targets.append(target))
        self.svc.start()


def test_byzantine_3pc_key_not_adopted():
    """A single peer echoing the honest (size, root) with an absurd 3PC key
    must not have its key adopted — no f+1 quorum on it means None."""
    h = ConsProofHarness()
    source = Ledger(genesis_txns=make_txns(5))
    h.svc.process_consistency_proof(proof_msg(source, 0, 0, 5), "B")   # honest
    h.svc.process_consistency_proof(proof_msg(source, 0, 999, 999), "C")  # byz
    assert len(h.targets) == 1
    size, root, last_3pc = h.targets[0]
    assert size == 5 and root == source.root_hash.hex()
    assert last_3pc is None          # old code adopted (999, 999): last wins


def test_quorumed_3pc_key_adopted():
    h = ConsProofHarness()
    source = Ledger(genesis_txns=make_txns(5))
    h.svc.process_consistency_proof(proof_msg(source, 0, 0, 5), "B")
    h.svc.process_consistency_proof(proof_msg(source, 0, 0, 5), "C")
    assert h.targets == [(5, source.root_hash.hex(), (0, 5))]


def test_none_3pc_votes_filtered():
    """Proofs carrying view_no/pp_seq_no=None must not crash nor count."""
    h = ConsProofHarness()
    source = Ledger(genesis_txns=make_txns(3))
    h.svc.process_consistency_proof(proof_msg(source, 0, None, None), "B")
    h.svc.process_consistency_proof(proof_msg(source, 0, None, None), "C")
    assert len(h.targets) == 1
    assert h.targets[0][2] is None


def test_min_quorumed_3pc_key_wins():
    h = ConsProofHarness()
    key = (5, "ab" * 32)
    h.svc._last_3pc_votes[key] = {(2, 9): {"B", "C"}, (0, 5): {"D", "E"},
                                  (7, 1): {"F"}}      # (7,1) not quorumed
    assert h.svc._quorumed_3pc(key) == (0, 5)


# --- CatchupRepService: overlapping and stale reps ---------------------------

class RepHarness:
    def __init__(self, committed=2, target=6, retry_timeout=5.0):
        self.source = Ledger(genesis_txns=make_txns(target))
        self.ledger = Ledger(genesis_txns=make_txns(committed))
        self.timer = MockTimer()
        self.sent = []
        self.added = []
        self.completed = []
        self.svc = CatchupRepService(
            LID, DbStub(self.ledger),
            send=lambda msg, dst: self.sent.append((msg, dst)),
            timer=self.timer, peers_provider=lambda: ["A", "B"],
            on_txn_added=lambda lid, txn: self.added.append(txn),
            on_complete=lambda lid: self.completed.append(lid),
            retry_timeout=retry_timeout)
        self.svc.start(self.source.size, self.source.root_hash.hex())

    def rep(self, lo, hi, frm="A"):
        txns = {str(i): self.source.get_by_seq_no(i) for i in range(lo, hi + 1)}
        proof = () if hi == self.source.size else \
            tuple(self.source.consistency_proof(hi, self.source.size))
        self.svc.process_catchup_rep(
            CatchupRep(ledger_id=LID, txns=txns, cons_proof=proof), frm)


def test_overlapping_rep_applied_with_prefix_trim():
    """Chunks with different boundaries (honest timeout re-splits) overlap;
    the applied prefix is trimmed instead of wedging the catchup."""
    h = RepHarness(committed=2, target=6)
    h.rep(3, 4, frm="A")
    assert h.ledger.size == 4
    h.rep(4, 6, frm="B")         # overlaps seq 4, already applied
    assert h.ledger.size == 6
    assert h.ledger.root_hash == h.source.root_hash
    assert h.completed == [LID]
    assert "B" not in h.svc._blacklisted_peers


def test_fully_stale_rep_dropped_and_retry_stays_armed():
    """A rep covering only already-applied txns is dropped; because its range
    'covers' the request window the old code computed missing=[] and never
    rescheduled the retry — the service stalled forever."""
    h = RepHarness(committed=2, target=4)
    h.rep(1, 4, frm="A")         # covers everything incl. applied 1-2
    assert h.ledger.size == 4    # prefix trimmed, applied to target
    assert h.completed == [LID]

    # now the stall scenario proper: a rep that is pending but unusable
    h2 = RepHarness(committed=2, target=6)
    h2.rep(1, 2, frm="A")        # fully stale: nothing new
    assert h2.ledger.size == 2
    assert h2.svc.is_running
    before = len(h2.sent)
    h2.timer.advance(6.0)        # retry must still be armed
    assert len(h2.sent) > before, "retry timer was not rearmed"
    # and the retried requests let the catchup finish
    h2.rep(3, 6, frm="B")
    assert h2.completed == [LID]


def test_gap_rep_waits_without_apply():
    h = RepHarness(committed=2, target=6)
    h.rep(5, 6, frm="B")         # gap: 3-4 missing
    assert h.ledger.size == 2
    h.rep(3, 4, frm="A")
    assert h.ledger.size == 6
    assert h.completed == [LID]


def test_retry_rotates_peers():
    """A silently-declining peer (itself behind the target) must not be
    re-asked for the same chunk on every retry pass."""
    h = RepHarness(committed=2, target=3)     # single missing chunk
    first = {dst[0] for msg, dst in h.sent}
    for _ in range(3):
        before = len(h.sent)
        h.timer.advance(6.0)
        assert len(h.sent) > before
    asked = [dst[0] for msg, dst in h.sent]
    assert set(asked) == {"A", "B"}, f"assignment never rotated: {asked}"


# --- SeederService: decline unprovable ranges --------------------------------

def test_seeder_declines_when_behind_target():
    ledger = Ledger(genesis_txns=make_txns(4))
    sent = []
    seeder = SeederService(DbStub(ledger),
                           send=lambda msg, dst: sent.append((msg, dst)),
                           last_3pc=lambda: (0, 0))
    seeder.process_catchup_req(
        CatchupReq(ledger_id=LID, seq_no_start=1, seq_no_end=6,
                   catchup_till=6), "B")
    assert sent == []            # lagging peer declines instead of lying
    seeder.process_catchup_req(
        CatchupReq(ledger_id=LID, seq_no_start=1, seq_no_end=4,
                   catchup_till=4), "B")
    assert len(sent) == 1 and sorted(int(k) for k in sent[0][0].txns) == [1, 2, 3, 4]
