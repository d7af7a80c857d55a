"""The port's copy of tests/test_cross_write.py, run on plenum_tpu_torch (nodes on
the CPU).

Proof-carrying cross-shard writes (shards/cross_write.py): the
fail-closed 2PC — happy path, every abort row of the matrix
(docs/sharding.md "Cross-shard writes"), and crash recovery from
durable state alone. The invariant under test everywhere: NO
half-commits — the home write and the remote write land together or
not at all."""
from __future__ import annotations

import json

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import ATTRIB, GET_NYM, NYM

from test_torch_shards import make_fabric, signed_write, user_on_shard


def _fab_with_dep():
    """2-shard fabric with a dependency DID ordered on shard 1."""
    fab = make_fabric()
    dep = user_on_shard(fab, 1, b"xwdep")
    fab.submit_write(signed_write(fab, dep, 1))
    fab.run(8.0)
    assert fab.shards[1].domain_sizes() == {2}
    return fab, dep


def _nym_applied(fab, sid, did) -> bool:
    node = next(iter(fab.shards[sid].nodes.values()))
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    return any(
        txn_lib.txn_data(ledger.get_by_seq_no(i)).get("dest") == did
        and txn_lib.txn_type_of(ledger.get_by_seq_no(i)) == NYM
        for i in range(2, ledger.size + 1))


def _attrib_applied(fab, sid, did) -> bool:
    node = next(iter(fab.shards[sid].nodes.values()))
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    for i in range(2, ledger.size + 1):
        txn = ledger.get_by_seq_no(i)
        if txn_lib.txn_type_of(txn) != ATTRIB:
            continue
        data = txn_lib.txn_data(txn)
        if data.get("dest") == did and "linked" in (data.get("raw") or ""):
            return True
    return False


def _begin(fab, xsw, dep, tag: bytes, start: int = 0):
    home = user_on_shard(fab, 0, tag, start=start)
    txid = xsw.begin(
        0, 1,
        {"type": NYM, "dest": home.identifier, "verkey": home.verkey_b58},
        {"type": GET_NYM, "dest": dep.identifier},
        {"type": ATTRIB, "dest": dep.identifier,
         "raw": json.dumps({"linked": home.identifier})})
    return home, txid


def test_cross_write_commits_atomically():
    """Happy path: witness read -> ordered prepare carrying BOTH proofs
    -> lock -> ANCHORED ack -> commit; both halves applied."""
    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    home, txid = _begin(fab, xsw, dep, b"xwh")
    assert xsw.drive(txid) == "committed"
    assert _nym_applied(fab, 0, home.identifier)
    assert _attrib_applied(fab, 1, dep.identifier)
    assert xsw.participant(1).locks == {}        # released on commit
    # the ordered prepare record LITERALLY carries the witness: the
    # remote read proof + the mapping ownership proof, auditable from
    # the coordinator shard's ledger alone
    recs = xsw._scan_records(0)
    prep = recs[txid]["prepare"]
    result = prep["witness"]["result"]
    assert "read_proof" in result and "shard_proof" in result
    assert prep["intent"]["epoch"] == 0
    assert recs[txid]["decision"]["decision"] == "commit"


def test_cross_write_aborts_on_epoch_change():
    """The map ratchets between lock and commit: the ownership its
    witness was judged under is superseded — abort, nothing applied."""
    from plenum_tpu_torch.shards import ShardDescriptor

    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    home, txid = _begin(fab, xsw, dep, b"xwe", start=10)
    assert xsw.step(txid) == "prepared"
    assert xsw.step(txid) == "locked"
    fab.mapping.reshard([ShardDescriptor.from_dict(d.to_dict())
                         for d in fab.mapping.descriptors])
    assert xsw.step(txid) == "aborted"
    assert xsw.txs[txid].abort_reason == "epoch_changed"
    assert not _nym_applied(fab, 0, home.identifier)
    assert not _attrib_applied(fab, 1, dep.identifier)
    assert xsw.participant(1).locks == {}        # lock released
    recs = xsw._scan_records(0)
    assert recs[txid]["decision"]["decision"] == "abort"


def test_cross_write_aborts_on_remote_partition():
    """The remote shard cannot order the lock (its primary is cut off):
    the prepare times out and the coordinator aborts — fail closed,
    never an indefinite wait, never a half-commit."""
    from plenum_tpu_torch.network import Discard, match_dst, match_frm

    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    xsw._anchor(1)                 # anchor DID ordered BEFORE the fault
    rshard = fab.shards[1]
    primary = rshard.nodes[rshard.names[0]].master_replica.data.primary_name
    rshard.net.add_rule(Discard(), match_dst(primary))
    rshard.net.add_rule(Discard(), match_frm(primary))
    home, txid = _begin(fab, xsw, dep, b"xwp", start=20)
    assert xsw.step(txid) == "prepared"
    state = xsw.step(txid)
    assert state == "aborted", xsw.txs[txid].abort_reason
    assert not _nym_applied(fab, 0, home.identifier)
    assert not _attrib_applied(fab, 1, dep.identifier)


def test_cross_write_refuses_forged_witness():
    """A witness whose envelope does not verify against the
    participant's OWN trust roots is refused at prepare."""
    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    home, txid = _begin(fab, xsw, dep, b"xwf", start=30)
    assert xsw.step(txid) == "prepared"
    tx = xsw.txs[txid]
    forged = json.loads(json.dumps(tx.witness))
    forged["result"]["data"]["verkey"] = "FORGED"
    ok, why = xsw.participant(1).handle_prepare(txid, tx.intent, forged)
    assert not ok and why.startswith("bad_witness")
    assert xsw.participant(1).locks == {}


def test_cross_write_coordinator_crash_recovers_abort():
    """Crash between lock and commit: the participant's lock TTL
    expires and resolves via a verified read of the decision record (a
    proven ABSENCE -> abort); ledger recovery orders the abort decision.
    Neither half applies."""
    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    home, txid = _begin(fab, xsw, dep, b"xwc", start=40)
    assert xsw.step(txid) == "prepared"
    assert xsw.step(txid) == "locked"
    # ...coordinator crashes here: no further steps. Time passes.
    fab.run(25.0)                  # past XSW_PREPARE_TTL
    rec = xsw.recover_from_ledger(0)
    assert txid in rec["aborted"]
    xsw.participant(1).service()   # lock TTL expired: resolve + abort
    assert xsw.participant(1).locks == {}
    assert xsw.participant(1).stats["resolved_aborts"] == 1
    assert not _nym_applied(fab, 0, home.identifier)
    assert not _attrib_applied(fab, 1, dep.identifier)


def test_cross_write_crash_after_decision_completes():
    """Crash AFTER the commit decision ordered but before the home
    write / remote notify: recovery replays the home write from the
    durable intent, and the participant resolves its lock to a PROVEN
    commit and applies — atomicity holds through the crash."""
    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    home, txid = _begin(fab, xsw, dep, b"xwd", start=50)
    assert xsw.step(txid) == "prepared"
    assert xsw.step(txid) == "locked"
    # the decision orders; the crash lands before anything else
    xsw._order_record(0, txid, "decision", {"decision": "commit"})
    rec = xsw.recover_from_ledger(0)
    assert txid in rec["completed"]
    assert _nym_applied(fab, 0, home.identifier)
    fab.run(25.0)                  # past the lock TTL
    xsw.participant(1).service()
    assert xsw.participant(1).locks == {}
    assert _attrib_applied(fab, 1, dep.identifier)


def test_cross_write_conflicting_lock_refused():
    """Two transactions against the same remote dependency: the second
    prepare is refused while the first holds the lock, and admitted
    after it releases."""
    fab, dep = _fab_with_dep()
    xsw = fab.cross_writes()
    h1, tx1 = _begin(fab, xsw, dep, b"xwl1", start=60)
    assert xsw.step(tx1) == "prepared"
    assert xsw.step(tx1) == "locked"
    h2, tx2 = _begin(fab, xsw, dep, b"xwl2", start=70)
    assert xsw.step(tx2) == "prepared"
    assert xsw.step(tx2) == "aborted"
    assert xsw.txs[tx2].abort_reason == "prepare_refused:locked"
    assert xsw.step(tx1) == "committed"          # the holder commits
    assert _nym_applied(fab, 0, h1.identifier)
    assert not _nym_applied(fab, 0, h2.identifier)
