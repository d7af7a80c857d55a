"""The port's copy of tests/test_catchup.py, run on plenum_tpu_torch.

Catchup tests: a cut-off node syncs ledgers+state and rejoins consensus.

Mirrors the reference's node_catchup/ scenarios (SURVEY.md §3.4) using
SimNetwork Discard rules as the fault injection (delayers analog).
"""
import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, Reply
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network import Discard, match_dst, match_frm

from test_torch_pool import Pool, signed_nym


@pytest.fixture
def pool():
    return Pool(seed=7)


def cut_off(pool, name):
    r1 = pool.net.add_rule(Discard(), match_dst(name))
    r2 = pool.net.add_rule(Discard(), match_frm(name))
    return r1, r2


def test_lagging_node_catches_up(pool):
    victim = "Delta"
    rules = cut_off(pool, victim)

    users = [Ed25519Signer(seed=f"cu{i}".encode().ljust(32, b"\0"))
             for i in range(6)]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, req_id=i + 1),
                    to=[n for n in pool.names if n != victim])
    pool.run(8.0)

    healthy = [n for n in pool.names if n != victim]
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in healthy}
    assert sizes == {7}, sizes                   # genesis + 6
    assert pool.nodes[victim].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1

    for r in rules:
        pool.net.remove_rule(r)
    pool.nodes[victim].start_catchup()
    pool.run(10.0)

    v = pool.nodes[victim]
    ref = pool.nodes["Alpha"]
    assert v.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 7
    assert v.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash == \
        ref.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
    assert v.c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash == \
        ref.c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash
    assert v.c.db.get_ledger(3).size == ref.c.db.get_ledger(3).size
    assert v.master_replica.last_ordered_3pc == \
        ref.master_replica.last_ordered_3pc

    # the recovered node participates in new ordering
    u = Ed25519Signer(seed=b"after-catchup".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, req_id=50))
    pool.run(6.0)
    assert v.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 8
    assert v.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash == \
        ref.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash


def test_catchup_noop_when_current(pool):
    """A current node's catchup finishes via the equal-status quorum."""
    node = pool.nodes["Beta"]
    node.start_catchup()
    pool.run(3.0)
    assert not node.leecher.is_running
    assert ("catchup_complete", (0, 0)) in node.spylog


def test_seeder_serves_ranges(pool):
    """Direct seeder probe: a CatchupReq returns verifiable txns."""
    from plenum_tpu_torch.common.node_messages import CatchupReq, CatchupRep
    users = [Ed25519Signer(seed=f"sr{i}".encode().ljust(32, b"\0"))
             for i in range(3)]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, req_id=i + 1))
    pool.run(6.0)
    sent = []
    alpha = pool.nodes["Alpha"]
    alpha.seeder._send = lambda msg, dst: sent.append((msg, dst))
    alpha.seeder.process_catchup_req(
        CatchupReq(ledger_id=DOMAIN_LEDGER_ID, seq_no_start=1, seq_no_end=4,
                   catchup_till=4), "Beta")
    assert len(sent) == 1
    rep, dst = sent[0]
    assert isinstance(rep, CatchupRep) and dst == "Beta"
    assert sorted(int(k) for k in rep.txns) == [1, 2, 3, 4]
