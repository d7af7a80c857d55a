"""The port's copy of tests/test_restart.py, run on plenum_tpu_torch (nodes
on the CPU).

Full-node crash-restart: durable storage, audit-ledger 3PC restore,
rejoin via catchup.

Reference behavior under test: node restart recovery — ledgers/states
reopen from disk (ledger.py:70-113), the node resumes at the audit ledger's
3PC position and primaries (node.py:1830,1875), and a node that missed
traffic while down catches up and keeps ordering (SURVEY.md §5
checkpoint/resume).
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import AUDIT_LEDGER_ID, DOMAIN_LEDGER_ID
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer

from test_torch_pool import Pool, signed_nym


def _file_pool(tmp_path, **kw):
    return Pool(config=Config(Max3PCBatchWait=0.05, kv_backend="native"),
                data_dir=str(tmp_path), **kw)


def _user(tag: bytes) -> Ed25519Signer:
    return Ed25519Signer(seed=tag.ljust(32, b"\0"))


def test_single_node_crash_restart_rejoins_and_orders(tmp_path):
    pool = _file_pool(tmp_path)
    victim = "Delta"          # not the master primary (Alpha)

    pool.submit(signed_nym(pool.trustee, _user(b"rs-u1"), 1))
    pool.run(5.0)
    assert pool.nodes[victim].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2

    # hard-stop mid-stream: no clean shutdown, then the pool moves on
    pool.crash_node(victim)
    pool.submit(signed_nym(pool.trustee, _user(b"rs-u2"), 2),
                to=[n for n in pool.names if n != victim])
    pool.run(5.0)
    survivors = [n for n in pool.names if n != victim]
    assert all(pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 3
               for n in survivors)

    # restart from disk: committed state is back without any traffic
    node = pool.start_node(victim)
    pool.net.connect_all()
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    assert ledger.size == 2               # durable recovery of what it saw
    # audit restore: resumed at its pre-crash 3PC position, not (0, 0)
    assert node.master_replica.last_ordered_3pc[1] >= 1
    assert ("restored_from_audit", node.master_replica.last_ordered_3pc) \
        in list(node.spylog)

    # it catches up the missed txn...
    node.start_catchup()
    pool.run(10.0)
    assert ledger.size == 3
    assert ledger.root_hash == pool.nodes["Alpha"].c.db.get_ledger(
        DOMAIN_LEDGER_ID).root_hash

    # ...and participates in ordering NEW traffic
    pool.submit(signed_nym(pool.trustee, _user(b"rs-u3"), 3))
    pool.run(5.0)
    assert ledger.size == 4
    assert all(pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 4
               for n in pool.names)


def test_whole_pool_restart_resumes_without_catchup(tmp_path):
    pool = _file_pool(tmp_path)
    pool.submit(signed_nym(pool.trustee, _user(b"wp-u1"), 1))
    pool.run(5.0)
    last_3pc = pool.nodes["Alpha"].master_replica.last_ordered_3pc
    assert last_3pc[1] >= 1
    root = pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash

    # power failure: every node hard-stops
    for name in list(pool.names):
        pool.crash_node(name)
    for name in pool.names:
        pool.start_node(name)
    pool.net.connect_all()

    for name in pool.names:
        node = pool.nodes[name]
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash == root
        assert node.master_replica.last_ordered_3pc == last_3pc
        audit = node.c.db.get_ledger(AUDIT_LEDGER_ID)
        assert audit.size >= 1

    # the pool keeps ordering from where it left off — no catchup needed
    pool.submit(signed_nym(pool.trustee, _user(b"wp-u2"), 2))
    pool.run(5.0)
    for name in pool.names:
        ledger = pool.nodes[name].c.db.get_ledger(DOMAIN_LEDGER_ID)
        assert ledger.size == 3
        assert pool.nodes[name].master_replica.last_ordered_3pc[1] == \
            last_3pc[1] + 1


def test_restart_discards_uncommitted_tail(tmp_path):
    from plenum_tpu_torch.storage.kv_native import native_available
    if not native_available():
        pytest.skip("native kvstore engine unavailable")
    """A torn write in the ledger log must not poison recovery: the native
    KV engine drops the torn tail (CRC + truncation) and the node restarts
    from the last durable record."""
    import os

    pool = _file_pool(tmp_path)
    pool.submit(signed_nym(pool.trustee, _user(b"tt-u1"), 1))
    pool.run(5.0)
    victim = "Delta"
    size_before = pool.nodes[victim].c.db.get_ledger(DOMAIN_LEDGER_ID).size
    pool.crash_node(victim)

    # tear the tail of the domain ledger log (crash mid-write)
    log = os.path.join(str(tmp_path), victim, "domain_log", "kv.kvn")
    file_size = os.path.getsize(log)
    os.truncate(log, file_size - 3)

    node = pool.start_node(victim)
    pool.net.connect_all()
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    assert ledger.size == size_before - 1     # torn record dropped
    node.start_catchup()
    pool.run(10.0)
    assert ledger.size == size_before         # catchup refills it
    assert ledger.root_hash == pool.nodes["Alpha"].c.db.get_ledger(
        DOMAIN_LEDGER_ID).root_hash


def test_instance_change_votes_survive_restart(tmp_path):
    """A node crash during a marginal f+1 InstanceChange accumulation must
    not reset the count: persisted votes + fresh votes still complete the
    view change (ref instance_change_provider.py:34-69).

    Strictness: Gamma is down for good, so exactly n-f=3 nodes remain and
    ALL of them must join the view change for it to complete. Delta hears
    Alpha's vote, restarts, then hears Beta's — without persistence Delta
    would hold 1 vote < f+1 and the pool would stay in view 0 forever.
    """
    from plenum_tpu_torch.common.internal_messages import VoteForViewChange
    from plenum_tpu_torch.common.suspicion_codes import Suspicions

    pool = _file_pool(tmp_path)
    pool.crash_node("Gamma")

    # Alpha votes; the InstanceChange broadcast reaches Beta and Delta
    pool.nodes["Alpha"].master_replica.internal_bus.send(
        VoteForViewChange(suspicion_code=Suspicions.PRIMARY_DEGRADED.code))
    pool.run(2.0)
    assert all(pool.nodes[n].master_replica.view_no == 0
               for n in pool.nodes)          # 1 vote < f+1: nothing starts

    pool.crash_node("Delta")
    node = pool.start_node("Delta")
    pool.net.connect_all()

    # Beta's fresh vote is the second: every live node reaches f+1 only if
    # Delta still counts Alpha's persisted vote
    pool.nodes["Beta"].master_replica.internal_bus.send(
        VoteForViewChange(suspicion_code=Suspicions.PRIMARY_DEGRADED.code))
    pool.run(15.0)
    for name in ("Alpha", "Beta", "Delta"):
        assert pool.nodes[name].master_replica.view_no == 1, name
        # the view change COMPLETED (NewView accepted), not merely started —
        # a restarted node claiming an off-boundary stable checkpoint used
        # to deadlock NewViewBuilder.calc_checkpoint here
        assert not pool.nodes[name].master_replica.data.waiting_for_new_view

    # and the pool keeps ordering under the new primary
    pool.submit(signed_nym(pool.trustee, _user(b"ic-u2"), 2),
                to=list(pool.nodes))
    pool.run(10.0)
    for name in ("Alpha", "Beta", "Delta"):
        assert pool.nodes[name].c.db.get_ledger(
            DOMAIN_LEDGER_ID).size == 2, name


def test_instance_change_votes_expire_at_load(tmp_path):
    """TTL-on-load: a persisted vote older than INSTANCE_CHANGE_TIMEOUT in
    wall-clock terms is dropped when the node restarts, so stale grievances
    can't combine across epochs (ref instance_change_provider TTL)."""
    from plenum_tpu_torch.common.node_messages import InstanceChange
    from plenum_tpu_torch.consensus.view_change_trigger_service import \
        InstanceChangeVoteStore
    from plenum_tpu_torch.execution.database_manager import NODE_STATUS_DB_LABEL

    pool = _file_pool(tmp_path)
    node = pool.nodes["Delta"]
    node.master_replica.vc_trigger.process_instance_change(
        InstanceChange(view_no=1, reason=0), "Alpha")

    # age the persisted vote past the TTL by rewriting its wall stamp
    kv = node.c.db.get_store(NODE_STATUS_DB_LABEL)
    store = InstanceChangeVoteStore(kv)
    import time as _time
    old = _time.time() - pool.config.INSTANCE_CHANGE_TIMEOUT - 10
    store.save_view(1, {"Alpha": old})

    pool.crash_node("Delta")
    node = pool.start_node("Delta")
    trigger = node.master_replica.vc_trigger
    assert trigger._votes.get(1, {}) == {}    # expired vote not reloaded
    assert store.load(pool.config.INSTANCE_CHANGE_TIMEOUT) == {}  # and purged


def test_backup_primary_resumes_last_sent_pp(tmp_path):
    """A restarting BACKUP primary resumes its 3PC numbering from the
    persisted last-sent PRE-PREPARE instead of re-issuing pp_seq_no 1
    (ref last_sent_pp_store_helper.py). The master restores from the audit
    ledger; backups have no audit trail — only this store."""
    pool = _file_pool(tmp_path)
    # view 0 primaries: inst 0 = Alpha (master), inst 1 = Beta
    beta = pool.nodes["Beta"]
    assert beta.replicas[1].data.is_primary

    for i in range(3):
        pool.submit(signed_nym(pool.trustee, _user(b"bp-u%d" % i), i + 1))
        pool.run(2.0)
    sent_before = beta.replicas[1].data.pp_seq_no
    assert sent_before >= 1          # the backup primary really sent PPs

    pool.crash_node("Beta")
    beta = pool.start_node("Beta")
    pool.net.connect_all()
    # restored, not reset: the next PP it sends will be sent_before + 1
    assert beta.replicas[1].data.pp_seq_no == sent_before
    assert ("restored_backup_pp", (1, sent_before)) in list(beta.spylog)

    # new traffic: the backup keeps ordering with fresh seq-nos on every
    # node's shadow instance — a duplicate/gap would stall inst 1
    pool.submit(signed_nym(pool.trustee, _user(b"bp-u9"), 9))
    pool.run(8.0)
    for name in pool.names:
        inst1 = pool.nodes[name].replicas[1]
        assert inst1.data.last_ordered_3pc[1] >= sent_before + 1, \
            (name, inst1.data.last_ordered_3pc, sent_before)


def test_restart_with_chunked_store(tmp_path):
    """Crash-restart over the chunked append-log backend: the restarted
    node recovers its ledgers from sealed+tail chunks and rejoins."""
    pool = Pool(config=Config(Max3PCBatchWait=0.05, kv_backend="chunked"),
                data_dir=str(tmp_path))
    users = [Ed25519Signer(seed=(b"ck%d" % i).ljust(32, b"\0"))
             for i in range(6)]
    for i, u in enumerate(users[:4]):
        pool.submit(signed_nym(pool.trustee, u, req_id=i + 1))
    pool.run(8.0)
    assert pool.nodes["Beta"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 5
    pool.crash_node("Beta")
    pool.submit(signed_nym(pool.trustee, users[4], req_id=5),
                to=["Alpha", "Gamma", "Delta"])
    pool.run(5.0)
    node = pool.start_node("Beta")
    pool.net.connect_all()
    assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 5  # durable
    node.start_catchup()
    pool.run(10.0)
    assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 6
    pool.submit(signed_nym(pool.trustee, users[5], req_id=6))
    pool.run(8.0)
    sizes = {n: nd.c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n, nd in pool.nodes.items()}
    assert sizes == {n: 7 for n in pool.names}, sizes


@pytest.mark.parametrize("name", [
    "test_single_node_crash_restart_rejoins_and_orders",
    "test_whole_pool_restart_resumes_without_catchup",
    "test_restart_discards_uncommitted_tail",
    "test_instance_change_votes_survive_restart",
    "test_backup_primary_resumes_last_sent_pp",
    "test_restart_with_chunked_store",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_restart as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
