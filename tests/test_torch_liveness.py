"""The port's copy of tests/test_liveness.py, run on plenum_tpu_torch.

Liveness tests: the pool recovers from dead, stalled, and malicious
primaries WITHOUT any manual vote injection.

Mirrors the reference's primary-disconnect / freshness / suspicion scenarios
(plenum/server/consensus/monitoring/, ordering_service.py:1991,
node.py:2854-2944) over SimNetwork fault injection.
"""
import pytest

from plenum_tpu_torch.common.internal_messages import RaisedSuspicion
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, Propagate
from plenum_tpu_torch.common.suspicion_codes import Suspicions
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network import Discard, match_dst, match_frm

from test_torch_pool import Pool, signed_nym

FAST = dict(Max3PCBatchWait=0.05, crypto_backend="cpu",
            PRIMARY_HEALTH_CHECK_FREQ=0.5,
            ORDERING_PROGRESS_TIMEOUT=2.0,
            STATE_FRESHNESS_UPDATE_INTERVAL=3.0)


def fast_pool(seed=13, **overrides):
    return Pool(seed=seed, config=Config(**{**FAST, **overrides}))


def cut_off(pool, name):
    return [pool.net.add_rule(Discard(), match_dst(name)),
            pool.net.add_rule(Discard(), match_frm(name))]


def healthy(pool, victim):
    return [n for n in pool.names if n != victim]


def test_dead_primary_triggers_view_change():
    """Cut off the view-0 primary with client traffic pending: the ordering-
    progress watchdog votes, f+1 InstanceChanges start a view change, and the
    pool orders under the new primary — no manual vote injection."""
    pool = fast_pool(seed=13)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    assert primary == "Alpha"
    cut_off(pool, primary)

    user = Ed25519Signer(seed=b"dead-primary-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=healthy(pool, primary))
    pool.run(20.0)

    for n in healthy(pool, primary):
        node = pool.nodes[n]
        assert node.master_replica.view_no >= 1, \
            f"{n} never left view 0"
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, \
            f"{n} did not order the pending request after the view change"
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in healthy(pool, primary)}
    assert len(roots) == 1


def test_quiescent_dead_primary_detected_via_freshness():
    """No client traffic at all: freshness silence alone must out the dead
    primary (ref STATE_SIGS_ARE_NOT_UPDATED / freshness batches)."""
    pool = fast_pool(seed=17)
    cut_off(pool, "Alpha")
    pool.run(15.0)
    for n in healthy(pool, "Alpha"):
        assert pool.nodes[n].master_replica.view_no >= 1, \
            f"{n} never detected the silent dead primary"

    # and the pool still works
    user = Ed25519Signer(seed=b"quiescent-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=healthy(pool, "Alpha"))
    pool.run(8.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in healthy(pool, "Alpha")}
    assert sizes == {2}


def test_primary_disconnect_votes_within_disconnect_timeout():
    """CONNECTION LOSS to the primary triggers the view-change vote within
    PRIMARY_DISCONNECT_TIMEOUT — seconds — without waiting out the (here
    deliberately enormous) ordering-stall and freshness windows (ref
    primary_connection_monitor_service.py + ToleratePrimaryDisconnection)."""
    pool = fast_pool(seed=19,
                     PRIMARY_DISCONNECT_TIMEOUT=2.0,
                     ORDERING_PROGRESS_TIMEOUT=300.0,
                     STATE_FRESHNESS_UPDATE_INTERVAL=300.0)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    assert primary == "Alpha"
    # crash_node drops the peer from the fabric -> Disconnected events on
    # every survivor (cut_off would only drop messages, not the connection)
    pool.crash_node(primary)

    user = Ed25519Signer(seed=b"disc-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=healthy(pool, primary))
    pool.run(10.0)      # << 300s: only the disconnect path can have fired

    for n in healthy(pool, primary):
        node = pool.nodes[n]
        assert node.master_replica.view_no >= 1, \
            f"{n} never voted on primary disconnect"
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, \
            f"{n} did not order after the fast view change"


def test_wedged_backup_instance_removed_then_restored():
    """A backup instance whose primary stops ordering is detected (queued
    work, no 3PC progress), voted out by an f+1 BackupInstanceFaulty
    quorum on every node, and re-created fresh by the next view change
    (ref backup_instance_faulty_processor.py + node.py:2580-2596)."""
    pool = fast_pool(seed=23,
                     BACKUP_INSTANCE_FAULTY_CHECK_FREQ=0.5,
                     BACKUP_INSTANCE_FAULTY_TIMEOUT=2.0)
    # wedge instance 1 pool-wide by muting its primary's ordering service
    backup_primary = None
    for node in pool.nodes.values():
        r1 = node.replicas[1]
        if r1.is_primary:
            backup_primary = node.name
            r1.ordering.service = lambda: None
    assert backup_primary is not None

    user = Ed25519Signer(seed=b"wedge-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(10.0)

    for name, node in pool.nodes.items():
        assert 1 not in node.replicas, \
            f"{name} never removed the wedged backup instance"
        assert ("backup_instance_removed", 1) in node.spylog
        # master kept ordering throughout
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2

    # a view change (here: master primary goes quiet with work pending)
    # re-creates the removed backup fresh
    cut_off(pool, "Alpha")
    user2 = Ed25519Signer(seed=b"wedge-user-2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user2, req_id=2),
                to=healthy(pool, "Alpha"))
    pool.run(20.0)
    for n in healthy(pool, "Alpha"):
        node = pool.nodes[n]
        assert node.master_replica.view_no >= 1
        assert 1 in node.replicas, f"{n} did not restore the backup"
        assert node.replicas[1].view_no == node.master_replica.view_no


def test_malicious_primary_wrong_state_root():
    """The primary lies about the state root: validators' re-apply catches it
    (PPR_STATE_WRONG), the suspicion becomes a view-change vote, and the pool
    re-orders the batch honestly under the next primary."""
    pool = fast_pool(seed=19)
    alpha = pool.nodes["Alpha"]
    orig_apply = alpha.master_replica.ordering._apply

    def corrupt(ledger_id, reqs, pp_time, view_no, pp_seq_no):
        applied = orig_apply(ledger_id, reqs, pp_time, view_no, pp_seq_no)
        return applied._replace(state_root="00" * 32)

    alpha.master_replica.ordering._apply = corrupt

    user = Ed25519Signer(seed=b"malicious-primary".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(20.0)

    suspicions = [e for n in pool.names for e in pool.nodes[n].spylog
                  if e[0] == "suspicion"
                  and e[1][0] == Suspicions.PPR_STATE_WRONG.code]
    assert suspicions, "no validator caught the wrong state root"
    for n in pool.names:
        node = pool.nodes[n]
        assert node.master_replica.view_no >= 1, f"{n} never left view 0"
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, \
            f"{n} did not order the request after the view change"
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1, "pool diverged after malicious primary"


def test_freshness_batches_keep_signatures_fresh():
    """An idle pool still orders empty freshness batches on state-bearing
    ledgers so BLS state signatures stay fresh (ref :1991)."""
    pool = fast_pool(seed=23)
    pool.run(10.0)
    for n in pool.names:
        node = pool.nodes[n]
        assert node.master_replica.last_ordered_3pc[1] >= 2, \
            f"{n} ordered no freshness batches while idle"
        # freshness batches are empty: no ledger growth
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1
    # the pool is still perfectly writable afterwards
    user = Ed25519Signer(seed=b"fresh-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}


def test_suspicion_routing_blacklist_and_primary_fault():
    """Unit probe of the suspicion router: peer misbehavior blacklists (and
    ingress drops the peer's traffic); primary-authored faults become votes."""
    pool = fast_pool(seed=29)
    beta = pool.nodes["Beta"]

    # unambiguous peer misbehavior -> blacklist + ingress drop
    beta._on_suspicion(RaisedSuspicion(
        inst_id=0, code=Suspicions.PPR_FRM_NON_PRIMARY.code,
        reason="pre-prepare from non-primary", sender="Gamma"))
    assert beta.blacklister.is_blacklisted("Gamma")
    before = len(beta._propagate_inbox)
    beta.node_bus.process_incoming(
        Propagate(request={"x": 1}, sender_client=None), "Gamma")
    assert len(beta._propagate_inbox) == before, \
        "blacklisted peer's traffic reached the node"

    # primary-authored fault -> view-change vote recorded, no blacklist
    primary = beta.master_replica.data.primary_name
    beta._on_suspicion(RaisedSuspicion(
        inst_id=0, code=Suspicions.PPR_STATE_WRONG.code,
        reason="root mismatch", sender=primary))
    assert not beta.blacklister.is_blacklisted(primary)
    votes = beta.master_replica.vc_trigger._votes
    assert any("Beta" in voters for voters in votes.values()), \
        f"no vote recorded: {votes}"


def test_degraded_master_voted_out_by_monitor():
    """The RBFT monitor compares master vs backup instance throughput: stall
    the master instance's 3PC traffic while backups keep ordering, and the
    DELTA ratio check must vote the master out (ref monitor.py:425-492)."""
    from plenum_tpu_torch.common.node_messages import Commit, PrePrepare, Prepare
    # The watchdog timeout is long enough that the MONITOR fires first (its
    # EMA warms up in ~5s) but still live: after the view change the new
    # primary's first batch may be lost to the still-active stall rule, and
    # recovering THAT is the ordering-progress watchdog's job.
    pool = fast_pool(seed=37,
                     ORDERING_PROGRESS_TIMEOUT=8.0,
                     STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
                     PerfCheckFreq=1.0,
                     throughput_first_ts_window=2.0)
    rule = pool.net.add_rule(
        Discard(),
        lambda m, f, d: isinstance(m, (PrePrepare, Prepare, Commit))
        and getattr(m, "inst_id", None) == 0)

    for i in range(12):
        user = Ed25519Signer(seed=f"deg{i}".encode().ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, user, req_id=i + 1))
        pool.run(0.5)
    pool.run(8.0)

    degraded = [n for n in pool.names
                if any(e[0] == "master_degraded" for e in pool.nodes[n].spylog)]
    assert degraded, "no node's monitor flagged the degraded master"
    for n in pool.names:
        assert pool.nodes[n].master_replica.view_no >= 1, \
            f"{n}: degraded master never voted out"

    # with the stall lifted the pool orders the backlog (possibly one more
    # watchdog-driven view change later, if the new primary's first batch
    # was sent while the stall rule still held)
    pool.net.remove_rule(rule)
    pool.run(25.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {13}, sizes


def test_own_node_never_blacklisted():
    pool = fast_pool(seed=31)
    beta = pool.nodes["Beta"]
    beta._on_suspicion(RaisedSuspicion(
        inst_id=0, code=Suspicions.PPR_FRM_NON_PRIMARY.code,
        reason="", sender="Beta"))
    assert not beta.blacklister.is_blacklisted("Beta")


def test_equivocating_primary_detected():
    """A primary sending TWO different PRE-PREPAREs for the same (view,
    seq) is detected (DUPLICATE_PPR_SENT): honest nodes keep the first,
    suspect the primary, and the pool's ledgers never diverge."""
    from plenum_tpu_torch.common.node_messages import PrePrepare

    pool = fast_pool(seed=23)
    user = Ed25519Signer(seed=b"equivocate".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    # advance just past the batch cut so the PP is IN FLIGHT, not ordered
    # (a duplicate of an already-ordered seq is discarded as stale, which
    # is correct but not what this test is about)
    for _ in range(4):
        pool.run(0.06)
        if pool.nodes["Beta"].master_replica.ordering.prePrepares:
            break

    beta = pool.nodes["Beta"]
    honest = beta.master_replica.ordering.prePrepares
    assert honest, "no pre-prepare in flight yet"
    (view_no, pp_seq_no), pp = next(iter(honest.items()))
    twin = PrePrepare(**{**{f: getattr(pp, f) for f in pp.__dataclass_fields__},
                         "digest": "ff" * 16})
    for victim in ("Beta", "Gamma"):
        pool.nodes[victim].master_replica.ordering.process_preprepare(
            twin, "Alpha")
    pool.run(5.0)

    suspicions = [e for n in ("Beta", "Gamma")
                  for e in pool.nodes[n].spylog
                  if e[0] == "suspicion"
                  and e[1][0] == Suspicions.DUPLICATE_PPR_SENT.code]
    assert suspicions, "equivocation not suspected"
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}
    roots = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.names}
    assert len(roots) == 1, "pool diverged under equivocation"


def test_lost_quorum_connectivity_resyncs_on_reconnect():
    """A node that HAD consensus connectivity and then drops below the
    weak quorum (ref inconsistency_watchers.py:5 fires a restart there)
    marks itself inconsistent and catches up as soon as enough peers are
    back — and the pool orders again afterwards."""
    pool = Pool(seed=31)
    user = Ed25519Signer(seed=b"nw-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(5.0)
    for n in pool.nodes.values():
        assert n.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2

    # 4-node pool, f=1: weak quorum is 2 connected peers. Crashing Beta
    # and Gamma leaves Alpha/Delta with ONE peer each -> watcher fires.
    pool.crash_node("Beta")
    pool.crash_node("Gamma")
    pool.run(1.0)
    for n in ("Alpha", "Delta"):
        events = [e for e, _ in pool.nodes[n].spylog]
        assert "lost_quorum_connectivity" in events, n
        assert pool.nodes[n]._needs_resync, n

    # peers return (fresh from genesis, as after a restart): the survivors
    # must resync via catchup, not keep trusting their own liveness view
    pool.start_node("Beta")
    pool.start_node("Gamma")
    pool.net.connect_all()
    # a restarting node catches up at boot (what tools/start_node does);
    # the point under test is that the SURVIVORS resync too
    pool.nodes["Beta"].start_catchup()
    pool.nodes["Gamma"].start_catchup()
    pool.run(10.0)
    for n in ("Alpha", "Delta"):
        events = [e for e, _ in pool.nodes[n].spylog]
        assert "resync_after_partition" in events, n
        assert not pool.nodes[n]._needs_resync, n

    # liveness proof: the healed pool orders a new request everywhere
    user2 = Ed25519Signer(seed=b"nw-user2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user2, req_id=2))
    pool.run(10.0)
    for name, node in pool.nodes.items():
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 3, name


def test_vc_stall_phases_are_recorded():
    """The view-change stall decomposition stamps
    detect -> vote -> start -> new_view -> order and emits phase metrics;
    the detect->vote wait must track PRIMARY_DISCONNECT_TIMEOUT."""
    pool = fast_pool(seed=23,
                     PRIMARY_DISCONNECT_TIMEOUT=2.0,
                     ORDERING_PROGRESS_TIMEOUT=300.0,
                     STATE_FRESHNESS_UPDATE_INTERVAL=300.0)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    pool.crash_node(primary)
    user = Ed25519Signer(seed=b"vcphase".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=healthy(pool, primary))
    pool.run(15.0)
    n = pool.nodes[healthy(pool, primary)[0]]
    phases = [p for e, p in n.spylog if e == "vc_stall_phases"]
    assert phases, "no completed stall episode recorded"
    ts = phases[0]
    assert set(ts) >= {"detect", "vote", "start", "new_view", "order"}, ts
    assert ts["detect"] <= ts["vote"] <= ts["start"] \
        <= ts["new_view"] <= ts["order"]
    # detection wait ~= the configured tolerance (MockTimer steps 0.1s)
    assert 1.9 <= ts["vote"] - ts["detect"] <= 2.7, ts


def test_straggler_recheck_avoids_spurious_catchup():
    """An ordinary view change must NOT trigger the straggler catchup:
    ViewChange/NewView chatter for my+1 is excluded from evidence, and
    the deferred callback re-verifies the lag at fire time."""
    pool = fast_pool(seed=41)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    cut_off(pool, primary)
    user = Ed25519Signer(seed=b"recheck".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1),
                to=healthy(pool, primary))
    pool.run(20.0)
    for n in healthy(pool, primary):
        node = pool.nodes[n]
        assert node.master_replica.view_no >= 1
        # the single-step view change produced no straggler resync
        assert not [e for e in node.spylog if e[0] == "straggler_resync"], n
        assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2, n


def test_stuck_behind_resync_rejoins_mid_view():
    """A node isolated while the pool orders PAST it (same view, below
    CHK_FREQ) must detect the commit quorum ahead of its stagnant
    position and resync without any view change."""
    pool = fast_pool(seed=43,
                     STUCK_BEHIND_CHECK_FREQ=1.0,
                     ORDERING_PROGRESS_TIMEOUT=300.0,
                     STATE_FRESHNESS_UPDATE_INTERVAL=300.0,
                     PRIMARY_DISCONNECT_TIMEOUT=300.0)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    assert primary == "Alpha"
    victim = "Delta"
    rules = cut_off(pool, victim)
    users = [Ed25519Signer(seed=(b"sb%d" % i).ljust(32, b"\0"))
             for i in range(3)]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, req_id=i + 1),
                    to=healthy(pool, victim))
        pool.run(2.0)
    # pool ordered 3 txns without the victim
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 4
    assert pool.nodes[victim].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1
    for r in rules:
        pool.net.remove_rule(r)
    # heal: new traffic flows; the victim sees commits ahead of its
    # stagnant position and resyncs WITHOUT a view change
    u4 = Ed25519Signer(seed=b"sb-late".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u4, req_id=9))
    pool.run(15.0)
    node = pool.nodes[victim]
    assert [e for e in node.spylog if e[0] == "stuck_behind_resync"], \
        "victim never detected the quorum ahead of it"
    assert node.master_replica.view_no == 0      # no view change happened
    assert node.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 5
