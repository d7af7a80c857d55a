"""The port's copy of tests/test_aux.py, run on plenum_tpu_torch (nodes on
the CPU); the replayed root is also held to the reference's.

Aux subsystems: metrics collection, validator info, recorder/replay,
observer framework.

Reference test model: plenum/test/metrics, plenum/test/recorder,
plenum/test/observer (SURVEY.md §5 aux subsystems).
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.metrics import (KvMetricsCollector, MetricsCollector,
                                       MetricsName, NullMetricsCollector)
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.storage.kv_memory import KvMemory

from test_torch_pool import Pool, make_genesis, signed_nym


# --- metrics --------------------------------------------------------------

def test_metrics_accumulator_folds():
    m = MetricsCollector()
    for v in (3.0, 1.0, 2.0):
        m.add_event("x", v)
    m.add_event("y")
    s = m.summary()
    assert s["x"] == {"count": 3, "sum": 6.0, "avg": 2.0, "min": 1.0,
                      "max": 3.0}
    assert s["y"]["count"] == 1
    with m.measure_time("t"):
        pass
    assert m.summary()["t"]["count"] == 1


def test_kv_metrics_flush_and_read_back():
    store = KvMemory()
    clock = [1000.0]
    m = KvMetricsCollector(store, now=lambda: clock[0])
    m.add_event("a", 5.0)
    m.add_event("a", 7.0)
    m.flush()
    clock[0] = 1010.0
    m.add_event("a", 1.0)
    m.flush()
    rows = m.read_rows()
    assert [(ts, name, d["count"], d["sum"]) for ts, name, d in rows] == [
        (1000.0, "a", 2, 12.0), (1010.0, "a", 1, 1.0)]
    assert m.summary() == {}            # flushed clean


def test_null_collector_is_inert():
    m = NullMetricsCollector()
    m.add_event("x", 1.0)
    with m.measure_time("y"):
        pass
    assert m.summary() == {}


def test_pool_populates_metrics_and_validator_info():
    pool = Pool()
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    user = Ed25519Signer(seed=b"aux-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)
    node = pool.nodes[pool.names[0]]
    assert pool.replies(pool.names[0])
    s = node.metrics.summary()
    assert s[MetricsName.CLIENT_MSGS]["count"] >= 1
    assert s[MetricsName.ORDERED_BATCH_SIZE]["count"] >= 1
    assert s[MetricsName.EXECUTE_BATCH_TIME]["count"] >= 1

    info = node.validator_info()
    assert info["name"] == pool.names[0]
    assert sorted(info["validators"]) == sorted(pool.names)
    assert info["f"] == 1
    assert info["view_no"] == 0
    assert not info["catchup_in_progress"]
    assert info["last_ordered_3pc"][1] >= 1
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    dom = info["ledgers"][DOMAIN_LEDGER_ID]
    assert dom["size"] == 2 and dom["uncommitted"] == 0
    # info snapshots from every node agree on the ordered state
    other = pool.nodes[pool.names[-1]].validator_info()
    assert other["ledgers"][DOMAIN_LEDGER_ID]["root"] == dom["root"]


# --- recorder / replay ----------------------------------------------------

def test_record_and_replay_reproduces_state():
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node import Node, NodeBootstrap
    from plenum_tpu_torch.node.recorder import Recorder, attach_recorder, replay

    pool = Pool()
    target = pool.names[0]
    store = KvMemory()
    recorder = Recorder(store, now=pool.timer.get_current_time)
    attach_recorder(pool.nodes[target], recorder)

    user = Ed25519Signer(seed=b"rec-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)
    user2 = Ed25519Signer(seed=b"rec-user2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user2, 2))
    pool.run(5.0)
    live = pool.nodes[target]
    live_root = live.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
    assert live.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 3

    # fresh node, same genesis, fed ONLY the recorded stream
    genesis, _ = make_genesis(pool.names)
    timer = MockTimer()
    components = NodeBootstrap(target, genesis_txns=genesis,
                               crypto_backend="cpu").build()
    from plenum_tpu_torch.common.event_bus import ExternalBus
    bus = ExternalBus(send_handler=lambda msg, dst: None)   # sends -> sink
    node = Node(target, timer, bus, components, config=pool.config)
    n = replay(recorder.iter_records(), node, timer)
    assert n > 0
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    assert ledger.size == 3
    assert ledger.root_hash == live_root
    # the reference's pool, fed the same two writes, reaches that root
    from plenum_tpu.common.node_messages import DOMAIN_LEDGER_ID as REF_DOMAIN
    from plenum_tpu.crypto.ed25519 import Ed25519Signer as RefSigner
    from test_pool import Pool as RefPool, signed_nym as ref_signed_nym
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        ref = RefPool()
        for k, seed in ((1, b"rec-user"), (2, b"rec-user2")):
            ref.submit(ref_signed_nym(
                ref.trustee, RefSigner(seed=seed.ljust(32, b"\0")), k))
            ref.run(5.0)
    assert ref.nodes[target].c.db.get_ledger(REF_DOMAIN).root_hash == live_root


# --- observer -------------------------------------------------------------

def _observer_components(names):
    from plenum_tpu_torch.node import NodeBootstrap
    genesis, _ = make_genesis(names)
    return NodeBootstrap("Observer", genesis_txns=genesis,
                         crypto_backend="cpu").build()


def test_observer_follows_committed_batches():
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 BatchCommitted)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node.observer import NodeObserver

    pool = Pool()
    target = pool.names[0]
    node = pool.nodes[target]
    node.observable.add_observer("obs-client-1")
    assert node.observable.observer_ids == ["obs-client-1"]

    user = Ed25519Signer(seed=b"obs-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)

    pushes = [m for m, client in pool.client_msgs[target]
              if isinstance(m, BatchCommitted) and client == "obs-client-1"]
    assert pushes, "no BatchCommitted pushed to the registered observer"

    observer = NodeObserver(_observer_components(pool.names))
    for batch in pushes:
        assert observer.process_batch(batch)
        assert not observer.process_batch(batch)     # idempotent
    ledger = observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
    live = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    assert ledger.size == live.size == 2
    assert ledger.root_hash == live.root_hash


def test_observer_refuses_tampered_batch():
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 BatchCommitted)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node.observer import NodeObserver

    pool = Pool()
    target = pool.names[0]
    node = pool.nodes[target]
    node.observable.add_observer("obs")
    user = Ed25519Signer(seed=b"obs-user-2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)
    batch = next(m for m, c in pool.client_msgs[target]
                 if isinstance(m, BatchCommitted))

    observer = NodeObserver(_observer_components(pool.names))
    import dataclasses
    bad = dataclasses.replace(batch, txn_root="00" * 32)
    assert not observer.process_batch(bad)
    # refusal reverted cleanly: the honest batch still applies
    assert observer.process_batch(batch)
    assert observer.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2


def test_observer_f_plus_1_data_quorum():
    """With f=1 an observer needs 2 content-identical pushes from DISTINCT
    validators before applying (ref quorums.py:38 observer_data): a lone
    Byzantine validator's fabricated-but-self-consistent batch is buffered
    forever, and its re-push replaces (not adds to) its earlier vote."""
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 BatchCommitted)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node.observer import NodeObserver

    pool = Pool()
    node = pool.nodes["Alpha"]
    node.observable.add_observer("obs")
    user = Ed25519Signer(seed=b"quorum-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)
    batch = next(m for m, c in pool.client_msgs["Alpha"]
                 if isinstance(m, BatchCommitted))

    import dataclasses
    # a SELF-CONSISTENT fabrication: drop the user NYM request entirely and
    # recompute nothing — roots won't match, but even a root-consistent
    # fake only ever gets the Byzantine node's single vote
    fake = dataclasses.replace(batch, requests=batch.requests[:0])

    observer = NodeObserver(_observer_components(pool.names), f=1)
    ledger = observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
    base = ledger.size
    # Byzantine node pushes its fake — no quorum, nothing applied
    assert not observer.process_batch(fake, frm="Byz")
    assert not observer.process_batch(fake, frm="Byz")   # re-push: 1 vote
    assert ledger.size == base
    # one honest push: still below f+1
    assert not observer.process_batch(batch, frm="Beta")
    assert ledger.size == base
    # second honest push with IDENTICAL content -> quorum -> applied
    assert observer.process_batch(batch, frm="Gamma")
    assert ledger.size == base + 1
    # quorum state for the settled range was purged
    assert not observer._votes
    # late duplicate from a straggler is idempotently ignored
    assert not observer.process_batch(batch, frm="Delta")


# --- action requests ------------------------------------------------------

def test_validator_info_action_requires_privilege():
    from plenum_tpu_torch.common.node_messages import Reject, Reply, RequestNack
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.action_manager import VALIDATOR_INFO_ACTION

    pool = Pool()
    # trustee invokes the action: executes locally, no consensus round
    req = Request(pool.trustee.identifier, 1,
                  {"type": VALIDATOR_INFO_ACTION})
    req.signature = pool.trustee.sign_b58(req.signing_bytes())
    pool.submit(req, to=["Alpha"])
    pool.run(2.0)
    replies = [m for m, _ in pool.client_msgs["Alpha"]
               if isinstance(m, Reply)
               and m.result.get("type") == VALIDATOR_INFO_ACTION]
    assert replies, "no validator-info reply"
    info = replies[0].result["data"]
    assert info["name"] == "Alpha" and info["f"] == 1
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    # the action itself wrote NO txn (local execution, no consensus)
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1

    # an unprivileged (but registered and validly signed) identity is
    # refused by the authorization check, not the signature check
    nobody = Ed25519Signer(seed=b"action-nobody".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, nobody, 2))
    pool.run(3.0)
    req2 = Request(nobody.identifier, 1, {"type": VALIDATOR_INFO_ACTION})
    req2.signature = nobody.sign_b58(req2.signing_bytes())
    pool.submit(req2, to=["Alpha"])
    pool.run(2.0)
    # well-formed but refused -> REJECT (never NACK: the NACK/REJECT wire
    # split reserves NACK for malformed requests)
    rejects = [m for m, _ in pool.client_msgs["Alpha"]
               if isinstance(m, Reject) and "TRUSTEE" in m.reason]
    assert rejects


def test_observer_catches_up_across_a_gap():
    """An observer that missed pushes pulls the gap via GET_TXN-style
    fetches, then resumes applying pushed batches."""
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 BatchCommitted)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node.observer import NodeObserver

    pool = Pool()
    node = pool.nodes["Alpha"]
    node.observable.add_observer("obs")
    for i in range(3):
        user = Ed25519Signer(seed=(b"gap-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, user, i + 1))
        pool.run(3.0)
    pushes = [m for m, c in pool.client_msgs["Alpha"]
              if isinstance(m, BatchCommitted)]
    assert len(pushes) == 3

    observer = NodeObserver(_observer_components(pool.names))
    # the observer only sees the LAST push: gap -> refused
    assert not observer.process_batch(pushes[-1])

    live = node.c.db.get_ledger(DOMAIN_LEDGER_ID)

    def fetch(ledger_id, seq_no):
        ledger = node.c.db.get_ledger(ledger_id)
        return ledger.get_by_seq_no(seq_no) if seq_no <= ledger.size \
            else None

    # a LYING fetcher is detected by the batch-root check and everything
    # staged is discarded (nothing unverified ever commits)
    import copy

    def lying_fetch(ledger_id, seq_no):
        txn = copy.deepcopy(fetch(ledger_id, seq_no))
        txn["txn"]["data"]["dest"] = "FORGED"
        return txn

    assert not observer.catch_up(pushes[-1], lying_fetch)
    assert observer.c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1

    # the honest fetcher fills the gap and the push applies atomically
    assert observer.catch_up(pushes[-1], fetch)
    obs_ledger = observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
    assert obs_ledger.size == live.size == 4
    assert obs_ledger.root_hash == live.root_hash


def test_perf_metrics_emitted_during_ordering():
    """The perf-debugging metrics exist and carry
    real values after ordering traffic: per-phase 3PC timings on the
    master, plus depth gauges via the flush path, all visible in
    validator_info."""
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer

    pool = Pool()
    user = Ed25519Signer(seed=b"metrics-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)

    node = pool.nodes["Alpha"]
    summary = node.metrics.summary()
    for name in (MetricsName.PREPARE_PHASE_TIME,
                 MetricsName.COMMIT_PHASE_TIME,
                 MetricsName.ORDERING_TIME):
        assert name in summary, f"missing {name}: {sorted(summary)}"
        assert summary[name]["count"] >= 1
        assert summary[name]["avg"] >= 0.0
    # the per-batch invariant (order >= prepare) only holds across matched
    # sample sets; a straggler batch that prepared but never ordered would
    # skew averages, so gate on count equality
    if summary[MetricsName.ORDERING_TIME]["count"] == \
            summary[MetricsName.PREPARE_PHASE_TIME]["count"]:
        assert summary[MetricsName.ORDERING_TIME]["sum"] >= \
            summary[MetricsName.PREPARE_PHASE_TIME]["sum"]
    # depth gauges are sampled into the accumulators by the flush path
    # (flush() then clears, so sample manually to inspect)
    node.metrics.add_event(MetricsName.REQUEST_QUEUE_DEPTH, sum(
        len(q) for q in
        node.master_replica.ordering.request_queues.values()))
    info = node.validator_info()
    assert MetricsName.REQUEST_QUEUE_DEPTH in info["metrics"]
    assert MetricsName.ORDERING_TIME in info["metrics"]


# --- notifier events ------------------------------------------------------

def test_notifier_spike_detection_bounds():
    """Spike math follows the reference's historical-bounds model
    (notifier_plugin_manager.py:92-117): no emission until min_cnt history,
    none below the activity floor, emission outside bounds_coeff x avg."""
    from plenum_tpu_torch.node.notifier import (NotifierEventManager, TOPIC_SPIKE)

    events = []
    n = NotifierEventManager(bounds_coeff=3.0, min_cnt=3,
                             min_activity_threshold=5.0)
    n.register_handler(lambda topic, msg: events.append((topic, msg)))
    # building history: never spikes
    for v in (10.0, 11.0, 9.0):
        assert not n.check_throughput(v, "N1", 0.0)
    # inside bounds
    assert not n.check_throughput(12.0, "N1", 1.0)
    # way outside bounds -> spike
    assert n.check_throughput(200.0, "N1", 2.0)
    assert events and events[-1][0] == TOPIC_SPIKE
    assert events[-1][1]["value"] == 200.0
    # below the noise floor nothing fires even if ratio is huge
    quiet = NotifierEventManager(bounds_coeff=3.0, min_cnt=2,
                                 min_activity_threshold=5.0)
    quiet.register_handler(lambda t, m: events.append((t, m)))
    for v in (0.1, 0.2, 0.1, 2.0):
        assert not quiet.check_throughput(v, "N1", 0.0)
    # a broken handler never breaks the send path
    n._handlers.insert(0, lambda t, m: 1 / 0)
    assert n.check_throughput(0.01, "N1", 3.0)


def test_notifier_view_change_event_from_pool():
    """A real view change emits TOPIC_VIEW_CHANGE through the node's
    notifier (ref: viewChange notification wiring)."""
    from test_torch_pool import CpuConfig as Config
    from plenum_tpu_torch.node.notifier import TOPIC_VIEW_CHANGE
    from plenum_tpu_torch.network import Discard, match_dst, match_frm

    pool = Pool(config=Config(Max3PCBatchWait=0.05,
                              PRIMARY_HEALTH_CHECK_FREQ=0.5,
                              ORDERING_PROGRESS_TIMEOUT=2.0,
                              STATE_FRESHNESS_UPDATE_INTERVAL=3.0))
    events = {n: [] for n in pool.names}
    for name, node in pool.nodes.items():
        node.notifier.register_handler(
            lambda t, m, nm=name: events[nm].append((t, m)))
    for rule in (match_dst("Alpha"), match_frm("Alpha")):
        pool.net.add_rule(Discard(), rule)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    user = Ed25519Signer(seed=b"notif-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1),
                to=[n for n in pool.names if n != "Alpha"])
    pool.run(20.0)
    for name in pool.names:
        if name == "Alpha":
            continue
        vc = [m for t, m in events[name] if t == TOPIC_VIEW_CHANGE]
        assert vc, f"{name} emitted no view-change notification"
        assert vc[-1]["view_no"] >= 1


@pytest.mark.parametrize("name", [
    "test_pool_populates_metrics_and_validator_info",
    "test_observer_follows_committed_batches",
    "test_observer_refuses_tampered_batch",
    "test_observer_f_plus_1_data_quorum",
    "test_validator_info_action_requires_privilege",
    "test_observer_catches_up_across_a_gap",
    "test_perf_metrics_emitted_during_ordering",
    "test_notifier_view_change_event_from_pool",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_aux as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
