"""The port's copy of tests/test_edge.py, run on plenum_tpu_torch (nodes on
the CPU).

Proof CDN edge tier (reads/edge.py, docs/edge.md).

Covers the keyless EdgeCache (content addressing, anchor-advance
invalidation at an f+1 push vote, stale-while-revalidate under the
freshness bound, negative caching, proofless pass-through), the SimEdge
push/serve surfaces riding the observer ingress router unchanged, the
edge-first client ladder rung (served / escalated / rejected), and the
aggregator + autopilot absorbed-capacity seam (note_edge /
edge_hit_rate / the observer-spawn hold).
"""
from __future__ import annotations

import copy

import pytest

from plenum_tpu_torch.common.metrics import MetricsCollector
from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, Reply,
                                             RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import GET_NYM, GET_TXN
from plenum_tpu_torch.reads import (EDGE_CANNOT_SERVE, READ_PROOF, EdgeCache,
                              SimEdge, SimReadDriver)

from test_torch_pool import Pool, signed_nym
from test_torch_reads import FOREVER, pool_bls_keys

EDGE_FRESH = 1e9        # an edge bound that never triggers in sim time


def attach_edge(pool, name="edge1", freshness_s=EDGE_FRESH, f=1):
    """SimEdge over the pool: origin round-robins the validators' own
    read planes, pushes registered over the observer client plane."""
    rr = {"i": 0}

    def origin(request):
        v = pool.names[rr["i"] % len(pool.names)]
        rr["i"] += 1
        return pool.nodes[v].read_plane.answer(request)

    edge = SimEdge(name, origin, now=pool.timer.get_current_time,
                   freshness_s=freshness_s, f=f)
    edge.register(lambda v, msg: pool.nodes[v]
                  .handle_client_message(msg, edge.client_id),
                  pool.names)
    pool.run(0.5)
    return edge


def make_edge_driver(pool, edge, client="edrv", freshness_s=FOREVER,
                     on_fail=None):
    """Three-tier driver: the edge rung first, validators as failover."""
    def submit(name, req):
        if name == edge.name:
            edge.handle_client_message(req.to_dict(), client)
        else:
            pool.nodes[name].handle_client_message(req.to_dict(), client)

    def collect(name):
        if name == edge.name:
            out = [m.result for m, _ in edge.sent if isinstance(m, Reply)]
            edge.sent.clear()
            return out
        msgs = pool.client_msgs[name]
        out = [m.result for m, c in msgs
               if isinstance(m, Reply) and c == client]
        pool.client_msgs[name] = [
            (m, c) for m, c in msgs
            if not (isinstance(m, Reply) and c == client)]
        return out

    return SimReadDriver(submit, collect, pool.run, pool.names,
                         pool_bls_keys(pool), freshness_s=freshness_s,
                         now=pool.timer.get_current_time,
                         edge_names=[edge.name],
                         on_edge_verify_failure=on_fail)


def _edge_pool(freshness_s=EDGE_FRESH):
    from test_torch_ingress import run_routed
    pool = Pool()
    edge = attach_edge(pool, freshness_s=freshness_s)
    user = Ed25519Signer(seed=b"edge-reads-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    run_routed(pool, [edge], 6.0)
    return pool, edge, user


# --- edge-served verified reads -------------------------------------------

def test_edge_cold_miss_then_warm_hit_verifies():
    """First read misses (one origin fetch = one pool read), second is a
    pure cache hit — and BOTH verify client-side against the real BLS
    anchor: the keyless cache added no trust surface."""
    pool, edge, user = _edge_pool()
    driver = make_edge_driver(pool, edge)
    for req_id in (10, 11):
        q = Request("edrv", req_id, {"type": GET_NYM,
                                     "dest": user.identifier})
        res = driver.read(q)
        assert res is not None
        assert res["data"]["verkey"] == user.verkey_b58
        assert res[READ_PROOF]["kind"] == "state"
    s = driver.stats
    assert s.edge_ok == 2 and s.single_reply_ok == 2
    assert s.failovers == 0 and s.fallbacks == 0
    cs = edge.cache.stats
    assert cs == {**cs, "hits": 1, "misses": 1, "origin_fetches": 1}
    assert cs["bytes_served"] > 0


def test_tampered_edge_fails_over_never_forges():
    """A lying edge (forged verkey in cached bytes) is REJECTED by the
    client's verify gate and the ladder falls over to a validator — the
    read still completes with the true value (deny-but-never-forge)."""
    pool, edge, user = _edge_pool()
    real_serve = edge.cache.serve

    def lying(request):
        res = real_serve(request)
        if isinstance(res, dict) and isinstance(res.get("data"), dict):
            bad = copy.deepcopy(res)
            bad["data"]["verkey"] = "4" * 43
            return bad
        return res

    edge.cache.serve = lying
    rejected = []
    driver = make_edge_driver(pool, edge, on_fail=rejected.append)
    q = Request("edrv", 20, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None
    assert res["data"]["verkey"] == user.verkey_b58
    s = driver.stats
    assert s.edge_ok == 0 and s.single_reply_ok == 1
    assert s.edge_verify_failures == 1 and s.verify_failures == 1
    assert s.failovers >= 1 and s.fallbacks == 0
    assert rejected == [edge.name]


def test_edge_nacks_writes_and_ladder_survives():
    """A write through the edge rung gets the explicit serving NACK (a
    keyless cache cannot order anything); the client ladder treats the
    non-REPLY as one failover, exactly like a down rung."""
    pool, edge, user = _edge_pool()
    write = signed_nym(
        pool.trustee,
        Ed25519Signer(seed=b"edge-write-user".ljust(32, b"\0")[:32]),
        req_id=2)
    out = edge.serve(write.to_dict())
    assert isinstance(out, RequestNack)
    assert out.reason == EDGE_CANNOT_SERVE
    assert edge.cache.stats["origin_fetches"] == 1  # origin refused it


def test_negative_absence_result_cached():
    """An absence proof (GET_TXN beyond the signed tree) caches exactly
    like a positive result: the second read is a negative cache hit and
    still verifies client-side."""
    pool, edge, user = _edge_pool()
    driver = make_edge_driver(pool, edge)
    for req_id in (30, 31):
        q = Request("edrv", req_id, {"type": GET_TXN, "data": 99})
        res = driver.read(q)
        assert res is not None
        assert res.get("data") is None
        assert res[READ_PROOF]["kind"] == "merkle"
    s = driver.stats
    assert s.edge_ok == 2
    cs = edge.cache.stats
    assert cs["negative_hits"] == 1 and cs["hits"] == 1


def test_anchor_advance_invalidates_then_revalidates():
    """A committed write advances the anchor; the BatchCommitted push
    fan-out marks superseded entries stale. The next read serves the
    still-inside-bound stale copy AND refreshes from origin in the same
    call (stale-while-revalidate); the read after that is a fresh hit
    under the new root."""
    from test_torch_ingress import run_routed
    pool, edge, user = _edge_pool()
    driver = make_edge_driver(pool, edge)
    q = Request("edrv", 40, {"type": GET_NYM, "dest": user.identifier})
    assert driver.read(q) is not None          # cold: cached at root R1
    # a write on the SAME ledger advances the domain anchor to R2
    other = Ed25519Signer(seed=b"edge-advance-usr".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, other, req_id=3))
    run_routed(pool, [edge], 6.0)
    cs = edge.cache.stats
    assert cs["invalidations"] >= 1, "push fan-out never invalidated"
    q2 = Request("edrv", 41, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q2)
    assert res is not None and res["data"]["verkey"] == user.verkey_b58
    cs = edge.cache.stats
    assert cs["stale_served"] == 1 and cs["revalidations"] == 1
    q3 = Request("edrv", 42, {"type": GET_NYM, "dest": user.identifier})
    assert driver.read(q3) is not None
    cs = edge.cache.stats
    assert cs["stale_served"] == 1, "revalidation did not refresh"
    assert driver.stats.edge_ok == 3 and driver.stats.fallbacks == 0


def test_stale_beyond_bound_is_a_miss():
    """A superseded entry OUTSIDE the freshness bound is never served
    stale (the client would reject it as a lie): it drops and the read
    pays one origin refetch instead."""
    from test_torch_ingress import run_routed
    pool, edge, user = _edge_pool(freshness_s=5.0)
    driver = make_edge_driver(pool, edge)
    q = Request("edrv", 50, {"type": GET_NYM, "dest": user.identifier})
    assert driver.read(q) is not None
    other = Ed25519Signer(seed=b"edge-too-old-usr".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, other, req_id=4))
    run_routed(pool, [edge], 6.0)              # invalidate + age past 5 s
    misses_before = edge.cache.stats["misses"]
    q2 = Request("edrv", 51, {"type": GET_NYM, "dest": user.identifier})
    assert driver.read(q2) is not None
    cs = edge.cache.stats
    assert cs["misses"] == misses_before + 1
    assert cs["stale_served"] == 0 and cs["revalidations"] == 0


# --- the push vote (unit) -------------------------------------------------

def test_push_quorum_gates_advisory_adoption():
    """One pusher (<= f) can NEVER move the advisory anchor — f
    Byzantine validators cannot even churn the cache; f+1 distinct
    pushers adopt, and a later quorum on an OLDER timestamp is
    refused (the advisory clock never moves backwards)."""
    cache = EdgeCache(lambda request: None, f=1, now=lambda: 100.0)
    assert not cache.on_push(1, "aa", 50.0, "V1")
    assert not cache.on_push(1, "aa", 50.0, "V1")   # replays don't count
    assert cache.on_push(1, "aa", 50.0, "V2")        # f+1 distinct: adopt
    assert cache._advisory[1] == ("aa", 50.0)
    assert not cache.on_push(1, "bb", 10.0, "V1")
    assert not cache.on_push(1, "bb", 10.0, "V2")    # older ts: refused
    assert cache._advisory[1] == ("aa", 50.0)
    assert cache.on_push(1, "cc", 60.0, "V1") is False
    assert cache.on_push(1, "cc", 60.0, "V3")        # newer: adopt
    assert cache._advisory[1] == ("cc", 60.0)


def test_poisoned_push_degrades_never_forges():
    """A quorum-backed but BOGUS root hint only flips entries to the
    revalidation path — every read still returns origin-anchored bytes
    that verify client-side (hint poisoning is DoS, not forgery)."""
    pool, edge, user = _edge_pool()
    driver = make_edge_driver(pool, edge)
    q = Request("edrv", 60, {"type": GET_NYM, "dest": user.identifier})
    assert driver.read(q) is not None
    # 2 = f+1 colluding pushers agree on a fabricated far-future root
    far = pool.timer.get_current_time() + 1e6
    assert edge.cache.on_push(DOMAIN_LEDGER_ID, "f" * 64, far, "V1") \
        is False
    assert edge.cache.on_push(DOMAIN_LEDGER_ID, "f" * 64, far, "V2")
    q2 = Request("edrv", 61, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q2)
    assert res is not None and res["data"]["verkey"] == user.verkey_b58
    assert driver.stats.verify_failures == 0
    assert edge.cache.stats["revalidations"] >= 1


# --- aggregator + autopilot seam ------------------------------------------

def test_aggregator_edge_hit_rate_window():
    from test_torch_pool import CpuConfig as Config
    from plenum_tpu_torch.observability import FleetAggregator
    agg = FleetAggregator(config=Config(SLO_BURN_SLOW_WINDOW=20.0))
    assert agg.edge_hit_rate("r0") is None
    agg.note_edge("r0", hits=50, served=100, edges=2, bytes_served=1000,
                  now=1.0)
    agg.note_edge("r0", hits=100, served=100, edges=2, bytes_served=1000,
                  now=2.0)
    assert abs(agg.edge_hit_rate("r0") - 0.75) < 1e-9
    # old windows age out of the slow-window fold
    agg.note_edge("r0", hits=100, served=100, edges=2, bytes_served=0,
                  now=50.0)
    assert abs(agg.edge_hit_rate("r0") - 1.0) < 1e-9
    ed = agg.edge
    assert ed["regions"]["r0"]["served"] == 300
    assert ed["bytes"] == 2000


def test_autopilot_edge_absorb_holds_observer_spawn():
    """With sustained read burn, the observer policy SPAWNS — unless the
    region's edges already absorb the reads (hit-rate at the configured
    bar), in which case it HOLDS with the rate as ledger evidence."""
    from test_torch_pool import CpuConfig as Config
    from plenum_tpu_torch.control.autopilot import Autopilot
    from plenum_tpu_torch.observability import FleetAggregator

    class _Fleet:
        def __init__(self):
            self.regions = {"r0": [object()]}
            self.spawned = []
            self._last_served = {}
            self.capacity = 64.0

        def count(self, region):
            return len(self.regions[region]) + len(self.spawned)

        def spawn(self, region):
            self.spawned.append(region)
            return f"{region}-obs{len(self.spawned) + 1}"

        def scale_in_safe(self, region):
            return False

    class _Fabric:
        config = Config(AUTOPILOT=True)
        metrics = MetricsCollector()
        fabric_tracer = None

        def __init__(self):
            self.aggregator = FleetAggregator(config=self.config)
            self.observers = _Fleet()

    fab = _Fabric()
    ap = Autopilot(fab)
    agg = fab.aggregator
    agg._streaks[("slo_burn.reads", "r0")] = ap._sustain  # sustained burn
    agg.note_edge("r0", hits=99, served=100, edges=3, now=1.0)
    ap._policy_observers(1.0)
    assert fab.observers.spawned == [], "spawned despite edge absorption"
    holds = [r for r in ap.ledger.records if r.action == "hold"]
    assert holds and holds[-1].evidence.get("edge_absorbing") is True
    assert abs(holds[-1].evidence["edge_hit_rate"] - 0.99) < 1e-9
    # the edges stop absorbing: the SAME sustained burn now spawns, and
    # the (sub-bar) hit rate still rides the action's evidence
    agg.note_edge("r0", hits=0, served=900, edges=3, now=2.0)
    ap._policy_observers(2.0)
    assert fab.observers.spawned == ["r0"]
    spawn = [r for r in ap.ledger.records
             if r.action == "observer_spawn"][-1]
    assert spawn.evidence["edge_hit_rate"] < 0.95


@pytest.mark.parametrize("name", [
    "test_edge_cold_miss_then_warm_hit_verifies",
    "test_tampered_edge_fails_over_never_forges",
    "test_edge_nacks_writes_and_ladder_survives",
    "test_negative_absence_result_cached",
    "test_anchor_advance_invalidates_then_revalidates",
    "test_stale_beyond_bound_is_a_miss",
    "test_poisoned_push_degrades_never_forges",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_edge as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
