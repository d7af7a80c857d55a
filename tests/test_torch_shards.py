"""The port's copy of tests/test_shards.py, run on plenum_tpu_torch (nodes on
the CPU).

Horizontal state sharding (docs/sharding.md): the mapping ledger's
ownership proofs, the ShardRouter behind the ingress seam, the N-shard
sim fabric, composed cross-shard read verification (fail closed on every
tamper), and the shard-aware failover ladder.

The tier-1 CI smoke is `test_two_shard_smoke`: boot a 2-shard fabric,
route one write per shard, round-trip one verified cross-shard read.
"""
from __future__ import annotations

import copy

import pytest

from plenum_tpu_torch.common.request import Request
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import GET_NYM, NYM
from plenum_tpu_torch.shards import (MappingLedger, ShardDescriptor,
                               ShardReadGate, ShardedSimFabric,
                               equal_ranges, routing_key, verify_ownership)
from plenum_tpu_torch.shards.mapping import directory_bls_signers

NOW = lambda: 1000.0


def make_map(n_shards=2, epoch=0):
    dirs = directory_bls_signers(["Dir1", "Dir2", "Dir3", "Dir4"])
    descs = [ShardDescriptor(i, lo, hi,
                             [f"S{i}N{j}" for j in range(1, 5)],
                             {f"S{i}N{j}": f"pk{i}{j}"
                              for j in range(1, 5)}, epoch=epoch)
             for i, (lo, hi) in enumerate(equal_ranges(n_shards))]
    return MappingLedger(descs, dirs, now=NOW)


def make_fabric(**kw):
    kw.setdefault("config", Config(Max3PCBatchWait=0.05))
    return ShardedSimFabric(n_shards=2, nodes_per_shard=4, seed=3, **kw)


def signed_write(fab, user, req_id):
    req = Request(fab.trustee.identifier, req_id,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": user.verkey_b58})
    req.signature = fab.trustee.sign_b58(req.signing_bytes())
    return req


def user_on_shard(fab, sid, tag=b"u", start=0):
    """Deterministic search for a user whose DID the given shard owns."""
    for i in range(start, start + 400):
        u = Ed25519Signer(seed=(tag + b"%d" % i).ljust(32, b"\0")[:32])
        probe = Request(fab.trustee.identifier, 1,
                        {"type": NYM, "dest": u.identifier})
        if fab.router.shard_of(probe) == sid:
            return u
    raise AssertionError(f"no user found for shard {sid}")


# --- mapping ledger ---------------------------------------------------------

def test_equal_ranges_partition_the_keyspace():
    for n in (1, 2, 3, 4, 7):
        ranges = equal_ranges(n)
        assert ranges[0][0] == "0" * 64 and ranges[-1][1] is None
        for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
            assert hi == lo                       # contiguous, no gaps
        ml = make_map(n) if n == 2 else None
    # every key owned by EXACTLY one shard
    ml = make_map(4)
    for i in range(50):
        key = (b"cover%d" % i)
        owners = [d.shard_id for d in ml.descriptors if d.owns(key)]
        assert len(owners) == 1, (key, owners)


def test_ownership_proof_roundtrip_and_tamper_fail_closed():
    ml = make_map(2)
    key = routing_key({"dest": "SomeDid123"})
    want = ml.shard_of(key).shard_id
    proof = ml.ownership_proof(key)
    keys = ml.directory_keys

    desc, why = verify_ownership(key, proof, keys, now=NOW)
    assert why == "ok" and desc.shard_id == want

    cases = []

    def tampered(mutate):
        p = copy.deepcopy(proof)
        mutate(p)
        return verify_ownership(key, p, keys, now=NOW)

    # forged descriptor content (keys, nodes, range) breaks inclusion
    for field, value in (("bls_keys", {"Evil": "pk"}),
                         ("nodes", ["Evil1", "Evil2"]),
                         ("lo", "0" * 64)):
        desc2, why2 = tampered(
            lambda p, f=field, v=value: p["descriptor"].__setitem__(f, v))
        cases.append((field, desc2, why2))
    for field, got, why2 in cases:
        assert got is None, field
        assert why2 in ("bad_map_inclusion", "wrong_shard"), (field, why2)
    # spliced audit path / index
    assert tampered(lambda p: p.__setitem__("index", 1 - p["index"]))[1] \
        == "bad_map_inclusion"
    assert tampered(lambda p: p["audit_path"].__setitem__(
        0, p["audit_path"][0][::-1])) \
        [1] in ("bad_map_inclusion", "malformed_map_proof")
    # the OTHER shard's (honestly signed) descriptor: valid map row,
    # wrong owner -> wrong_shard, never ok
    other = next(d for d in ml.descriptors if d.shard_id != want)
    assert tampered(lambda p: p.__setitem__(
        "descriptor", other.to_dict()))[1] == "wrong_shard"
    # a whole fake map signed by NON-directory keys
    evil = make_map(2)
    evil_signers = directory_bls_signers(["Evil1", "Evil2", "Evil3",
                                          "Evil4"])
    evil = MappingLedger(
        [ShardDescriptor.from_dict(d.to_dict()) for d in ml.descriptors],
        evil_signers, now=NOW)
    got, why2 = verify_ownership(key, evil.ownership_proof(key), keys,
                                 now=NOW)
    assert got is None and why2 == "bad_map_multi_sig"
    # freshness + malformed
    assert verify_ownership(key, proof, keys, now=lambda: 1e9)[1] \
        == "stale_map_sig"
    assert verify_ownership(key, None, keys, now=NOW)[1] == "no_map_proof"
    assert verify_ownership(key, {"descriptor": 3}, keys, now=NOW)[1] \
        == "malformed_map_proof"


def test_reshard_ratchets_epoch_and_stales_old_proofs():
    ml = make_map(2)
    key = routing_key({"dest": "EpochDid"})
    old = ml.ownership_proof(key)
    ml.reshard([ShardDescriptor.from_dict(d.to_dict())
                for d in ml.descriptors])
    assert ml.epoch == 1
    # an epoch-0 proof verifies only for clients that never saw epoch 1
    assert verify_ownership(key, old, ml.directory_keys, min_epoch=0,
                            now=NOW)[1] == "ok"
    assert verify_ownership(key, old, ml.directory_keys, min_epoch=1,
                            now=NOW)[1] == "stale_map"
    fresh = ml.ownership_proof(key)
    assert verify_ownership(key, fresh, ml.directory_keys, min_epoch=1,
                            now=NOW)[1] == "ok"


# --- the 2-shard fabric (tier-1 CI smoke) -----------------------------------

def test_two_shard_smoke():
    """Boot a 2-shard fabric, route ONE write per shard, round-trip one
    verified cross-shard read — the always-on acceptance slice."""
    fab = make_fabric()
    users = {sid: user_on_shard(fab, sid, b"smoke") for sid in fab.shards}
    for req_id, (sid, u) in enumerate(sorted(users.items()), start=1):
        assert fab.submit_write(signed_write(fab, u, req_id)) == sid
    fab.run(8.0)
    # each write ordered ONLY on its owning shard, consistently
    for sid, shard in fab.shards.items():
        assert shard.domain_sizes() == {2}, \
            (sid, shard.domain_sizes())
    assert fab.router.summary()["per_shard"] == {0: 1, 1: 1}

    # cross-shard read: shard 1's user, composed verification
    driver = fab.read_driver()
    u1 = users[1]
    q = Request("reader", 7, {"type": GET_NYM, "dest": u1.identifier})
    res = driver.read(q, per_node_s=2.0, step_s=0.1)
    assert res is not None and res["data"]["verkey"] == u1.verkey_b58
    s = driver.stats.summary()
    assert s["single_reply_ok"] == 1 and s["fallbacks"] == 0
    assert s["cross_reads"] == 1 and s["map_proof_failures"] == 0
    # the ladder asked ONLY the owning shard
    assert s["msgs_sent"] == 1 and s["fanout"] == 2.0


def test_router_unroutable_surfaces():
    fab = make_fabric()
    u = user_on_shard(fab, 1, b"hole")
    # a map with a hole: drop shard 1's descriptor and republish
    fab.mapping.descriptors = [d for d in fab.mapping.descriptors
                               if d.shard_id == 0]
    fab.mapping.publish()
    nacked = []
    fab.router.on_unroutable = lambda req, frm, why: nacked.append(why)
    assert fab.submit_write(signed_write(fab, u, 1)) is None
    assert nacked and fab.router.stats["unroutable"] == 1


def test_ingress_front_door_routes_across_shards():
    """Admission + ONE batched auth at the entry node, then the verified
    write fans to the OWNING shard's submit_preverified — the PR 7
    ingress seam composed with the router."""
    fab = make_fabric()
    entry = fab.shards[0].names[0]               # front door on shard 0
    ing = fab.ingress_plane(entry, tick=False)
    u = user_on_shard(fab, 1, b"ing")            # write owned by shard 1
    req = signed_write(fab, u, 1)
    ing.submit(req.to_dict(), "cli-ing")
    for _ in range(60):
        ing.service()
        fab.run(0.2)
        if fab.shards[1].ordered_count() >= 1:
            break
    assert fab.shards[1].domain_sizes() == {2}   # ordered where it belongs
    assert fab.shards[0].domain_sizes() == {1}   # entry shard untouched
    assert ing.stats["auth_batches"] == 1        # auth paid once, up front
    assert fab.ingress_router.summary()["per_shard"][1] == 1


def test_shared_pipeline_amortizes_across_shards():
    fab = make_fabric(share_pipeline=True)
    assert fab.pipeline is not None
    for sid in fab.shards:
        u = user_on_shard(fab, sid, b"pipe")
        fab.submit_write(signed_write(fab, u, sid + 1))
    deadline = 0.0
    while deadline < 20.0 and any(s.domain_sizes() != {2}
                                  for s in fab.shards.values()):
        fab.run(0.5)
        fab.pipeline.flush()
        deadline += 0.5
    for shard in fab.shards.values():
        assert shard.domain_sizes() == {2}
    # every shard's auth rode the ONE shared ring
    assert fab.pipeline.stats["dispatches"] >= 1
    for shard in fab.shards.values():
        for node in shard.nodes.values():
            assert node.c.pipeline is fab.pipeline


# --- cross-shard tamper + failover ------------------------------------------

class LyingGate:
    """Wraps a ShardReadGate with a forged decoration."""

    def __init__(self, inner, mutate):
        self.inner = inner
        self.mutate = mutate

    def decorate(self, result, key):
        return self.mutate(self.inner.decorate(result, key), key)


def _fabric_with_data():
    fab = make_fabric()
    users = {sid: user_on_shard(fab, sid, b"liar") for sid in fab.shards}
    for req_id, (sid, u) in enumerate(sorted(users.items()), start=1):
        fab.submit_write(signed_write(fab, u, req_id))
    fab.run(8.0)
    for shard in fab.shards.values():
        assert shard.domain_sizes() == {2}
    return fab, users


def test_forged_mapping_proof_fails_over_within_shard():
    fab, users = _fabric_with_data()
    evil = MappingLedger(
        [ShardDescriptor.from_dict(d.to_dict())
         for d in fab.mapping.descriptors],
        directory_bls_signers(["Ev1", "Ev2", "Ev3", "Ev4"]), now=NOW)

    def forge(result, key):
        result["shard_proof"] = evil.ownership_proof(key)
        return result

    # EVERY node of the owning shard serves the forged map: the ladder
    # must reject each rung fail-closed and end in the bounded fallback,
    # never accept
    fab.gates[1] = LyingGate(fab.gates[1], forge)
    driver = fab.read_driver()
    q = Request("r", 9, {"type": GET_NYM, "dest": users[1].identifier})
    res = driver.read(q, per_node_s=1.0, step_s=0.1)
    s = driver.stats.summary()
    assert res is None and s["fallbacks"] == 1
    assert s["map_proof_failures"] == 4          # one per shard rung
    assert s["map_failure_reasons"] == {"bad_map_multi_sig": 4}
    # heal the gate: the same driver verifies again
    fab.gates[1] = fab.gates[1].inner
    res = driver.read(Request("r", 10, {"type": GET_NYM,
                                        "dest": users[1].identifier}),
                      per_node_s=2.0, step_s=0.1)
    assert res is not None


def test_wrong_shard_answer_rejected():
    """A shard-0 node answering a shard-1 key serves a VALID-looking
    envelope (absence against ITS root) — the composed check kills it:
    the honest map proof names shard 1's keys, the envelope is signed by
    shard 0's."""
    fab, users = _fabric_with_data()
    driver = fab.read_driver()
    wrong = fab.shards[0].names[0]
    right = fab.shards[1].names
    q = Request("r", 11, {"type": GET_NYM, "dest": users[1].identifier})
    res = driver.read(q, per_node_s=2.0, step_s=0.1,
                      order=[wrong] + list(right))
    assert res is not None and \
        res["data"]["verkey"] == users[1].verkey_b58
    s = driver.stats.summary()
    assert s["verify_failures"] >= 1 and s["failovers"] >= 1
    assert s["fallbacks"] == 0


def test_stale_map_after_reshard_fails_closed():
    fab, users = _fabric_with_data()
    # shard 1's gate keeps serving the pre-reshard (epoch-0) map
    stale_ml = MappingLedger(
        [ShardDescriptor.from_dict(d.to_dict())
         for d in fab.mapping.descriptors],
        fab.directory, now=fab.timer.get_current_time)
    fab.gates[1] = ShardReadGate(stale_ml)
    fab.mapping.reshard([ShardDescriptor.from_dict(d.to_dict())
                         for d in fab.mapping.descriptors])
    driver = fab.read_driver()                   # view sees epoch 1
    q = Request("r", 12, {"type": GET_NYM, "dest": users[1].identifier})
    res = driver.read(q, per_node_s=1.0, step_s=0.1)
    s = driver.stats.summary()
    assert res is None and s["fallbacks"] == 1
    assert s["map_failure_reasons"].get("stale_map", 0) >= 1
    # the gate refreshes to the post-reshard map: reads verify again
    fab.gates[1] = ShardReadGate(fab.mapping)
    res = driver.read(Request("r", 13, {"type": GET_NYM,
                                        "dest": users[1].identifier}),
                      per_node_s=2.0, step_s=0.1)
    assert res is not None


def test_shard_aware_failover_stays_in_owning_shard():
    """The satellite regression: the ladder with a shard resolver fails
    over WITHIN the owning shard (first rung partitioned -> second rung
    of the SAME shard answers) and never consults a foreign shard —
    while a flat mis-configured client aimed at the wrong shard would
    accept that shard's VERIFIED absence as an answer."""
    from plenum_tpu_torch.reads import SimReadDriver
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    fab, users = _fabric_with_data()
    q = Request("r", 14, {"type": GET_NYM, "dest": users[1].identifier})

    # the wrong-shard hazard the shard ladder exists to prevent: a flat
    # driver configured with ONLY shard 0's keys verifies shard 0's
    # absence proof for a key shard 1 holds — a lie that checks out
    from plenum_tpu_torch.common.node_messages import Reply

    flat_names = fab.shards[0].names

    def flat_collect(n):
        msgs = fab.shards[0].client_msgs[n]
        out = [dict(m.result) for m, c in msgs
               if c == "flat" and isinstance(m, Reply)]
        fab.shards[0].client_msgs[n] = [(m, c) for m, c in msgs
                                        if c != "flat"]
        return out

    flat = SimReadDriver(
        lambda n, r: fab.shards[0].nodes[n].handle_client_message(
            r.to_dict(), "flat"),
        flat_collect,
        fab.run, flat_names, pool_bls_keys(flat_names), freshness_s=1e12,
        now=fab.timer.get_current_time)
    res = flat.read(q, per_node_s=2.0, step_s=0.1)
    assert res is not None and res.get("data") is None   # "verified" lie

    # the shard-aware ladder: kill the first ladder rung of the owning
    # shard (drops client messages, the sim twin of a partitioned node);
    # the read fails over to ANOTHER shard-1 node
    driver = fab.read_driver()
    view_nodes = driver.shard_resolver(q)
    assert set(view_nodes) == set(fab.shards[1].names)
    from plenum_tpu_torch.reads.client import ladder_order
    first = ladder_order([n for n in view_nodes], q)[0]
    fab.shards[1].nodes[first].handle_client_message = \
        lambda *a, **kw: None
    res = driver.read(q, per_node_s=1.0, step_s=0.1)
    s = driver.stats.summary()
    assert res is not None and res["data"]["verkey"] == \
        users[1].verkey_b58
    assert s["failovers"] >= 1 and s["fallbacks"] == 0
    # every message went to the owning shard (1 timeout rung + 1 answer)
    assert s["msgs_sent"] <= len(view_nodes)


def test_unreachable_owning_shard_fails_closed():
    """A client that can only dial its HOME shard, asked for a key a
    FOREIGN shard owns: the empty shard ladder must fail closed — never
    escalate to a home-shard broadcast whose f+1 nodes would happily
    agree on absence against the wrong root."""
    import asyncio

    from plenum_tpu_torch.reads import SimReadDriver
    from plenum_tpu_torch.reads.client import VerifyingReadClient

    q = Request("r", 1, {"type": GET_NYM, "dest": "ForeignDid"})
    resolver = lambda req: ["S1N1", "S1N2", "S1N3", "S1N4"]

    client = VerifyingReadClient({"S0N1": ("h", 1), "S0N2": ("h", 2)}, 0,
                                 {}, shard_resolver=resolver)
    with pytest.raises(TimeoutError):
        asyncio.run(client.submit_read(q, per_node_timeout=0.01))
    assert client.stats.fallbacks == 1 and client.stats.msgs_sent == 0

    driver = SimReadDriver(
        lambda n, r: pytest.fail("submitted to a foreign shard"),
        lambda n: [], lambda s: None, ["S0N1", "S0N2"], {},
        shard_resolver=resolver)
    assert driver.read(q, per_node_s=0.01) is None
    s = driver.stats.summary()
    assert s["fallbacks"] == 1 and s["msgs_sent"] == 0


# --- elastic resharding (shards/reshard.py) ---------------------------------

def _seed_shard0(fab, n=5, tag=b"el"):
    """Order n writes owned by shard 0 (some land in the upper half of
    its range — the slice a midpoint split moves)."""
    users = []
    rid = 0
    for k in range(n):
        u = user_on_shard(fab, 0, tag, start=k * 13)
        rid += 1
        users.append(u)
        assert fab.submit_write(signed_write(fab, u, rid)) == 0
    fab.run(10.0)
    assert fab.shards[0].domain_sizes() == {n + 1}
    return users


def test_live_split_migrates_range_under_traffic():
    fab = make_fabric()
    users = _seed_shard0(fab)
    m = fab.reshard.split(0)
    assert sorted(fab.shards) == [0, 1, 2] and m.phase == "copying"
    # traffic DURING the migration keeps routing through the live map
    during = [user_on_shard(fab, 0, b"mid", start=k * 29) for k in range(3)]
    for i, u in enumerate(during):
        fab.submit_write(signed_write(fab, u, 100 + i))
    for _ in range(120):
        fab.run(0.5)
        if m.phase == "done":
            break
    assert m.phase == "done", m.to_dict()
    assert fab.mapping.epoch == 1                 # the ledger transaction
    assert fab.shards[2].ordered_count() >= 1     # the range moved
    # EVERY write (pre-split, mid-split) verifies at its current owner
    driver = fab.read_driver()
    for i, u in enumerate(users + during):
        q = Request("r", 500 + i, {"type": GET_NYM, "dest": u.identifier})
        res = driver.read(q, per_node_s=2.0, step_s=0.1)
        assert res is not None and \
            res["data"]["verkey"] == u.verkey_b58, \
            (u.identifier, driver.stats.summary())
    s = driver.stats.summary()
    assert s["fallbacks"] == 0 and s["map_proof_failures"] == 0
    # no duplicate: each moved DID ordered EXACTLY once at the target
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.execution import txn as txn_lib
    node = next(iter(fab.shards[2].nodes.values()))
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    dests = [txn_lib.txn_data(ledger.get_by_seq_no(i)).get("dest")
             for i in range(2, ledger.size + 1)]
    assert len(dests) == len(set(dests)), f"duplicated writes: {dests}"


def test_live_merge_retires_source():
    fab = make_fabric()
    u0 = user_on_shard(fab, 0, b"mg0")
    u1 = user_on_shard(fab, 1, b"mg1")
    for rid, u in ((1, u0), (2, u1)):
        fab.submit_write(signed_write(fab, u, rid))
    fab.run(10.0)
    m = fab.reshard.merge(1, 0)
    for _ in range(120):
        fab.run(0.5)
        if m.phase == "done":
            break
    assert m.phase == "done", m.to_dict()
    assert fab.mapping.epoch == 1
    assert sorted(fab.shards) == [0] and 1 in fab.retired
    # the merged-away shard's data verifies from the surviving shard
    driver = fab.read_driver()
    for i, u in enumerate((u0, u1)):
        q = Request("r", 600 + i, {"type": GET_NYM, "dest": u.identifier})
        res = driver.read(q, per_node_s=2.0, step_s=0.1)
        assert res is not None and res["data"]["verkey"] == u.verkey_b58
    # post-merge writes for the moved range route to the survivor
    u2 = user_on_shard(fab, 0, b"mg2", start=50)
    assert fab.submit_write(signed_write(fab, u2, 3)) == 0
    # the aggregator forgot the retired nodes (gone, not 0.0-health)
    assert not any(n.startswith("S1N") for n in fab.aggregator.latest)


def test_stale_route_forwarded_in_window_then_nacked():
    """The dual-ownership handoff contract: a write landing at the OLD
    owner after the ratchet is forwarded (ordered exactly once at the
    new owner) inside the window, and NACKed fail-closed after it."""
    fab = make_fabric()
    _seed_shard0(fab, n=3)
    m = fab.reshard.split(0)
    while m.phase == "copying":
        fab.run(0.5)
    assert m.phase == "handoff"
    stale_sink = fab.router.sinks[0]          # a stale router's decision
    mover = user_on_shard(fab, 2, b"race")    # key the new map gives to 2
    req = signed_write(fab, mover, 300)
    before = fab.shards[2].ordered_count()
    stale_sink(req, "stale-client")
    for _ in range(40):
        fab.run(0.5)
        if fab.shards[2].ordered_count() > before:
            break
    assert fab.shards[2].ordered_count() == before + 1, \
        "forwarded write not ordered at the new owner"
    assert m.forwarded == 1 and not fab.stale_nacks
    # drain the window; past it the same stale route fails closed
    for _ in range(240):
        fab.run(0.5)
        done = fab.reshard.history and \
            fab.timer.get_current_time() > (m.drain_until or 1e18)
        if done:
            break
    late = signed_write(fab, user_on_shard(fab, 2, b"race", start=40), 301)
    count2 = fab.shards[2].ordered_count()
    count0 = fab.shards[0].ordered_count()
    stale_sink(late, "stale-client")
    fab.run(5.0)
    assert fab.stale_nacks, "late stale write was not NACKed"
    assert fab.shards[2].ordered_count() == count2
    assert fab.shards[0].ordered_count() == count0, \
        "late stale write ordered at the OLD owner (double ownership)"


def test_read_ladder_refreshes_on_reshard():
    """Satellite: a client whose map view predates the reshard must not
    error — the ladder refreshes the view and retries once against the
    new owner."""
    fab = make_fabric()
    users = _seed_shard0(fab)
    driver = fab.read_driver()                # view at epoch 0
    m = fab.reshard.split(0)
    for _ in range(120):
        fab.run(0.5)
        if m.phase == "done":
            break
    assert m.phase == "done"
    moved = next(u for u in users
                 if fab.router.shard_of(
                     Request("p", 1, {"type": GET_NYM,
                                      "dest": u.identifier})) == 2)
    q = Request("r", 700, {"type": GET_NYM, "dest": moved.identifier})
    res = driver.read(q, per_node_s=1.0, step_s=0.1)
    s = driver.stats.summary()
    assert res is not None and res["data"]["verkey"] == moved.verkey_b58, s
    assert s["map_retries"] == 1 and s["fallbacks"] == 0, s


def test_maybe_split_consumes_imbalance_signal():
    """The PR 11 aggregator's hot-shard flag is the split trigger."""
    fab = make_fabric()
    # synthetic skewed telemetry: shard 0 orders 50x shard 1's rate
    for i in range(30):
        t = float(i)
        for name, sid, rate in (("S0N1", 0, 50), ("S1N1", 1, 1)):
            fab.aggregator.ingest({
                "v": 1, "node": name, "seq": i, "t": t,
                "tags": {"shard": sid}, "counters": {}, "sampled": {},
                "state": {"node": {"ordered_total": i * rate}}})
    index, hot = fab.aggregator.load_imbalance()
    assert hot == 0 and index >= fab.config.SHARD_IMBALANCE_THRESHOLD
    m = fab.reshard.maybe_split()
    assert m is not None and m.source == 0
    assert fab.reshard.maybe_split() is None    # one migration at a time


def test_front_door_fast_nacks_dead_shard():
    """Satellite: a write whose owning shard scores 0.0 health (every
    member silent past the staleness bound) is refused immediately with
    a retryable LoadShed instead of timing out against a dead pool."""
    from plenum_tpu_torch.common.node_messages import LoadShed

    fab = make_fabric()
    entry = fab.shards[0].names[0]
    ing = fab.ingress_plane(entry, tick=False)
    # shard 1 went dark: its members' last snapshots are far behind the
    # fleet clock the (live) shard-0 members keep advancing
    for name in fab.shards[1].names:
        fab.aggregator.ingest({"v": 1, "node": name, "seq": 0, "t": 0.0,
                               "tags": {"shard": 1}, "counters": {},
                               "sampled": {}, "state": {}})
    for i, name in enumerate(fab.shards[0].names):
        fab.aggregator.ingest({"v": 1, "node": name, "seq": 9, "t": 100.0,
                               "tags": {"shard": 0}, "counters": {},
                               "sampled": {}, "state": {}})
    assert fab.aggregator.shard_health()[1] == 0.0
    u = user_on_shard(fab, 1, b"dead")
    ing.submit(signed_write(fab, u, 1).to_dict(), "cli-x")
    for _ in range(30):
        ing.service()
        fab.run(0.2)
        sheds = [msg for msg, _ in fab.shards[0].client_msgs[entry]
                 if isinstance(msg, LoadShed)]
        if sheds:
            break
    assert sheds and "unavailable" in sheds[0].reason
    assert sheds[0].retry_after > 0          # the RETRYABLE hint
    assert fab.ingress_router.stats["fast_nacked"] == 1
    assert fab.shards[1].ordered_count() == 0


def test_directory_signer_rotation_stales_old_committee():
    """Satellite: rotating one directory signer re-signs the map root;
    proofs minted under the old committee fail closed against the
    rotated trust root."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner

    ml = make_map(2)
    key = routing_key({"dest": "RotDid"})
    old_proof = ml.ownership_proof(key)
    old_keys = dict(ml.directory_keys)
    new_signer = BlsCryptoSigner(seed=b"rotated-dir-1".ljust(32, b"\0"))
    ml.rotate_signer("Dir1", new_signer)
    new_keys = ml.directory_keys
    assert new_keys != old_keys
    # freshly minted proof verifies against the NEW trust root
    fresh = ml.ownership_proof(key)
    assert verify_ownership(key, fresh, new_keys, now=NOW)[1] == "ok"
    # the OLD committee's proof fails closed against the new root
    assert verify_ownership(key, old_proof, new_keys, now=NOW)[1] \
        == "bad_map_multi_sig"
    # and the new proof fails against a verifier still on the old root
    assert verify_ownership(key, fresh, old_keys, now=NOW)[1] \
        == "bad_map_multi_sig"
    with pytest.raises(KeyError):
        ml.rotate_signer("NotADir", new_signer)


# --- observability ----------------------------------------------------------

def _folds_from(collector):
    out = {}
    for name, a in collector.accumulators.items():
        f = {"count": a.count, "sum": a.total, "min": a.min, "max": a.max,
             "mean": a.total / a.count if a.count else None,
             "last": a.total / a.count if a.count else None, "flushes": 1}
        if a.samples:
            f["samples"] = list(a.samples)
        out[name] = f
    return out


def test_metrics_report_shards_section():
    from plenum_tpu_torch.tools.metrics_report import derive_summary

    fab, users = _fabric_with_data()
    driver = fab.read_driver()
    q = Request("r", 15, {"type": GET_NYM, "dest": users[1].identifier})
    assert driver.read(q, per_node_s=2.0, step_s=0.1) is not None
    fab.ordered_counts()
    summary = derive_summary(_folds_from(fab.metrics), span_s=10.0)
    sh = summary["shards"]
    assert sh["routed"] == 2 and sh["unroutable"] == 0
    assert sh["cross_shard_reads"] == 1 and sh["cross_shard_reads_ok"] == 1
    assert sh["map_proof_failures"] == 0
    assert sh["ordered_per_shard_mean"] == 1.0
    assert sh["cross_verify_ms_p50"] is not None


def test_trace_report_attributes_shards():
    from plenum_tpu_torch.tools.trace_report import assemble, summarize

    fab = make_fabric(tracing=True)
    users = {sid: user_on_shard(fab, sid, b"tr") for sid in fab.shards}
    for req_id, (sid, u) in enumerate(sorted(users.items()), start=1):
        fab.submit_write(signed_write(fab, u, req_id))
    fab.run(8.0)
    driver = fab.read_driver()
    q = Request("r", 16, {"type": GET_NYM, "dest": users[1].identifier})
    assert driver.read(q, per_node_s=2.0, step_s=0.1) is not None
    report = assemble(fab.tracer_snapshots())
    sh = report["shards"]
    assert set(sh["nodes_by_shard"]) == {"0", "1"}
    assert sorted(sh["nodes_by_shard"]["0"]) == fab.shards[0].names
    assert sh["route_decisions"] == 2
    assert sh["routes_per_shard"] == {"0": 1, "1": 1}
    assert sh["cross_shard_reads"] == 1 and sh["cross_shard_ok"] == 1
    assert "cross_shard" in report["attribution"]
    assert summarize(report)["shards"] == sh
