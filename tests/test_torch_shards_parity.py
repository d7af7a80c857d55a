"""The shard fabric, the 2PC and the autopilot held against the reference's:
one seeded script per module group runs on both packages' fabrics (MockTimer,
the `cpu` backend) and must give the same outputs exactly — the mapping
ledger's root and ownership proofs (mapping, router, read client), the
ordered txns and the domain, state and audit roots of every node of every
shard (fabric, reshard, cross_write), and the control-ledger records and
their replay (control, tools/control_audit). No tolerance: every value is
compared with ==."""
import importlib
import json
import types

import pytest

LEDGERS = (1, 3)                # domain, audit


def _mods(pkg: str) -> types.SimpleNamespace:
    imp = importlib.import_module
    return types.SimpleNamespace(
        shards=imp(f"{pkg}.shards"), mapping=imp(f"{pkg}.shards.mapping"),
        Config=imp(f"{pkg}.config").Config,
        Request=imp(f"{pkg}.common.request").Request,
        Signer=imp(f"{pkg}.crypto.ed25519").Ed25519Signer,
        txn=imp(f"{pkg}.execution.txn"),
        audit=imp(f"{pkg}.tools.control_audit"))


def _fabric(m, **cfg):
    cfg.setdefault("Max3PCBatchWait", 0.05)
    return m.shards.ShardedSimFabric(
        n_shards=2, nodes_per_shard=4, seed=3,
        config=m.Config(crypto_backend="cpu", **cfg))


def _write(m, fab, user, req_id):
    req = m.Request(fab.trustee.identifier, req_id,
                    {"type": m.txn.NYM, "dest": user.identifier,
                     "verkey": user.verkey_b58})
    req.signature = fab.trustee.sign_b58(req.signing_bytes())
    return req


def _user_on(m, fab, sid, tag: bytes):
    for i in range(400):
        u = m.Signer(seed=(tag + b"%d" % i).ljust(32, b"\0")[:32])
        probe = m.Request(fab.trustee.identifier, 1,
                          {"type": m.txn.NYM, "dest": u.identifier})
        if fab.router.shard_of(probe) == sid:
            return u
    raise AssertionError(sid)


def _shard_state(fab) -> dict:
    """Every node's ordered domain txns and its domain, state and audit
    roots, per shard (retired shards included)."""
    out = {}
    for sid, shard in sorted({**fab.retired, **fab.shards}.items()):
        nodes = {}
        for name, node in sorted(shard.nodes.items()):
            db = node.c.db
            dom = db.get_ledger(1)
            nodes[name] = {
                "roots": [db.get_ledger(lid).root_hash.hex()
                          for lid in LEDGERS],
                "state": db.get_state(1).committed_head_hash.hex(),
                "txns": [json.dumps(dom.get_by_seq_no(i)["txn"],
                                    sort_keys=True)
                         for i in range(1, dom.size + 1)]}
        out[sid] = nodes
    return out


def _mapping(m, fab, users) -> dict:
    return {"root": fab.mapping.root_hex, "epoch": fab.mapping.epoch,
            "descriptors": [d.to_dict() for d in fab.mapping.descriptors],
            "proofs": [fab.mapping.ownership_proof(
                m.mapping.routing_key({"type": m.txn.NYM,
                                       "dest": u.identifier}))
                       for u in users]}


def fabric_script(pkg: str) -> dict:
    """Writes on both shards, verified cross-shard reads, a live split
    under traffic, then one cross-shard write."""
    m = _mods(pkg)
    fab = _fabric(m)
    users = [m.Signer(seed=(b"par-%d" % i).ljust(32, b"\0"))
             for i in range(8)]
    out = {"mapping_boot": _mapping(m, fab, users)}
    reqs = [_write(m, fab, u, i + 1) for i, u in enumerate(users)]
    out["routes"] = [fab.submit_write(r) for r in reqs]
    fab.run(8.0)
    out["writes"] = _shard_state(fab)
    driver = fab.read_driver()
    reads = []
    for i, u in enumerate(users[:4]):
        q = m.Request("par-reader", 100 + i,
                      {"type": "105", "dest": u.identifier})
        res = driver.read(q, per_node_s=2.0, step_s=0.1)
        reads.append(json.dumps(res, sort_keys=True, default=str))
    out["reads"] = reads
    # the read client's counters (its verify times are host clocks)
    out["read_stats"] = {k: v for k, v in driver.stats.summary().items()
                         if "_ms" not in k}
    # a live split of shard 0 under traffic
    mig = fab.reshard.split(0)
    during = [_user_on(m, fab, 0, b"par-mid%d-" % k) for k in range(2)]
    for i, u in enumerate(during):
        fab.submit_write(_write(m, fab, u, 200 + i))
    for _ in range(120):
        fab.run(0.5)
        if mig.phase == "done":
            break
    out["migration"] = mig.to_dict()
    out["mapping_split"] = _mapping(m, fab, users + during)
    out["split"] = _shard_state(fab)
    # one proof-carrying cross-shard write, shard 0 -> the split-off shard
    dep = users[out["routes"].index(1)] if 1 in out["routes"] else None
    assert dep is not None
    xsw = fab.cross_writes()
    home = _user_on(m, fab, 0, b"par-xw")
    txid = xsw.begin(
        0, 1,
        {"type": m.txn.NYM, "dest": home.identifier,
         "verkey": home.verkey_b58},
        {"type": m.txn.GET_NYM, "dest": dep.identifier},
        {"type": m.txn.ATTRIB, "dest": dep.identifier,
         "raw": json.dumps({"linked": home.identifier})})
    out["xsw"] = (txid, xsw.drive(txid), xsw.summary())
    out["cross_write"] = _shard_state(fab)
    return out


def control_script(pkg: str) -> dict:
    """The autopilot's degradation ladder walked down and back up on a
    sustained-burn judgment, as tests/test_autopilot.py forces it."""
    m = _mods(pkg)
    fab = m.shards.ShardedSimFabric(
        n_shards=2, nodes_per_shard=3, seed=11,
        config=m.Config(crypto_backend="cpu", Max3PCBatchWait=0.05,
                        AUTOPILOT=True, AUTOPILOT_INTERVAL=0.5,
                        AUTOPILOT_SUSTAIN=2, AUTOPILOT_RECOVER_SUSTAIN=2,
                        AUTOPILOT_COOLDOWN=3.0, RESHARD_COOLDOWN=3.0,
                        TELEMETRY_INTERVAL=0.5))
    ap, agg = fab.autopilot, fab.aggregator
    fab.ingress_plane(fab.shards[0].names[0], tick=False)
    fab.run(2.0)
    key = ("slo_burn.ingress", "front")
    for burning in [True] * 16 + [False] * 30:
        agg.now += ap._interval
        if burning:
            agg._streaks[key] = agg._streaks.get(key, 0) + 1
            agg._clear_streaks[key] = 0
        else:
            agg._clear_streaks[key] = agg._clear_streaks.get(key, 0) + 1
            agg._streaks[key] = 0
        ap.service()
    recs = ap.ledger.to_dicts()
    return {"records": json.dumps(recs, sort_keys=True),
            "audit": m.audit.audit_records(recs),
            "replay": json.dumps(m.audit.replay(recs), sort_keys=True),
            "summary": json.dumps(ap.summary(), sort_keys=True),
            "fabric": _shard_state(fab)}


@pytest.fixture(scope="module")
def fabric_runs():
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        ref = fabric_script("plenum_tpu")
    with fresh_bls_caches():
        port = fabric_script("plenum_tpu_torch")
    return ref, port


@pytest.mark.parametrize("key", ["mapping_boot", "routes", "writes", "reads",
                                 "read_stats", "migration", "mapping_split",
                                 "split", "xsw", "cross_write"])
def test_fabric_script_is_the_references(fabric_runs, key):
    ref, port = fabric_runs
    assert port[key] == ref[key]


def test_fabric_script_did_real_work(fabric_runs):
    """The script's outputs are not vacuous: writes ordered on both
    shards, reads verified, the split done, the 2PC committed."""
    _, port = fabric_runs
    assert sorted(set(port["routes"])) == [0, 1]
    sizes = {sid: {len(n["txns"]) for n in nodes.values()}
             for sid, nodes in port["writes"].items()}
    assert all(len(s) == 1 and s.pop() > 1 for s in sizes.values()), sizes
    assert port["read_stats"]["map_proof_failures"] == 0
    assert port["read_stats"]["fallbacks"] == 0
    assert all(r != "null" for r in port["reads"])
    assert port["migration"]["phase"] == "done"
    assert port["mapping_split"]["epoch"] == 1
    assert port["xsw"][1] == "committed"


def test_control_ledger_is_the_references():
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        ref = control_script("plenum_tpu")
    with fresh_bls_caches():
        port = control_script("plenum_tpu_torch")
    assert port == ref
    recs = json.loads(port["records"])
    assert [r["action"] for r in recs if r["action"] != "hold"] == \
        ["degrade", "degrade", "recover", "recover"]
    assert port["audit"] == []
