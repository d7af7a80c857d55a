"""The port's copy of tests/test_reads.py, run on plenum_tpu_torch, the
observer-served reads included (the in-process observer on the `cpu`
backend, as test_torch_ingress.py attaches it).

Verified read plane: single-reply state-proof reads (docs/reads.md).

Covers the server ReadPlane (envelopes, anchoring, cache), the shared
verification path (MultiSignature.verify + verify_read_proof soundness
against tampering), the client ladder (SimReadDriver fanout/failover),
the read-reply quorum-key fix in PoolClient, and the GET_TXN ledgerId
NACK.
"""
from __future__ import annotations

import copy

import pytest

from plenum_tpu_torch.client.client import PoolClient
from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, Reply,
                                             RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.crypto.multi_signature import (MultiSignature,
                                               MultiSignatureValue)
from plenum_tpu_torch.execution.txn import (GET_ATTR, GET_NYM, GET_TXN, ATTRIB,
                                      NYM)
from plenum_tpu_torch.reads import (READ_PROOF, SimReadDriver, result_digest,
                              verify_read_proof)

from test_torch_pool import Pool, signed_nym

FOREVER = 1e12          # freshness bound that never triggers


def pool_bls_keys(pool) -> dict:
    # the canonical name-seeded derivation (matches test_pool genesis)
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys as derive
    return derive(pool.names)


def make_driver(pool, client="drv", freshness_s=FOREVER):
    def submit(name, req):
        pool.nodes[name].handle_client_message(req.to_dict(), client)

    def collect(name):
        msgs = pool.client_msgs[name]
        out = [m.result for m, c in msgs
               if isinstance(m, Reply) and c == client]
        pool.client_msgs[name] = [
            (m, c) for m, c in msgs
            if not (isinstance(m, Reply) and c == client)]
        return out

    return SimReadDriver(submit, collect, pool.run, pool.names,
                         pool_bls_keys(pool), freshness_s=freshness_s,
                         now=pool.timer.get_current_time)


@pytest.fixture(scope="module")
def rpool():
    pool = Pool()
    user = Ed25519Signer(seed=b"reads-user-1".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    # one ATTRIB so GET_ATTR has something to prove
    import json
    req = Request(pool.trustee.identifier, 2,
                  {"type": ATTRIB, "dest": user.identifier,
                   "raw": json.dumps({"endpoint": "https://x"})})
    req.signature = pool.trustee.sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(6.0)
    pool.user = user
    return pool


# --- single verified reply, per proof kind -------------------------------

def test_get_nym_single_reply_verifies(rpool):
    driver = make_driver(rpool)
    q = Request("anyone", 100, {"type": GET_NYM,
                                "dest": rpool.user.identifier})
    res = driver.read(q)
    assert res is not None
    assert res["data"]["verkey"] == rpool.user.verkey_b58
    assert res[READ_PROOF]["kind"] == "state"
    s = driver.stats
    assert s.single_reply_ok == 1 and s.failovers == 0 and s.fallbacks == 0
    # THE fanout claim: one request out, one reply in
    assert s.msgs_sent == 1 and s.replies_seen == 1


def test_get_nym_absence_proof_verifies(rpool):
    driver = make_driver(rpool)
    q = Request("anyone", 101, {"type": GET_NYM, "dest": "NoSuchDid999"})
    res = driver.read(q)
    assert res is not None and res["data"] is None
    assert driver.stats.single_reply_ok == 1


def test_get_attr_single_reply_verifies(rpool):
    driver = make_driver(rpool)
    q = Request("anyone", 102, {"type": GET_ATTR,
                                "dest": rpool.user.identifier,
                                "attr_name": "endpoint"})
    res = driver.read(q)
    assert res is not None
    assert res["meta"]["kind"] == "raw"
    assert driver.stats.single_reply_ok == 1


def test_get_txn_merkle_anchored_to_signed_root(rpool):
    driver = make_driver(rpool)
    q = Request("anyone", 103, {"type": GET_TXN,
                                "ledgerId": DOMAIN_LEDGER_ID, "data": 2})
    res = driver.read(q)
    assert res is not None
    env = res[READ_PROOF]
    assert env["kind"] == "merkle"
    # anchored to the multi-sig's txn root, not the legacy current root
    assert env["txn_root"] == env["multi_signature"][2][3]
    assert driver.stats.single_reply_ok == 1


def test_get_txn_beyond_signed_tree_absence(rpool):
    driver = make_driver(rpool)
    q = Request("anyone", 104, {"type": GET_TXN,
                                "ledgerId": DOMAIN_LEDGER_ID,
                                "data": 999})
    res = driver.read(q)
    assert res is not None and res["data"] is None
    assert driver.stats.single_reply_ok == 1


def test_get_txn_invalid_ledger_id_nacked(rpool):
    """Satellite: an invalid ledgerId must NACK, not silently coerce to
    DOMAIN (which would answer a different question than asked)."""
    node = rpool.nodes["Alpha"]
    q = Request("anyone", 105, {"type": GET_TXN, "ledgerId": 99,
                                "data": 1})
    node.handle_client_message(q.to_dict(), "nack-cli")
    rpool.run(0.5)
    nacks = [m for m, c in rpool.client_msgs["Alpha"]
             if isinstance(m, RequestNack) and c == "nack-cli"]
    assert nacks and "ledgerId" in nacks[-1].reason


# --- tamper suite: every forgery must fail CLOSED ------------------------

def _verified_result(rpool, req_id=120):
    node = rpool.nodes["Alpha"]
    q = Request("anyone", req_id, {"type": GET_NYM,
                                   "dest": rpool.user.identifier})
    res = node.read_plane.answer(q)
    keys = pool_bls_keys(rpool)
    ok, reason = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=FOREVER,
        now=rpool.timer.get_current_time)
    assert ok, reason
    return q, res, keys


def _reverify(rpool, q, res, keys):
    return verify_read_proof(GET_NYM, q.operation, res, keys,
                             freshness_s=FOREVER,
                             now=rpool.timer.get_current_time)


def test_tampered_value_rejected(rpool):
    q, res, keys = _verified_result(rpool)
    bad = copy.deepcopy(res)
    ent = bad[READ_PROOF]["entries"][0]
    ent["value"] = bytes(reversed(bytes.fromhex(ent["value"]))).hex()
    ok, reason = _reverify(rpool, q, bad, keys)
    assert not ok and reason in ("bad_state_proof", "data_mismatch")


def test_tampered_data_rejected(rpool):
    q, res, keys = _verified_result(rpool)
    bad = copy.deepcopy(res)
    bad["data"] = dict(bad["data"], verkey="FakeVerkey111111111111")
    ok, reason = _reverify(rpool, q, bad, keys)
    assert not ok and reason == "result_digest_mismatch"


def test_unsigned_root_rejected(rpool):
    q, res, keys = _verified_result(rpool)
    bad = copy.deepcopy(res)
    bad[READ_PROOF]["root_hash"] = "ab" * 32
    bad[READ_PROOF]["result_digest"] = result_digest(bad).hex()
    ok, reason = _reverify(rpool, q, bad, keys)
    assert not ok and reason == "unsigned_root"


def test_tampered_multi_sig_participants_rejected(rpool):
    q, res, keys = _verified_result(rpool)
    bad = copy.deepcopy(res)
    ms = bad[READ_PROOF]["multi_signature"]
    # claim a participant set the aggregate was not built from
    ms[1] = list(ms[1])[:-1] + ["Alpha"] \
        if ms[1][-1] != "Alpha" else list(ms[1])[:-1] + ["Beta"]
    bad[READ_PROOF]["result_digest"] = result_digest(bad).hex()
    ok, reason = _reverify(rpool, q, bad, keys)
    assert not ok


def test_spliced_proof_from_other_result_rejected(rpool):
    """An honest envelope spliced onto a different (honest) result must
    fail the result-digest binding."""
    q1, res1, keys = _verified_result(rpool, req_id=121)
    node = rpool.nodes["Alpha"]
    q2 = Request("anyone", 122, {"type": GET_NYM, "dest": "NoSuchDid999"})
    res2 = node.read_plane.answer(q2)
    spliced = copy.deepcopy(res2)
    spliced[READ_PROOF] = copy.deepcopy(res1[READ_PROOF])
    ok, reason = verify_read_proof(
        GET_NYM, q2.operation, spliced, keys, freshness_s=FOREVER,
        now=rpool.timer.get_current_time)
    assert not ok and reason == "result_digest_mismatch"


def test_freshness_bound_rejects_old_anchor(rpool):
    q, res, keys = _verified_result(rpool)
    ok, reason = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=5.0,
        now=lambda: rpool.timer.get_current_time() + 3600.0)
    assert not ok and reason == "stale"


def _anchor_ts(res) -> float:
    return MultiSignature.from_list(
        list(res[READ_PROOF]["multi_signature"])).value.timestamp


def test_freshness_exactly_at_bound_passes(rpool):
    """The bound is inclusive (`abs(skew) > freshness_s` rejects): an
    anchor EXACTLY freshness_s old still verifies — the edge tier's
    stale-while-revalidate window leans on this edge."""
    q, res, keys = _verified_result(rpool, req_id=130)
    ts = _anchor_ts(res)
    ok, reason = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=5.0,
        now=lambda: ts + 5.0)
    assert ok, reason


def test_freshness_just_past_bound_rejects(rpool):
    q, res, keys = _verified_result(rpool, req_id=131)
    ts = _anchor_ts(res)
    ok, reason = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=5.0,
        now=lambda: ts + 5.0001)
    assert not ok and reason == "stale"


def test_freshness_rejects_future_anchor_clock_skew(rpool):
    """abs() makes the window symmetric: an anchor from the FUTURE
    (skewed or lying clock) beyond the bound fails exactly like an old
    one; inside the bound the skew is tolerated."""
    q, res, keys = _verified_result(rpool, req_id=132)
    ts = _anchor_ts(res)
    ok, _ = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=5.0,
        now=lambda: ts - 5.0)
    assert ok                     # skew inside the bound: tolerated
    ok, reason = verify_read_proof(
        GET_NYM, q.operation, res, keys, freshness_s=5.0,
        now=lambda: ts - 5.0001)
    assert not ok and reason == "stale"


# --- cache + invalidation -------------------------------------------------

def test_result_cache_hits_and_commit_invalidation():
    pool = Pool(seed=77)
    user = Ed25519Signer(seed=b"cache-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    node = pool.nodes["Alpha"]
    plane = node.read_plane

    q1 = Request("r1", 1, {"type": GET_NYM, "dest": user.identifier})
    q2 = Request("r2", 9, {"type": GET_NYM, "dest": user.identifier})
    r1 = plane.answer(q1)
    hits_before = plane.stats["cache_hits"]
    r2 = plane.answer(q2)            # same question, different asker
    assert plane.stats["cache_hits"] == hits_before + 1
    # per-request echo differs, content identical
    assert (r1["identifier"], r1["reqId"]) == ("r1", 1)
    assert (r2["identifier"], r2["reqId"]) == ("r2", 9)
    assert result_digest(r1) == result_digest(r2)

    # rotate the DID's verkey -> batch commit must invalidate the cache
    rotated = Ed25519Signer(seed=b"cache-user-2".ljust(32, b"\0")[:32])
    upd = Request(pool.trustee.identifier, 2,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": rotated.verkey_b58})
    upd.signature = pool.trustee.sign_b58(upd.signing_bytes())
    anchors_before = plane.stats["anchor_updates"]
    pool.submit(upd)
    pool.run(6.0)
    assert plane.stats["anchor_updates"] > anchors_before
    r3 = plane.answer(Request("r3", 1, {"type": GET_NYM,
                                        "dest": user.identifier}))
    assert r3["data"]["verkey"] == rotated.verkey_b58
    ok, reason = verify_read_proof(
        GET_NYM, {"type": GET_NYM, "dest": user.identifier}, r3,
        pool_bls_keys(pool), freshness_s=FOREVER,
        now=pool.timer.get_current_time)
    assert ok, reason


# --- MultiSignature.verify (satellite) -----------------------------------

def _ms_fixture():
    names = ["A", "B", "C", "D"]
    signers = {n: BlsCryptoSigner(seed=f"ms-{n}".encode().ljust(32, b"\0"))
               for n in names}
    keys = {n: s.pk for n, s in signers.items()}
    value = MultiSignatureValue(ledger_id=1, state_root_hash="aa" * 32,
                                pool_state_root_hash="bb" * 32,
                                txn_root_hash="cc" * 32, timestamp=42.0)
    participants = ("A", "B", "C")
    from plenum_tpu_torch.crypto import bls as bls_lib
    agg = bls_lib.aggregate_sigs(
        [signers[n].sign(value.as_single_value()) for n in participants])
    return keys, MultiSignature(signature=agg, participants=participants,
                                value=value)


def test_multi_signature_verify_ok():
    keys, ms = _ms_fixture()
    assert ms.verify(keys)
    assert ms.verify(keys.get, n=4)         # callable lookup needs n


def test_multi_signature_verify_wrong_participant_set():
    keys, ms = _ms_fixture()
    lying = MultiSignature(ms.signature, ("A", "B", "D"), ms.value)
    assert not lying.verify(keys)
    unknown = MultiSignature(ms.signature, ("A", "B", "Zz"), ms.value)
    assert not unknown.verify(keys)
    dup = MultiSignature(ms.signature, ("A", "A", "B"), ms.value)
    assert not dup.verify(keys)


def test_multi_signature_verify_tampered_value():
    keys, ms = _ms_fixture()
    tampered = MultiSignature(
        ms.signature, ms.participants,
        ms.value._replace(timestamp=ms.value.timestamp + 1))
    assert not tampered.verify(keys)
    wrong_root = MultiSignature(
        ms.signature, ms.participants,
        ms.value._replace(state_root_hash="dd" * 32))
    assert not wrong_root.verify(keys)


def test_multi_signature_verify_sub_quorum_and_garbage():
    keys, ms = _ms_fixture()
    # 2 of 4 < n - f = 3
    from plenum_tpu_torch.crypto import bls as bls_lib
    short = MultiSignature(ms.signature, ("A", "B"), ms.value)
    assert not short.verify(keys)
    garbage = MultiSignature("!!not-base58!!", ms.participants, ms.value)
    assert not garbage.verify(keys)
    # callable lookup without a pool size must refuse, not guess
    assert not ms.verify(keys.get)


# --- PoolClient read-reply quorum key (satellite) ------------------------

def test_vote_key_separates_diverging_read_replies():
    """Regression: read replies (no txn metadata) from nodes returning
    DIFFERENT data must land in DIFFERENT f+1 buckets."""
    honest = {"op": "REPLY",
              "result": {"type": GET_NYM, "dest": "D", "identifier": "c",
                         "reqId": 1, "data": {"verkey": "VK1"}}}
    lying = copy.deepcopy(honest)
    lying["result"]["data"] = {"verkey": "EVIL"}
    assert PoolClient._vote_key(honest) != PoolClient._vote_key(lying)
    # identical content from another node (even a different asker echo /
    # a different honest multi-sig participant subset) -> same bucket
    twin = copy.deepcopy(honest)
    twin["result"]["reqId"] = 1
    twin["result"][READ_PROOF] = {"kind": "state", "anything": 1}
    assert PoolClient._vote_key(honest) == PoolClient._vote_key(twin)
    # write replies keep voting by txn identity
    w1 = {"op": "REPLY", "result": {
        "txn": {"metadata": {"digest": "d1", "from": "c", "reqId": 1}},
        "txnMetadata": {"seqNo": 7}}}
    w2 = copy.deepcopy(w1)
    assert PoolClient._vote_key(w1) == PoolClient._vote_key(w2)
    w2["result"]["txnMetadata"]["seqNo"] = 8
    assert PoolClient._vote_key(w1) != PoolClient._vote_key(w2)
    nack = {"op": "REQNACK", "reason": "no"}
    assert PoolClient._vote_key(nack) == ("REQNACK", "no")


# --- failover + A/B fanout ------------------------------------------------

class LyingPlane:
    """Wraps a node's ReadPlane, corrupting every dict result."""

    def __init__(self, inner, mutate):
        self._inner = inner
        self._mutate = mutate

    def answer_batch(self, requests):
        out = []
        for o in self._inner.answer_batch(requests):
            if isinstance(o, dict):
                o = self._mutate(copy.deepcopy(o))
            out.append(o)
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _forge_value(result):
    env = result.get(READ_PROOF)
    if env and env.get("entries"):
        e = env["entries"][0]
        if e.get("value"):
            e["value"] = bytes(reversed(bytes.fromhex(e["value"]))).hex()
    return result


def test_failover_to_honest_node(rpool):
    liar = rpool.names[0]
    node = rpool.nodes[liar]
    real = node.read_plane
    node.read_plane = LyingPlane(real, _forge_value)
    try:
        driver = make_driver(rpool, client="fo")
        q = Request("anyone", 130, {"type": GET_NYM,
                                    "dest": rpool.user.identifier})
        res = driver.read(q, order=list(rpool.names))   # liar first
        assert res is not None
        assert res["data"]["verkey"] == rpool.user.verkey_b58
        s = driver.stats
        assert s.failovers == 1 and s.verify_failures == 1
        assert s.single_reply_ok == 1 and s.fallbacks == 0
    finally:
        node.read_plane = real


def test_fanout_ab_single_reply_vs_broadcast(rpool):
    """The acceptance A/B: a verified read is 1 request + 1 reply; the
    legacy path pays n requests + n replies for the same answer."""
    n = len(rpool.names)
    driver = make_driver(rpool, client="ab")
    for i in range(10):
        q = Request("ab", 200 + i, {"type": GET_NYM,
                                    "dest": rpool.user.identifier})
        assert driver.read(q) is not None
    s = driver.stats.summary()
    assert s["fanout"] == 2.0            # 1 tx + 1 rx per read
    # legacy broadcast: same 10 reads cost n tx + n rx each
    legacy_msgs = 0
    for i in range(10):
        q = Request("ab-legacy", 300 + i,
                    {"type": GET_NYM, "dest": rpool.user.identifier})
        rpool.submit(q, client="ab-legacy")
        legacy_msgs += n
    rpool.run(1.0)
    replies = [m for name in rpool.names
               for m, c in rpool.client_msgs[name]
               if isinstance(m, Reply) and c == "ab-legacy"]
    legacy_fanout = (legacy_msgs + len(replies)) / 10
    assert legacy_fanout >= 2 * n        # n requests + n replies per read
    assert s["fanout"] * n <= legacy_fanout


def test_read_plane_metrics_flow():
    """Proof-gen timers + cache gauges reach the flushed metrics rows."""
    import tempfile
    from plenum_tpu_torch.common.metrics import MetricsName
    pool = Pool(seed=91)
    user = Ed25519Signer(seed=b"metrics-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    node = pool.nodes["Alpha"]
    for i in range(3):
        node.handle_client_message(
            Request("m", i + 1, {"type": GET_NYM,
                                 "dest": user.identifier}).to_dict(), "m")
    pool.run(0.5)
    accs = node.metrics.accumulators
    assert accs[MetricsName.READ_QUERIES].total >= 3
    assert MetricsName.READ_PROOF_GEN_TIME in accs
    node._sample_crypto_gauges()
    assert accs[MetricsName.READ_CACHE_HITS].max >= 1


# --- VerifyingReadClient over real sockets -------------------------------

def test_verifying_read_client_tcp_ladder(rpool):
    """The asyncio client end to end: framed wire, single-node sends,
    verify, failover past a lying server to an honest one."""
    import asyncio

    from plenum_tpu_torch.common.serialization import pack, unpack
    from plenum_tpu_torch.reads.client import VerifyingReadClient, ladder_order

    node = rpool.nodes["Alpha"]
    q = Request("tcpc", 900, {"type": GET_NYM,
                              "dest": rpool.user.identifier})
    honest_core = node.read_plane.answer(q)
    keys = pool_bls_keys(rpool)

    def personalize(core, req_dict):
        out = copy.deepcopy(core)
        out["identifier"] = req_dict.get("identifier")
        out["reqId"] = req_dict.get("reqId")
        return out

    async def serve(reader, writer, lie):
        try:
            while True:
                hdr = await reader.readexactly(4)
                frame = await reader.readexactly(
                    int.from_bytes(hdr, "big"))
                req_dict = unpack(frame)
                result = personalize(honest_core, req_dict)
                if lie:
                    result["data"] = dict(result["data"],
                                          verkey="EvilVerkey1111")
                    # smart liar: re-bind the digest so rejection comes
                    # from the proof chain, not the cheap digest check
                    from plenum_tpu_torch.reads import result_digest
                    result[READ_PROOF] = dict(
                        result[READ_PROOF],
                        result_digest=result_digest(result).hex())
                data = pack({"op": "REPLY", "result": result})
                writer.write(len(data).to_bytes(4, "big") + data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass

    async def main():
        srv_a = await asyncio.start_server(
            lambda r, w: serve(r, w, True), "127.0.0.1", 0)
        srv_b = await asyncio.start_server(
            lambda r, w: serve(r, w, True), "127.0.0.1", 0)
        ports = [s.sockets[0].getsockname()[1] for s in (srv_a, srv_b)]
        addrs = {"NodeA": ("127.0.0.1", ports[0]),
                 "NodeB": ("127.0.0.1", ports[1])}
        # whatever rung the ladder visits LAST becomes the honest one;
        # every earlier rung lies -> the read must fail over to the end
        order = ladder_order(list(addrs), q)
        lies = {order[0]: True, order[1]: False}
        honest_srv = await asyncio.start_server(
            lambda r, w: serve(r, w, False), "127.0.0.1", 0)
        # rebuild: liar on rung 0, honest on rung 1
        addrs[order[1]] = ("127.0.0.1",
                           honest_srv.sockets[0].getsockname()[1])
        client = VerifyingReadClient(
            addrs, f=0, bls_keys=keys, freshness_s=FOREVER,
            now=rpool.timer.get_current_time)
        try:
            msg = await client.submit_read(q, per_node_timeout=3.0)
        finally:
            await client.close()
            for s in (srv_a, srv_b, honest_srv):
                s.close()
        return msg, client.stats

    msg, stats = asyncio.run(main())
    assert msg["op"] == "REPLY"
    assert msg["result"]["data"]["verkey"] == rpool.user.verkey_b58
    assert stats.single_reply_ok == 1
    assert stats.failovers == 1 and stats.verify_failures == 1
    assert stats.fallbacks == 0


# --- regressions ---------------------------------------------------------

def test_forged_absence_tree_size_rejected(rpool):
    """The multi-sig signs no tree size: a liar claiming a SMALLER tree
    (to 'prove' a committed txn absent) must fail the last-leaf binding."""
    node = rpool.nodes["Alpha"]
    keys = pool_bls_keys(rpool)
    # honest absence envelope (seq 999 beyond the signed tree)
    honest = node.read_plane.answer(
        Request("abs", 1, {"type": GET_TXN, "ledgerId": DOMAIN_LEDGER_ID,
                           "data": 999}))
    env = honest[READ_PROOF]
    assert env.get("last_leaf"), "absence envelope must bind the size"
    # the lie: txn 2 exists, but claim tree_size=1 so 2 > size -> absent
    forged = copy.deepcopy(honest)
    forged["seqNo"] = 2
    fenv = forged[READ_PROOF]
    fenv["seq_no"] = 2
    fenv["tree_size"] = 1
    fenv["result_digest"] = result_digest(forged).hex()
    op = {"type": GET_TXN, "ledgerId": DOMAIN_LEDGER_ID, "data": 2}
    ok, reason = verify_read_proof(GET_TXN, op, forged, keys,
                                   freshness_s=FOREVER,
                                   now=rpool.timer.get_current_time)
    assert not ok and reason == "unbound_tree_size"
    # stripping the binding entirely must also fail closed
    stripped = copy.deepcopy(forged)
    stripped[READ_PROOF].pop("last_leaf")
    ok, _ = verify_read_proof(GET_TXN, op, stripped, keys,
                              freshness_s=FOREVER,
                              now=rpool.timer.get_current_time)
    assert not ok
    # tree_size=0 claim needs the empty-tree root, which the signed
    # root of a populated ledger is not
    zero = copy.deepcopy(forged)
    zero[READ_PROOF]["tree_size"] = 0
    zero[READ_PROOF]["result_digest"] = result_digest(zero).hex()
    ok, reason = verify_read_proof(GET_TXN, op, zero, keys,
                                   freshness_s=FOREVER,
                                   now=rpool.timer.get_current_time)
    assert not ok and reason == "unbound_tree_size"


def test_vote_key_ignores_legacy_multi_sig_variation():
    """Honest nodes embed whichever n-f COMMIT-sig subset they
    aggregated into the legacy state_proof field; identical read data
    must still pool into ONE f+1 bucket."""
    a = {"op": "REPLY", "result": {
        "type": GET_NYM, "dest": "D", "data": {"verkey": "VK"},
        "state_proof": {"root_hash": "aa", "proof_nodes": "bb",
                        "multi_signature": ["sig1", ["A", "B", "C"],
                                            [1, "r", "p", "t", 1.0]]}}}
    b = copy.deepcopy(a)
    b["result"]["state_proof"]["multi_signature"] = \
        ["sig2", ["B", "C", "D"], [1, "r", "p", "t", 1.0]]
    assert PoolClient._vote_key(a) == PoolClient._vote_key(b)
    # honest nodes answering at DIFFERENT commit points cite different
    # current roots in the advisory proof fields — still one bucket
    # (proofs are unsigned-by-this-quorum attachments, data is the vote)
    c = copy.deepcopy(a)
    c["result"]["state_proof"]["root_hash"] = "ee"
    c["result"]["merkle_proof"] = {"rootHash": "ff", "treeSize": 9}
    assert PoolClient._vote_key(a) == PoolClient._vote_key(c)
    # diverging DATA is real divergence
    d = copy.deepcopy(a)
    d["result"]["data"] = {"verkey": "OTHER"}
    assert PoolClient._vote_key(a) != PoolClient._vote_key(d)


def test_cache_invalidated_on_commit_even_without_anchor_advance():
    """When multi-sig aggregation lags a commit, the commit alone must
    flush the ledger's cache — otherwise the unchanged anchor key keeps
    serving pre-commit data."""
    pool = Pool(seed=55)
    user = Ed25519Signer(seed=b"lagging-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    plane = pool.nodes["Alpha"].read_plane
    plane.answer(Request("c", 1, {"type": GET_NYM,
                                  "dest": user.identifier}))
    assert plane._cache.get(DOMAIN_LEDGER_ID)
    # a commit whose multi-sig hasn't landed (state root not in the BLS
    # store): anchor stays put, cache must still flush
    anchors = dict(plane._anchors)
    plane.on_batch_committed(DOMAIN_LEDGER_ID, "ff" * 32, "ee" * 32)
    assert not plane._cache.get(DOMAIN_LEDGER_ID)
    assert plane._anchors == anchors


def test_forged_derived_metadata_rejected(rpool):
    """A smart liar re-binding the result digest after forging seqNo/
    txnTime/dest (fields a client consumes but that aren't the data
    blob) must still fail the proven-projection check."""
    for field, value in (("seqNo", 999999), ("txnTime", 1.0),
                         ("dest", "SomeOtherDid")):
        q, res, keys = _verified_result(rpool, req_id=140)
        bad = copy.deepcopy(res)
        bad[field] = value
        bad[READ_PROOF]["result_digest"] = result_digest(bad).hex()
        ok, reason = _reverify(rpool, q, bad, keys)
        assert not ok, f"forged {field} verified"
        assert reason == "data_mismatch", (field, reason)


def test_get_txn_default_ledger_gets_proof(rpool):
    """GET_TXN with ledgerId OMITTED defaults to DOMAIN (like the
    handler) and must still ship a verifiable envelope — not silently
    degrade every default-ledger read to the broadcast path."""
    driver = make_driver(rpool, client="dflt")
    q = Request("anyone", 150, {"type": GET_TXN, "data": 2})
    res = driver.read(q)
    assert res is not None, "default-ledger GET_TXN fell back"
    assert res[READ_PROOF]["kind"] == "merkle"
    assert driver.stats.single_reply_ok == 1
    assert driver.stats.fallbacks == 0


# --- observer-served verified reads (ingress/observer_reads.py) -----------

def _observer_pool(anchor_lag_max=None):
    """Fresh pool + registered observer + one committed NYM, with pushes
    routed. -> (pool, observer, user)."""
    from test_torch_ingress import attach_observer, run_routed
    pool = Pool()
    obs = attach_observer(pool, anchor_lag_max=anchor_lag_max)
    user = Ed25519Signer(seed=b"obs-reads-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    run_routed(pool, [obs], 6.0)
    assert obs.batches_applied >= 1
    return pool, obs, user


def make_observer_driver(pool, obs, client="odrv", freshness_s=FOREVER):
    """Two-tier driver: the observer rung first, validators as failover."""
    def submit(name, req):
        if name == obs.name:
            obs.handle_client_message(req.to_dict(), client)
        else:
            pool.nodes[name].handle_client_message(req.to_dict(), client)

    def collect(name):
        if name == obs.name:
            out = [m.result for m, _ in obs.sent if isinstance(m, Reply)]
            obs.sent.clear()
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
                         observer_names=[obs.name])


def test_observer_served_read_verifies_client_side():
    """An observer's reply carries a real proof at a VERIFIED BLS anchor;
    the client verifies it exactly like a validator's — consensus is
    never touched (fanout 1 request + 1 reply, all to the observer)."""
    pool, obs, user = _observer_pool()
    driver = make_observer_driver(pool, obs)
    q = Request("odrv", 10, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None
    assert res["data"]["verkey"] == user.verkey_b58
    assert res[READ_PROOF]["kind"] == "state"
    s = driver.stats
    assert s.observer_ok == 1 and s.single_reply_ok == 1
    assert s.msgs_sent == 1 and s.replies_seen == 1
    assert s.failovers == 0 and s.fallbacks == 0


def test_tampered_observer_envelope_fails_over_to_validator():
    """A lying/compromised observer forging proven values must fail
    CLOSED at the client and fail over to a validator rung."""
    pool, obs, user = _observer_pool()
    obs.gate.read_plane = LyingPlane(obs.gate.read_plane, _forge_value)
    driver = make_observer_driver(pool, obs)
    q = Request("odrv", 11, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None
    assert res["data"]["verkey"] == user.verkey_b58
    s = driver.stats
    assert s.verify_failures == 1 and s.failovers == 1
    assert s.observer_ok == 0 and s.single_reply_ok == 1
    assert s.fallbacks == 0


def test_stale_observer_replay_fails_over_to_validator():
    """An observer replaying a captured pre-rotation reply (honest sig,
    old anchor) is rejected by the client's freshness bound and the read
    fails over to a validator, which serves the ROTATED truth."""
    from test_torch_ingress import run_routed
    pool, obs, user = _observer_pool()
    captured = obs.gate.answer_batch(
        [Request("cap", 1, {"type": GET_NYM,
                            "dest": user.identifier})])[0]
    assert READ_PROOF in captured

    pool.run(12.0)                      # age the captured anchor
    rotated = Ed25519Signer(seed=b"obs-rotated".ljust(32, b"\0")[:32])
    upd = Request(pool.trustee.identifier, 2,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": rotated.verkey_b58})
    upd.signature = pool.trustee.sign_b58(upd.signing_bytes())
    pool.submit(upd)
    run_routed(pool, [obs], 6.0)

    obs.gate.read_plane = LyingPlane(
        obs.gate.read_plane,
        lambda result: dict(captured, identifier=result.get("identifier"),
                            reqId=result.get("reqId")))
    driver = make_observer_driver(pool, obs, freshness_s=8.0)
    q = Request("odrv", 12, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None
    assert res["data"]["verkey"] == rotated.verkey_b58
    assert driver.stats.verify_failures >= 1
    assert driver.stats.failovers >= 1
    assert driver.stats.observer_ok == 0


def test_observer_anchor_advances_with_traffic():
    """Each committed batch's pushed multi-sig advances the observer's
    serving anchor (verified, then adopted) — reads after a write see
    the NEW state under the NEW anchor."""
    from test_torch_ingress import run_routed
    pool, obs, user = _observer_pool()
    anchors_before = obs.gate.read_plane.stats["anchor_updates"]
    user2 = Ed25519Signer(seed=b"obs-reads-u2".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user2, req_id=2))
    run_routed(pool, [obs], 6.0)
    assert obs.gate.read_plane.stats["anchor_updates"] > anchors_before
    driver = make_observer_driver(pool, obs)
    q = Request("odrv", 13, {"type": GET_NYM, "dest": user2.identifier})
    res = driver.read(q)
    assert res is not None and res["data"]["verkey"] == user2.verkey_b58
    assert driver.stats.observer_ok == 1
