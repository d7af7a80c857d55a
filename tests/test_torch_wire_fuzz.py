"""The port's copy of tests/test_wire_fuzz.py, run on plenum_tpu_torch
(sim pools on the `cpu` backend).

Wire-protocol robustness fuzz: malformed, truncated, and random ingress
must never crash a node — malformed node traffic is dropped, malformed
client traffic is NACKed.

Reference test model: the message-validation suites over
messages/fields.py + validateNodeMsg (SURVEY.md §4 message validation).
"""
from __future__ import annotations

import random

import pytest

from plenum_tpu_torch.common.message_base import (MessageValidationError,
                                            message_from_dict)
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, PrePrepare
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer

from test_torch_pool import Pool, signed_nym

N_CASES = 300


def _mutate(rng: random.Random, d):
    """Randomly corrupt a wire dict."""
    d = dict(d)
    op = rng.randrange(5)
    keys = list(d)
    if op == 0 and keys:
        del d[rng.choice(keys)]
    elif op == 1 and keys:
        d[rng.choice(keys)] = rng.choice(
            [None, -1, 2**70, "x" * 50, [], {}, float("nan"), b"\xff"])
    elif op == 2:
        d["op"] = rng.choice(["", "NOPE", 42, None])
    elif op == 3 and keys:
        k = rng.choice(keys)
        d[str(k) + "_extra"] = d.pop(k)
    else:
        d[rng.choice(["view_no", "pp_seq_no", "inst_id"])] = rng.choice(
            [-(2**40), "str", [1, 2], None])
    return d


def test_message_from_dict_never_crashes_on_garbage():
    rng = random.Random(1234)
    base = PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.0,
                      req_idr=("d",), discarded=(), digest="x",
                      ledger_id=DOMAIN_LEDGER_ID, state_root="", txn_root="",
                      audit_txn_root="").to_dict()
    ok = 0
    for _ in range(N_CASES):
        d = _mutate(rng, base)
        try:
            message_from_dict(d)
            ok += 1
        except MessageValidationError:
            pass                     # the ONLY acceptable failure mode
    # some mutations still validate (extra-field tolerance etc.); most fail
    assert ok < N_CASES


def test_node_survives_garbage_node_traffic():
    rng = random.Random(99)
    pool = Pool()
    node = pool.nodes["Alpha"]
    base = PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.0,
                      req_idr=("d",), discarded=(), digest="x",
                      ledger_id=DOMAIN_LEDGER_ID, state_root="", txn_root="",
                      audit_txn_root="").to_dict()
    for i in range(N_CASES):
        d = _mutate(rng, base)
        try:
            wire = pack(d)
        except (TypeError, ValueError, OverflowError):
            continue    # not serializable (bytes keys, ints beyond uint64):
            # a real sender could not have produced these bytes either
        try:
            msg = message_from_dict(unpack(wire))
        except MessageValidationError:
            continue                 # the ONLY acceptable decode failure
        # decodable-but-weird messages reach the bus like real traffic
        node.node_bus.process_incoming(msg, rng.choice(pool.names[1:]))
        node.prod()
    # the storm (forged non-primary pre-prepares "from" every peer) gets
    # them all blacklisted — and the TTL must self-heal the isolation
    assert node.blacklister.blacklisted
    pool.timer.advance(130.0)            # past BLACKLIST_TTL
    user = Ed25519Signer(seed=b"fuzz-after".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(10.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes


def test_propagate_batch_roundtrips_and_rejects_garbage():
    """PropagateBatch (the per-tick propagate coalescing envelope) must
    survive pack/unpack/message_from_dict unchanged, and every mutation
    must fail ONLY with MessageValidationError."""
    from plenum_tpu_torch.common.node_messages import Propagate, PropagateBatch

    body = Propagate(request={"identifier": "A", "reqId": 1,
                              "operation": {"type": "1"}},
                     sender_client="cli-7").to_dict()
    base = PropagateBatch(
        votes=(("d" * 64, "cli-1"), ("e" * 64, None)),
        bodies=(body,)).to_dict()
    # clean round trip through the real wire path
    decoded = message_from_dict(unpack(pack(base)))
    assert isinstance(decoded, PropagateBatch)
    assert decoded.to_dict() == base
    assert decoded.votes[1][1] is None

    rng = random.Random(4242)
    ok = 0
    for _ in range(N_CASES):
        d = _mutate(rng, base)
        try:
            wire = pack(d)
        except (TypeError, ValueError, OverflowError):
            continue
        try:
            message_from_dict(unpack(wire))
            ok += 1
        except MessageValidationError:
            pass                     # the ONLY acceptable failure mode
    assert ok < N_CASES


def test_broadcast_call_sites_pack_once():
    """Guard against per-peer pack() regressions on broadcast paths: the
    node-stack outbox and the client-stack send_many must serialize a
    message ONCE no matter how many recipients it fans out to."""
    import inspect

    from plenum_tpu_torch.network import tcp_stack as ts

    # source-level: no pack( inside the per-peer fan-out loops
    src = inspect.getsource(ts.TcpStack._enqueue_send)
    loop_body = src.split("for peer in targets", 1)[1]
    assert "pack(" not in loop_body, \
        "TcpStack._enqueue_send re-packs per peer"
    prop_src = inspect.getsource(ts.ClientStack._send_packed)
    assert "pack(" not in prop_src, \
        "ClientStack._send_packed must take pre-packed bytes"

    # functional: ClientStack.send_many packs once for N live clients
    class _W:                                   # fake asyncio writer
        class _T:
            @staticmethod
            def get_write_buffer_size():
                return 0
        transport = _T()

        def __init__(self):
            self.wrote = []

        def write(self, data):
            self.wrote.append(data)

    stack = ts.ClientStack("N1", "127.0.0.1", 0, on_request=lambda m, f: None)
    for i in range(5):
        stack._conns[f"client-{i}"] = _W()
    calls = {"n": 0}
    real_pack = ts.pack

    def counting_pack(obj):
        calls["n"] += 1
        return real_pack(obj)

    ts.pack = counting_pack
    try:
        stack.send_many({"op": "REPLY", "result": {"x": 1}},
                        [f"client-{i}" for i in range(5)])
    finally:
        ts.pack = real_pack
    assert calls["n"] == 1, f"send_many packed {calls['n']}x for 5 clients"
    assert sum(len(w.wrote) for w in stack._conns.values()) == 5


def test_node_nacks_garbage_client_traffic():
    rng = random.Random(7)
    pool = Pool()
    node = pool.nodes["Alpha"]
    for i in range(100):
        junk = rng.choice([
            {}, {"op": "x"}, {"identifier": 1}, {"reqId": None},
            {"identifier": "A", "reqId": i, "operation": "notadict"},
            {"identifier": "A", "reqId": i, "operation": {"type": None}},
            {"identifier": None, "reqId": [], "operation": {}},
        ])
        node.handle_client_message(dict(junk), f"cli{i}")
        node.prod()
    from plenum_tpu_torch.common.node_messages import RequestNack
    assert pool.replies("Alpha", RequestNack)
    # and the node still serves real traffic
    user = Ed25519Signer(seed=b"fuzz-client".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(5.0)
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2


# --- proof-bearing REPLY envelope (verified read plane) -------------------

def _proof_bearing_result():
    """One committed NYM + a proof-enveloped GET_NYM result, plus the
    verification context (pool keys, sim clock)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    pool = Pool(seed=31)
    user = Ed25519Signer(seed=b"wirefuzz-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(6.0)
    q = Request("wf", 1, {"type": GET_NYM, "dest": user.identifier})
    result = pool.nodes["Alpha"].read_plane.answer(q)
    return pool, q, result, pool_bls_keys(pool.names)


def _corrupt_tree(rng: random.Random, obj):
    """One random structural corruption somewhere in a nested dict/list:
    drop a key, retype a value, truncate/flip a hex string, or splice in
    garbage. Returns a deep-copied corrupted twin."""
    import copy
    obj = copy.deepcopy(obj)

    def nodes(o, path=()):
        yield o, path
        if isinstance(o, dict):
            for k, v in o.items():
                yield from nodes(v, path + (k,))
        elif isinstance(o, list):
            for i, v in enumerate(o):
                yield from nodes(v, path + (i,))

    def set_at(o, path, value):
        for p in path[:-1]:
            o = o[p]
        o[path[-1]] = value

    def del_at(o, path):
        for p in path[:-1]:
            o = o[p]
        del o[path[-1]]

    candidates = [(n, p) for n, p in nodes(obj) if p]
    node, path = candidates[rng.randrange(len(candidates))]
    op = rng.randrange(4)
    if op == 0:
        del_at(obj, path)
    elif op == 1:
        set_at(obj, path, rng.choice(
            [None, -1, 2 ** 70, "zz", [], {}, True, b"\xff" * 4]))
    elif op == 2 and isinstance(node, str) and len(node) > 2:
        cut = rng.randrange(1, len(node))
        set_at(obj, path, node[:cut])            # truncation
    elif isinstance(node, str) and node:
        i = rng.randrange(len(node))
        repl = "0" if node[i] != "0" else "f"
        set_at(obj, path, node[:i] + repl + node[i + 1:])  # flip
    else:
        set_at(obj, path, "garbage")
    return obj


def _proof_bearing_result_verkle():
    """The Verkle twin of _proof_bearing_result: a pool whose domain
    state rides the wide-commitment backend, so the GET_NYM reply
    carries a ``verkle`` envelope (aggregated opening, no per-entry
    proof field)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    pool = Pool(seed=33, config=Config(Max3PCBatchWait=0.05,
                                       STATE_COMMITMENT="verkle",
                                       crypto_backend="cpu"))
    user = Ed25519Signer(seed=b"wirefuzz-vk-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(6.0)
    q = Request("wf", 1, {"type": GET_NYM, "dest": user.identifier})
    result = pool.nodes["Alpha"].read_plane.answer(q)
    return pool, q, result, pool_bls_keys(pool.names)


def test_verkle_envelope_roundtrips_and_fails_closed():
    """Same contract reads/proofs.py pins for MPT, for the new kind: the
    verkle envelope survives the wire roundtrip verbatim and STILL
    verifies; ~300 random corruptions of the envelope (or the result it
    binds) each verify False — never raise, never True unless the
    corruption was an exact no-op."""
    from plenum_tpu_torch.common.node_messages import Reply
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF, verify_read_proof

    pool, q, result, keys = _proof_bearing_result_verkle()
    now = pool.timer.get_current_time
    assert result[READ_PROOF]["kind"] == "verkle", \
        "verkle-backed pool served a non-verkle envelope"

    wire = unpack(pack(Reply(result=result).to_dict()))
    rt_result = wire["result"]
    ok, reason = verify_read_proof(GET_NYM, q.operation, rt_result, keys,
                                   freshness_s=1e12, now=now)
    assert ok, f"roundtrip broke verkle verification: {reason}"

    rng = random.Random(31337)
    verified = rejected = 0
    for _ in range(N_CASES):
        bad = _corrupt_tree(rng, rt_result)
        try:
            ok, reason = verify_read_proof(GET_NYM, q.operation, bad,
                                           keys, freshness_s=1e12,
                                           now=now)
        except Exception as e:           # pragma: no cover
            raise AssertionError(
                f"verify_read_proof raised {type(e).__name__} on "
                f"corrupted verkle envelope") from e
        if ok:
            assert bad.get(READ_PROOF) == rt_result.get(READ_PROOF) \
                and {k: v for k, v in bad.items()
                     if k not in ("identifier", "reqId")} \
                == {k: v for k, v in rt_result.items()
                    if k not in ("identifier", "reqId")}, \
                f"corrupted verkle envelope VERIFIED: {bad}"
            verified += 1
        else:
            rejected += 1
    assert rejected > N_CASES // 2       # most corruptions must reject


def test_read_proof_envelope_roundtrips_and_fails_closed():
    """The proof-bearing REPLY survives the wire roundtrip verbatim and
    STILL verifies; any corruption of the envelope (or of the result it
    binds) must verify False — never raise, and never verify unless the
    corruption was a no-op."""
    from plenum_tpu_torch.common.node_messages import Reply
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF, verify_read_proof

    pool, q, result, keys = _proof_bearing_result()
    now = pool.timer.get_current_time

    # wire roundtrip: pack -> unpack -> still verifies
    wire = unpack(pack(Reply(result=result).to_dict()))
    rt_result = wire["result"]
    ok, reason = verify_read_proof(GET_NYM, q.operation, rt_result, keys,
                                   freshness_s=1e12, now=now)
    assert ok, f"roundtrip broke verification: {reason}"

    rng = random.Random(4242)
    verified = rejected = 0
    for _ in range(N_CASES):
        bad = _corrupt_tree(rng, rt_result)
        try:
            ok, reason = verify_read_proof(GET_NYM, q.operation, bad,
                                           keys, freshness_s=1e12,
                                           now=now)
        except Exception as e:           # pragma: no cover
            raise AssertionError(
                f"verify_read_proof raised {type(e).__name__} on "
                f"corrupted envelope") from e
        if ok:
            # only acceptable when the corruption didn't change anything
            # the verifier reads (e.g. a legacy state_proof field)
            assert bad.get(READ_PROOF) == rt_result.get(READ_PROOF) \
                and {k: v for k, v in bad.items()
                     if k not in ("identifier", "reqId")} \
                == {k: v for k, v in rt_result.items()
                    if k not in ("identifier", "reqId")}, \
                f"corrupted envelope VERIFIED: {bad}"
            verified += 1
        else:
            rejected += 1
    assert rejected > N_CASES // 2       # most corruptions must reject
