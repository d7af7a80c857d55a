"""What the tcpsvc cell reads from the port, on the CPU: the `transport`
layer of a node's TCP stacks, the host-span sessions a node serves on
request (tools/start_node.py), the crypto host's counters and `svc`
spans read through its `stats` request, a stopped node's durable stores
read back for the plain reference, and the Ed25519 roofline's arithmetic.
No test here starts a process: the nodes run in this one, on one loop."""
import asyncio
import json
import os
import signal
import threading
import time

import pytest

from plenum_tpu_torch.common import host_spans as hs
from plenum_tpu_torch.common.host_spans import HostSpans

pytest.importorskip("cryptography",
                    reason="the node stack's handshake needs cryptography")

NAMES = ["Node1", "Node2", "Node3", "Node4"]
TRUSTEE = b"tcpsvc-test-trustee".ljust(32, b"\0")
SEED = 11


def _closes(session) -> bool:
    """Every self second of a top-level span belongs to one layer."""
    return sum(session["self_s"].values()) == pytest.approx(
        session["top_s"], rel=1e-9)


# --- the transport layer -------------------------------------------------


def test_the_transport_layer_closes_with_the_other_layers():
    from plenum_tpu_torch.common.node_messages import InstanceChange
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.network.tcp_stack import NodeRegistry, TcpStack

    seeds = {n: n.encode().ljust(32, b"\0") for n in ("A", "B")}
    reg = NodeRegistry()
    stacks, recs = {}, {}
    for n in ("A", "B"):
        stacks[n] = TcpStack(n, "127.0.0.1", 0, reg, seed=seeds[n])
        recs[n] = HostSpans()

        class _Client:                    # the client stack's write site
            def _send_packed(self, data, cid):
                pass
        hs._span_transport(recs[n], stacks[n], _Client(), 0)
    got = []
    stacks["B"].bus.subscribe(InstanceChange,
                              lambda m, frm: got.append((m, frm)))

    async def run():
        for n in ("A", "B"):
            port = await stacks[n].bind()
            reg.set(n, "127.0.0.1", port, Ed25519Signer(seeds[n]).verkey)
        for n in ("A", "B"):
            stacks[n].maintain_connections()
        deadline = time.perf_counter() + 10
        while len(stacks["A"].connected) < 1:
            assert time.perf_counter() < deadline
            await asyncio.sleep(0.01)
        for rec in recs.values():
            rec.enable()
        msg = InstanceChange(view_no=1, reason=25)
        for _ in range(20):
            stacks["A"].bus.send(msg, "B")
            await asyncio.sleep(0.005)
            stacks["B"].drain()
        for rec in recs.values():
            rec.disable()
        for s in stacks.values():
            await s.stop()

    asyncio.run(run())
    assert len(got) == 20
    a, b = recs["A"].session(), recs["B"].session()
    # A queued, packed, sealed and wrote; B opened what it received
    assert a["spans"]["transport"] >= 40 and a["self_s"]["transport"] > 0
    assert b["spans"]["transport"] >= 20 and b["self_s"]["transport"] > 0
    for s in (a, b):
        assert _closes(s)
        assert s["dropped"] == 0


def test_the_client_port_seals_the_connections_that_ask():
    """A client that opens with the handshake gets sealed frames both
    ways, under the node's key, and their sealing and opening is the
    `transport` layer's; a client of the plaintext framing is still
    served; a client that expects another node's key, or a tampered
    frame, ends its connection."""
    from plenum_tpu_torch.common.serialization import pack, unpack
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.network.sealed_client import (SealedClientStack,
                                                        connect_sealed)
    from plenum_tpu_torch.network.tcp_stack import HandshakeError

    seed = b"N1".ljust(32, b"\0")
    stack = SealedClientStack("N1", "127.0.0.1", 0, on_request=None,
                              seed=seed)
    assert stack.verkey == Ed25519Signer(seed).verkey
    seen = []
    stack._on_request = lambda msg, cid: seen.append((msg, cid))
    rec = HostSpans()

    class _Node:                          # the node stack's sites
        class bus:
            _send_handler = None
        _flush = _install_session = None
    hs._span_transport(rec, _Node(), stack, 0)

    async def until(cond):
        deadline = time.perf_counter() + 5
        while not cond():
            assert time.perf_counter() < deadline
            stack.drain()
            await asyncio.sleep(0.01)

    async def run():
        port = await stack.bind()
        rec.enable()
        conn = await connect_sealed("127.0.0.1", port, stack.verkey)
        conn.send_packed(pack({"op": "SEALED", "i": 1}))
        await until(lambda: len(seen) == 1)
        msg, cid = seen[0]
        assert msg == {"op": "SEALED", "i": 1}
        stack.send({"op": "REPLY", "to": "sealed"}, cid)
        assert unpack(await conn.recv()) == {"op": "REPLY", "to": "sealed"}
        rec.disable()
        # the plaintext framing
        r, w = await asyncio.open_connection("127.0.0.1", port)
        data = pack({"op": "PLAIN"})
        w.write(len(data).to_bytes(4, "big") + data)
        await until(lambda: len(seen) == 2)
        stack.send({"op": "REPLY", "to": "plain"}, seen[1][1])
        n = int.from_bytes(await r.readexactly(4), "big")
        assert unpack(await r.readexactly(n)) == {"op": "REPLY",
                                                  "to": "plain"}
        w.close()
        # another node's key
        with pytest.raises(HandshakeError):
            await connect_sealed("127.0.0.1", port, bytes(32))
        # a tampered frame: the node drops the connection unread
        frame = bytearray(conn._sess.encrypt_frame(pack({"op": "X"})))
        frame[-1] ^= 1
        conn.writer.write(bytes(frame))
        assert await conn.reader.read() == b""
        await until(lambda: not stack._conns)
        assert len(seen) == 2
        await stack.stop()

    asyncio.run(run())
    s = rec.session()
    # one frame opened, one sealed and written, inside the session
    assert s["spans"]["transport"] == 2 and s["self_s"]["transport"] > 0
    assert _closes(s)


# --- a pool of node processes' stacks, on one loop -------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Four nodes as start_node builds them (`--kv file`, `--backend
    cpu`) on one loop, each serving host-span sessions on its own
    recorder; Node1 by the real signals. Six trustee NYMs, one spoiled,
    through the client ports inside a session. -> what it left."""
    from port_bench.traffic import corpus
    from port_bench.traffic.tcp_closed import Loop, _node_verkeys
    from plenum_tpu_torch.node.looper import Looper
    from plenum_tpu_torch.tools.start_node import build_node
    from plenum_tpu_torch.tools.tcp_pool import setup_pool_dir

    base = str(tmp_path_factory.mktemp("tcpsvc"))
    setup_pool_dir(base, NAMES, TRUSTEE)
    reqs = corpus.pool_slice(SEED, TRUSTEE, 0, 7, frozenset({4}))
    by_digest = {d: i for i, (_, d, _) in enumerate(reqs)}
    built, requests, recs = {}, {}, {}
    old = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGUSR2)}
    try:
        for name in NAMES:
            prodable, node, _ = build_node(name, base, backend="cpu",
                                           kv="file")
            recs[name] = HostSpans()
            requests[name] = hs.serve_sessions(
                prodable, os.path.join(base, name, "host_spans.json"),
                rec=recs[name],
                signals=None if name != "Node1" else (signal.SIGUSR1,
                                                      signal.SIGUSR2))
            built[name] = (prodable, node)
        looper = Looper()
        for prodable, _ in built.values():
            looper.add(prodable)

        async def run():
            async with looper:
                ports = {n: p.client_stack.port
                         for n, (p, _) in built.items()}
                loop = Loop(ports, _node_verkeys(base), reqs, by_digest,
                            quorum=2)
                await loop.connect()
                os.kill(os.getpid(), signal.SIGUSR1)
                for name in NAMES[1:]:
                    requests[name](True)
                await asyncio.sleep(0.05)
                for i in range(6):
                    loop.send(i)
                await loop.flush()
                deadline = time.perf_counter() + 60
                while not loop.all_answered():
                    assert time.perf_counter() < deadline, loop.answered
                    await loop.wait(0.2)
                os.kill(os.getpid(), signal.SIGUSR2)
                for name in NAMES[1:]:
                    requests[name](False)
                paths = [os.path.join(base, n, "host_spans.json")
                         for n in NAMES]
                while not all(os.path.exists(p) for p in paths):
                    assert time.perf_counter() < deadline
                    await asyncio.sleep(0.02)
                await loop.close()
                return loop
        loop = asyncio.run(run())
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        for _, node in built.values():
            node.c.db.close()
    sessions = {}
    for name in NAMES:
        with open(os.path.join(base, name, "host_spans.json")) as fh:
            sessions[name] = json.load(fh)
    return {"base": base, "reqs": reqs, "loop": loop, "sessions": sessions}


def test_a_node_ships_its_session_on_request(pool):
    for name, s in pool["sessions"].items():
        assert s["node"] == name and not s["open"]
        assert s["batches"] >= 1, s
        assert s["txns"] == 5, s                  # five valid NYMs
        assert s["seconds"] > 0
        # auth and serde are direct spans of the process's one RECORDER,
        # which a node process serves; here each node has its own
        for layer in ("loop", "node", "threepc", "bls", "execution",
                      "durable", "transport"):
            assert s["self_s"][layer] > 0, (name, layer)
        assert s["self_s"]["svc"] == 0 and s["dropped"] == 0
        assert _closes(s)


def test_the_stores_read_back_feed_the_reference(pool):
    from port_bench import stores
    from port_bench.reference import pool_check
    from port_bench.traffic import corpus
    loop = pool["loop"]
    outputs = {n: stores.read_domain(pool["base"], n) for n in NAMES}
    assert all(len(o["leaves"]) == 6 for o in outputs.values())
    judge = dict(reqs=pool["reqs"], sent=loop.sent,
                 answer=loop.answers.answer, trustee_vk=corpus.verkey_of(
                     TRUSTEE), seed=SEED, sample=4, genesis_txns=1)
    checks = pool_check.judge(outputs=outputs, **judge)
    assert set(checks.values()) == {0}, checks
    assert sum(a[0] == "nack" for a in loop.answers.answer.values()) == 1
    # a state root changed in one node's store
    stores.write_state_root(pool["base"], "Node4", b"\x11" * 32)
    outputs["Node4"] = stores.read_domain(pool["base"], "Node4")
    assert pool_check.judge(outputs=outputs, **judge)["state_mismatch"] == 1


# --- the crypto host's counters -------------------------------------------


class _Stub:
    """An inner verifier whose dispatch holds the worker `delay` seconds
    and accepts all."""

    def __init__(self, delay):
        self.delay, self.calls = delay, []

    def submit_batch(self, items):
        self.calls.append(len(items))
        time.sleep(self.delay)
        return len(items)

    def collect_batch(self, token, wait=True):
        return [True] * token


def test_the_crypto_hosts_counters_and_spans_read_through_stats(
        tmp_path, monkeypatch):
    import numpy as np

    from plenum_tpu_torch.parallel import crypto_service as cs
    rec = HostSpans()
    monkeypatch.setattr(cs, "_SPANS", rec)
    sock = str(tmp_path / "c.sock")
    stub = _Stub(0.05)
    server = cs.CryptoPlaneServer(stub, socket_path=sock)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def serve():
        await server.start()
        started.set()
        while not server._stop.is_set():
            await asyncio.sleep(0.02)
        await server.stop()
    t = threading.Thread(target=lambda: loop.run_until_complete(serve()),
                         daemon=True)
    t.start()
    assert started.wait(5.0)
    clients = [cs.ServiceEd25519Verifier(socket_path=sock) for _ in range(4)]
    try:
        rec.enable()
        a = [(b"a%d" % i, bytes(64), bytes(32)) for i in range(10)]
        b = [(b"b%d" % i, bytes(64), bytes([i % 2]) * 32)
             for i in range(10)]
        # the first batch holds the worker 50 ms in its dispatch; the
        # other three wait in the queue, then the ten new items go out
        # as one wave
        tokens = [clients[0].submit_batch(a)]
        time.sleep(0.01)
        tokens += [clients[1].submit_batch(b), clients[2].submit_batch(a),
                   clients[3].submit_batch(a)]
        for c, tok in zip(clients, tokens):
            assert np.asarray(c.collect_batch(tok)).all()
        # then once more from one node: all ten from the cache
        assert np.asarray(clients[0].verify_batch(a)).all()
        rec.disable()
        got = clients[0].stats()
    finally:
        for c in clients:
            c.close()
        server._stop.set()
        t.join(timeout=5.0)
    assert got["queued_jobs"] == 5
    # three jobs waited on the first's 50 ms dispatch
    assert got["queue_wait_s"] > 3 * 0.03
    assert got["items"] == 50 and stub.calls == [10, 10]
    assert got["dispatched_items"] / got["dispatches"] == 10
    # a's one key, then b's two
    assert got["dispatched_keys"] == 3
    # the first wave lands before the worker takes the queued jobs: both
    # copies of its batch, and the last, come from the cache
    assert got["cache_hits"] == 30
    s = rec.session()
    assert s["spans"]["svc"] >= 5 and s["self_s"]["svc"] > 0
    assert _closes(s)


# --- the Ed25519 roofline --------------------------------------------------


def test_the_roofline_counts_rfc_8032s_work():
    from port_bench import roofline as r
    assert r.SIG_PRODUCTS == 1694 * 64 + 1270 * 36 == 154_136
    assert r.KEY_PRODUCTS == 19 * 64 + 255 * 36 == 10_396
    assert r.PEAK_PRODUCTS_S == pytest.approx(1.673e13, rel=1e-3)
    assert r.ed25519_bytes(100, 1) == 101 * 100 + 32
    # 1,000 signatures of one key: compute bound, 9.21 us at the peak
    floor, by = r.ed25519_floor_s(1000, 1)
    assert by == "compute"
    assert floor == pytest.approx((154_136_000 + 10_396)
                                  / (132 * 1.98e9 * 64))
    assert floor == pytest.approx(9.215e-6, rel=1e-3)
    assert r.ed25519_roofline_percent(1000, 1, 2 * floor) == \
        pytest.approx(50.0)
    assert r.ed25519_roofline_percent(0, 0, 1.0) is None
    assert r.ed25519_roofline_percent(10, 1, 0.0) is None
    names = {"k_ed25519_decompress(unsigned char const*, int)": 1e-3,
             "k_ed25519_verify(unsigned char const*, int)": 2e-3,
             "k_ed25519_verify_staged(int)": 4e-3,
             "Memcpy HtoD (Pageable -> Device)": 8e-3}
    assert r.kernel_seconds(names) == pytest.approx(3e-3)
