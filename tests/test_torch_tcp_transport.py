"""The port's copy of tests/test_tcp_transport.py, run on plenum_tpu_torch,
and the port's TCP stack held against the reference's.

Real-socket transport tests: handshake, allowlist, batching, reconnect,
and a full 4-node pool ordering a NYM over localhost TCP (nodes on the
`cpu` backend). Across the packages: a port stack and a reference stack
complete the handshake with either package dialling and exchange batched
frames; a pool of two reference nodes and two port nodes (one of them on
the kernels' plain versions, backend `torch`) orders NYMs over real
sockets with equal domain, audit and state roots on every node.

Reference test model: stp_zmq tests (connect/auth) + the pool e2e NYM flow
(SURVEY.md §4). Everything runs in one asyncio loop — real sockets, no OS
process per node.
"""
from __future__ import annotations

import asyncio
import hashlib
import time

import pytest

pytest.importorskip(
    "cryptography",
    reason="the TCP node stack's handshake needs the cryptography package")

from plenum_tpu_torch.common.node_messages import InstanceChange
from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.network.tcp_stack import ClientStack, NodeRegistry, TcpStack


def _seed(name: str) -> bytes:
    return hashlib.sha256(b"tcp-test-" + name.encode()).digest()


def _vk(seed: bytes) -> bytes:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey)
    sk = Ed25519PrivateKey.from_private_bytes(seed)
    return sk.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)


async def _make_pair(names=("Alpha", "Beta")):
    reg = NodeRegistry()
    stacks = {}
    for n in names:
        stacks[n] = TcpStack(n, "127.0.0.1", 0, reg, _seed(n))
        port = await stacks[n].bind()
        reg.set(n, "127.0.0.1", port, stacks[n].verkey)
    for n in names:
        await stacks[n].start()
    return reg, stacks


async def _wait(cond, timeout=5.0, interval=0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return cond()


def test_handshake_and_message_roundtrip():
    async def main():
        reg, stacks = await _make_pair()
        a, b = stacks["Alpha"], stacks["Beta"]
        assert await _wait(lambda: a.connected == {"Beta"}
                           and b.connected == {"Alpha"})

        got = []
        b.bus.subscribe(InstanceChange,
                        lambda msg, frm: got.append((msg, frm)))
        a.bus.send(InstanceChange(view_no=3, reason=0), "Beta")
        assert await _wait(lambda: b.drain() + len(got) and got)
        msg, frm = got[0]
        assert isinstance(msg, InstanceChange) and msg.view_no == 3
        assert frm == "Alpha"

        # and the reverse direction (acceptor -> dialer)
        got_a = []
        a.bus.subscribe(InstanceChange,
                        lambda msg, frm: got_a.append((msg, frm)))
        b.bus.send(InstanceChange(view_no=7, reason=0), "Alpha")
        assert await _wait(lambda: a.drain() + len(got_a) and got_a)
        assert got_a[0][0].view_no == 7 and got_a[0][1] == "Beta"

        # Connected events reached the bus subscribers
        assert a.bus.connecteds == {"Beta"}
        await a.stop()
        await b.stop()

    asyncio.run(main())


def test_allowlist_rejects_unknown_verkey():
    async def main():
        reg, stacks = await _make_pair()
        a, b = stacks["Alpha"], stacks["Beta"]
        assert await _wait(lambda: a.connected == {"Beta"})

        # an impostor dialing Beta with a key not in the registry: the
        # acceptor must refuse (ZAP allowlist, zstack.py:322)
        evil_reg = NodeRegistry()
        evil_reg.set("Beta", "127.0.0.1", b.port, b.verkey)
        evil = TcpStack("AAAevil", "127.0.0.1", 0, evil_reg,
                        _seed("not-in-registry"))
        await evil.bind()
        evil.maintain_connections()
        await asyncio.sleep(0.5)
        assert evil.connected == set()
        assert b.stats["rejected"] >= 1
        assert b.connected == {"Alpha"}      # honest session unaffected
        await evil.stop()
        await a.stop()
        await b.stop()

    asyncio.run(main())


def test_outbox_batching_one_frame_per_flush():
    async def main():
        reg, stacks = await _make_pair()
        a, b = stacks["Alpha"], stacks["Beta"]
        assert await _wait(lambda: a.connected == {"Beta"})
        base = a.stats["sent_frames"]
        got = []
        b.bus.subscribe(InstanceChange, lambda m, f: got.append(m))
        for v in range(50):
            a.bus.send(InstanceChange(view_no=v, reason=0), "Beta")
        assert await _wait(lambda: (b.drain(), len(got))[1] >= 50)
        # 50 messages coalesced into one encrypted frame (batched.py:20)
        assert a.stats["sent_frames"] == base + 1
        assert [m.view_no for m in got] == list(range(50))
        await a.stop()
        await b.stop()

    asyncio.run(main())


def test_queued_outbox_flushes_after_reconnect():
    async def main():
        reg = NodeRegistry()
        a = TcpStack("Alpha", "127.0.0.1", 0, reg, _seed("Alpha"))
        await a.bind()
        reg.set("Alpha", "127.0.0.1", a.port, a.verkey)
        # Beta is registered but not yet listening: messages queue
        beta_seed = _seed("Beta")
        reg.set("Beta", "127.0.0.1", 1, _vk(beta_seed))  # dead port
        await a.start()
        a.bus.send(InstanceChange(view_no=9, reason=0), "Beta")
        await asyncio.sleep(0.3)
        assert a.connected == set()

        # now Beta comes up on a real port; update registry; dialer retries
        b = TcpStack("Beta", "127.0.0.1", 0, reg, beta_seed)
        port = await b.bind()
        reg.set("Beta", "127.0.0.1", port, b.verkey)
        await b.start()
        got = []
        b.bus.subscribe(InstanceChange, lambda m, f: got.append(m))
        assert await _wait(lambda: (b.drain(), len(got))[1] >= 1, timeout=8.0)
        assert got[0].view_no == 9           # queued message survived
        await a.stop()
        await b.stop()

    asyncio.run(main())


def test_session_supersede_on_peer_restart():
    async def main():
        reg, stacks = await _make_pair()
        a, b = stacks["Alpha"], stacks["Beta"]
        assert await _wait(lambda: a.connected == {"Beta"})
        b_port = b.port
        await b.stop()
        assert await _wait(lambda: a.connected == set(), timeout=5.0)

        # Beta restarts on the SAME port with the same identity
        b2 = TcpStack("Beta", "127.0.0.1", b_port, reg, _seed("Beta"))
        await b2.start()
        assert await _wait(lambda: a.connected == {"Beta"}
                           and b2.connected == {"Alpha"}, timeout=8.0)
        got = []
        b2.bus.subscribe(InstanceChange, lambda m, f: got.append(m))
        a.bus.send(InstanceChange(view_no=4, reason=0), "Beta")
        assert await _wait(lambda: (b2.drain(), len(got))[1] >= 1)
        await a.stop()
        await b2.stop()

    asyncio.run(main())


# --- full pool over real sockets -----------------------------------------

def _build_tcp_pool(n_nodes=4):
    """Nodes + TCP stacks + client stacks in one loop; returns the parts."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.timer import QueueTimer
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.node import Node, NodeBootstrap
    from plenum_tpu_torch.node.looper import Looper, Prodable
    from plenum_tpu_torch.tools.local_pool import build_genesis

    names = [f"Node{i + 1}" for i in range(n_nodes)]
    genesis, trustee = build_genesis(names)
    reg = NodeRegistry()
    config = Config(Max3PCBatchWait=0.005,
                    STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
                    crypto_backend="cpu")
    looper = Looper(prod_interval=0.002)
    nodes, node_stacks, client_stacks = {}, {}, {}

    async def setup():
        for name in names:
            stack = TcpStack(name, "127.0.0.1", 0, reg, _seed(name))
            await stack.bind()
            reg.set(name, "127.0.0.1", stack.port, stack.verkey)
            node_stacks[name] = stack
        for name in names:
            components = NodeBootstrap(name, genesis_txns=genesis,
                                       crypto_backend="cpu").build()
            timer = QueueTimer(time.perf_counter)
            cstack = ClientStack(name, "127.0.0.1", 0, on_request=None)
            node = Node(name, timer, node_stacks[name].bus, components,
                        client_send=cstack.send, config=config)
            cstack._on_request = node.handle_client_message
            nodes[name] = node
            client_stacks[name] = cstack
            looper.add(Prodable(node, node_stacks[name], cstack, timer))

    return names, reg, looper, nodes, client_stacks, setup, trustee


@pytest.mark.slow
def test_pool_orders_nym_over_tcp():
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM

    (names, reg, looper, nodes, client_stacks,
     setup, trustee) = _build_tcp_pool()

    async def main():
        await setup()
        async with looper:
            # all nodes fully meshed
            ok = await looper.run_until(
                lambda: all(len(n.node_bus.connecteds) == 3
                            for n in nodes.values()), timeout=10.0)
            assert ok, "pool never meshed over TCP"

            # a real TCP client submits a signed NYM to every node
            user = Ed25519Signer(seed=b"tcp-pool-user".ljust(32, b"\0"))
            req = Request(trustee.identifier, 1,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            req.signature = trustee.sign_b58(req.signing_bytes())
            replies = []

            async def submit(name):
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", client_stacks[name].port)
                data = pack(req.to_dict())
                writer.write(len(data).to_bytes(4, "big") + data)
                await writer.drain()
                try:
                    while True:
                        hdr = await asyncio.wait_for(
                            reader.readexactly(4), timeout=15.0)
                        frame = await reader.readexactly(
                            int.from_bytes(hdr, "big"))
                        msg = unpack(frame)
                        replies.append(msg)
                        if msg.get("op") == "REPLY":
                            break
                except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                    pass
                writer.close()

            await asyncio.gather(*(submit(n) for n in names))
            assert any(m.get("op") == "REPLY" for m in replies), replies

            sizes = {nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                     for n in names}
            assert sizes == {2}, sizes       # genesis NYM + the new one

    asyncio.run(main())


@pytest.mark.slow
def test_primary_crash_recovers_within_disconnect_timeout():
    """Kill the primary (stop prodding + close its sockets): survivors see
    the TCP disconnect, vote PRIMARY_DISCONNECTED after
    PRIMARY_DISCONNECT_TIMEOUT, complete a view change, and order a
    pending NYM — with the stall/freshness watchdogs configured far too
    slow (600s) to be the cause (ref primary_connection_monitor_service)."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM

    (names, reg, looper, nodes, client_stacks,
     setup, trustee) = _build_tcp_pool()

    async def main():
        await setup()
        # only the disconnect fast path may fire inside this test's window
        for node in nodes.values():
            node.config.PRIMARY_DISCONNECT_TIMEOUT = 2.0
            node.config.ORDERING_PROGRESS_TIMEOUT = 600.0
            node.config.STATE_FRESHNESS_UPDATE_INTERVAL = 600.0
        async with looper:
            ok = await looper.run_until(
                lambda: all(len(n.node_bus.connecteds) == 3
                            for n in nodes.values()), timeout=10.0)
            assert ok, "pool never meshed over TCP"

            primary = nodes[names[0]].master_replica.data.primary_name
            survivors = [n for n in names if n != primary]
            victim = next(p for p in looper._prodables
                          if p.node is nodes[primary])
            victim.prod = lambda: 0          # the process is "dead"
            await victim.stop()              # sockets close underneath peers

            user = Ed25519Signer(seed=b"tcp-crash-user".ljust(32, b"\0"))
            req = Request(trustee.identifier, 1,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            req.signature = trustee.sign_b58(req.signing_bytes())

            async def submit(name):
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", client_stacks[name].port)
                data = pack(req.to_dict())
                writer.write(len(data).to_bytes(4, "big") + data)
                await writer.drain()
                writer.close()

            await asyncio.gather(*(submit(n) for n in survivors))
            t0 = time.perf_counter()
            ok = await looper.run_until(
                lambda: all(
                    nodes[n].master_replica.view_no >= 1
                    and nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 2
                    for n in survivors),
                timeout=25.0)
            elapsed = time.perf_counter() - t0
            for n in survivors:
                assert nodes[n].master_replica.view_no >= 1, \
                    f"{n} never left view 0 (after {elapsed:.1f}s)"
                assert nodes[n].c.db.get_ledger(
                    DOMAIN_LEDGER_ID).size == 2, f"{n} did not order"
            # sanity: recovery rode the 2s disconnect vote, not the 600s
            # watchdogs (generous bound for slow CI)
            assert elapsed < 25.0

    asyncio.run(main())


def test_client_connection_flood_is_bounded():
    """Client-stack connection budget (ref plenum/config.py:285-292):
    a connection flood is capped at max_connections with the overflow
    rejected; sweeping reclaims slots from idle connections so live
    clients still get served after the flood."""
    import time as _time

    async def scenario():
        stack = ClientStack("srv", "127.0.0.1", 0, on_request=None,
                            max_connections=8, idle_timeout=0.5)
        seen = []
        stack._on_request = lambda msg, cid: seen.append((msg, cid))
        port = await stack.bind()

        # flood: 30 connections, each sending one frame to prove liveness
        floods = []
        for i in range(30):
            try:
                r, w = await asyncio.open_connection("127.0.0.1", port)
                from plenum_tpu_torch.common.serialization import pack
                payload = pack({"op": "NOOP", "i": i})
                w.write(len(payload).to_bytes(4, "big") + payload)
                await w.drain()
                floods.append((r, w))
            except OSError:
                pass
        await asyncio.sleep(0.3)
        assert len(stack._conns) <= 8            # bounded, not 30
        assert stack.rejected_connections >= 20

        # flood connections go idle; a NEW client connects after the
        # idle window and must be admitted via the sweep
        await asyncio.sleep(0.6)
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        from plenum_tpu_torch.common.serialization import pack as _pack
        payload = _pack({"op": "LIVE"})
        w2.write(len(payload).to_bytes(4, "big") + payload)
        await w2.drain()
        await asyncio.sleep(0.3)
        stack.drain()
        assert any(m.get("op") == "LIVE" for m, _ in seen)
        assert len(stack._conns) <= 8

        for _, w in floods:
            try:
                w.close()
            except Exception:
                pass
        w2.close()
        await stack.stop()

    asyncio.run(scenario())


# --- the port's stack against the reference's ------------------------------

def _cross_pair_messages(pkg):
    """One of each message type the round trips above check, and a few of
    the consensus path's, from `pkg`'s node_messages."""
    m = pkg
    return [m.InstanceChange(view_no=v, reason=0) for v in range(20)] + [
        m.PrePrepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.5,
                     req_idr=("d" * 64,), discarded=(), digest="x" * 64,
                     ledger_id=1, state_root="s", txn_root="t",
                     audit_txn_root="a"),
        m.Prepare(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.5,
                  digest="x" * 64, state_root="s", txn_root="t",
                  audit_txn_root="a"),
        m.Commit(inst_id=0, view_no=0, pp_seq_no=1),
        m.PropagateBatch(votes=(("d" * 64, "cli-1"), ("e" * 64, None)),
                         bodies=())]


@pytest.mark.parametrize("dialler", ["port", "reference"])
def test_port_and_reference_stacks_handshake_and_batch(dialler):
    """The dialler is the stack whose name sorts first: each package dials
    once across the parametrisation. Both directions carry one batched
    frame of every message, decoded by the receiver's own package to the
    sender's dicts."""
    from plenum_tpu.common import node_messages as ref_msgs
    from plenum_tpu.network import tcp_stack as ref_tcp
    from plenum_tpu_torch.common import node_messages as port_msgs

    async def main():
        port_name, ref_name = (("Alpha", "Beta") if dialler == "port"
                               else ("Beta", "Alpha"))
        port_reg, ref_reg = NodeRegistry(), ref_tcp.NodeRegistry()
        ours = TcpStack(port_name, "127.0.0.1", 0, port_reg, _seed(port_name))
        theirs = ref_tcp.TcpStack(ref_name, "127.0.0.1", 0, ref_reg,
                                  _seed(ref_name))
        for stack in (ours, theirs):
            await stack.bind()
            for reg in (port_reg, ref_reg):
                reg.set(stack.name, "127.0.0.1", stack.port, stack.verkey)
        await ours.start()
        await theirs.start()
        try:
            assert await _wait(lambda: ours.connected == {ref_name}
                               and theirs.connected == {port_name})
            for src_stack, dst_stack, pkg, dst_pkg in (
                    (ours, theirs, port_msgs, ref_msgs),
                    (theirs, ours, ref_msgs, port_msgs)):
                sent = _cross_pair_messages(pkg)
                got = []
                for cls in {type(m).__name__ for m in sent}:
                    dst_stack.bus.subscribe(
                        getattr(dst_pkg, cls),
                        lambda msg, frm: got.append((msg, frm)))
                base = src_stack.stats["sent_frames"]
                for msg in sent:
                    src_stack.bus.send(msg, dst_stack.name)
                assert await _wait(
                    lambda: (dst_stack.drain(), len(got))[1] >= len(sent))
                assert src_stack.stats["sent_frames"] == base + 1
                assert all(frm == src_stack.name for _, frm in got)
                assert all(type(g).__module__.startswith(
                    dst_pkg.__name__.split(".")[0] + ".") for g, _ in got)
                assert sorted(repr(g.to_dict()) for g, _ in got) == \
                    sorted(repr(m.to_dict()) for m in sent)
        finally:
            await ours.stop()
            await theirs.stop()

    asyncio.run(main())


def test_mixed_reference_and_port_pool_orders_with_equal_roots():
    """Node1-2 from plenum_tpu, Node3-4 from plenum_tpu_torch (Node4 on
    the kernels' plain versions), one event loop, real sockets; a TCP
    client sends each NYM to every node. Every node orders them, and the
    domain, audit and state roots agree across the packages."""
    import torch

    from plenum_tpu import node as ref_node
    from plenum_tpu.common.timer import QueueTimer as RefQueueTimer
    from plenum_tpu.config import Config as RefConfig
    from plenum_tpu.network import tcp_stack as ref_tcp
    from plenum_tpu.node import looper as ref_looper
    from plenum_tpu.tools.local_pool import build_genesis as ref_genesis
    from plenum_tpu_torch import node as port_node
    from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                       DOMAIN_LEDGER_ID)
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.timer import QueueTimer
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.node.looper import Looper, Prodable
    from plenum_tpu_torch.tools.local_pool import build_genesis

    names = ["Node1", "Node2", "Node3", "Node4"]
    genesis, trustee = build_genesis(names)
    assert ref_genesis(names)[0] == genesis
    backend = {"Node1": "cpu", "Node2": "cpu", "Node3": "cpu",
               "Node4": "torch"}
    ref_side = {"Node1", "Node2"}
    regs = (NodeRegistry(), ref_tcp.NodeRegistry())
    looper = Looper(prod_interval=0.002)
    nodes, client_ports = {}, {}
    n_nyms = 3
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    async def main():
        stacks = {}
        for name in names:
            tcp = ref_tcp if name in ref_side else None
            reg = regs[1] if tcp else regs[0]
            stacks[name] = (tcp.TcpStack if tcp else TcpStack)(
                name, "127.0.0.1", 0, reg, _seed(name))
            await stacks[name].bind()
            for r in regs:
                r.set(name, "127.0.0.1", stacks[name].port,
                      stacks[name].verkey)
        for name in names:
            ref = name in ref_side
            pkg, cfg = (ref_node, RefConfig) if ref else (port_node, Config)
            components = pkg.NodeBootstrap(
                name, genesis_txns=genesis,
                crypto_backend=backend[name]).build()
            timer = (RefQueueTimer if ref else QueueTimer)(time.perf_counter)
            cstack = (ref_tcp.ClientStack if ref else ClientStack)(
                name, "127.0.0.1", 0, on_request=None)
            node = pkg.Node(name, timer, stacks[name].bus, components,
                            client_send=cstack.send,
                            config=cfg(Max3PCBatchWait=0.005,
                                       STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
                                       crypto_backend=backend[name]))
            cstack._on_request = node.handle_client_message
            nodes[name] = node
            client_ports[name] = cstack
            looper.add((ref_looper.Prodable if ref else Prodable)(
                node, stacks[name], cstack, timer))

        async with looper:
            assert await looper.run_until(
                lambda: all(len(n.node_bus.connecteds) == 3
                            for n in nodes.values()), timeout=10.0), \
                "the mixed pool never meshed over TCP"
            reqs = []
            for i in range(n_nyms):
                user = Ed25519Signer(seed=(b"mixed-user-%d" % i).ljust(32,
                                                                      b"\0"))
                req = Request(trustee.identifier, i + 1,
                              {"type": NYM, "dest": user.identifier,
                               "verkey": user.verkey_b58})
                req.signature = trustee.sign_b58(req.signing_bytes())
                reqs.append(req)
            writers = []
            for name in names:
                _, writer = await asyncio.open_connection(
                    "127.0.0.1", client_ports[name].port)
                for req in reqs:
                    data = pack(req.to_dict())
                    writer.write(len(data).to_bytes(4, "big") + data)
                await writer.drain()
                writers.append(writer)
            ok = await looper.run_until(
                lambda: all(n.c.db.get_ledger(DOMAIN_LEDGER_ID).size
                            == 1 + n_nyms for n in nodes.values()),
                timeout=60.0)
            for writer in writers:
                writer.close()
            sizes = {n: nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                     for n in names}
            assert ok, sizes

    try:
        asyncio.run(main())
    finally:
        torch.set_num_threads(threads)
    roots = {name: (n.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
                    n.c.db.get_ledger(AUDIT_LEDGER_ID).root_hash,
                    n.c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash)
             for name, n in nodes.items()}
    assert len(set(roots.values())) == 1, roots
    # Node4's client signatures went through the plain K3 + K4 (a hedge
    # on the CPU, the supervisor's answer to a slow dispatch on a loaded
    # host, must agree with them)
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    sup = find_supervisor(
        nodes["Node4"].c.authenticator.core_authenticator.verifier)
    assert type(sup._device).__name__ == "TorchEd25519Verifier"
    assert sup.stats["device_items"] >= n_nyms
    assert sup.stats["device_errors"] == sup.stats["verdict_forks"] == 0
