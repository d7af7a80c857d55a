"""The port's copy of tests/test_crypto_service.py, run on
plenum_tpu_torch, with the port's remote backend held to the reference's.

Cross-process crypto plane (parallel/crypto_service.py): one device
owner, many clients; coalescing, verdict cache, and the OS-process pool
topology it exists for: a 4-process TCP pool on `service:cpu`, and on
`service:torch`, where the service verifies every node's client
signatures on the kernels' plain versions. make_verifier("service") is
supervised unless asked otherwise, make_tree_hasher("service") hashes
on hashlib, and NodeBootstrap(crypto_backend="service") builds in both
packages to the same roots. The three federated cases run the wave
frames, the prewarm/pin negotiation and a FederatedCryptoPipeline with
one real remote lane over the socket; the factory builds that ring from
PIPELINE_REMOTE_HOSTS."""
from __future__ import annotations

import asyncio
import os
import threading

import numpy as np
import pytest


def _make_items(n, signers=4, tag=b""):
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    sgs = [Ed25519Signer((b"svc%d" % i).ljust(32, b"\0")) for i in range(signers)]
    out = []
    for i in range(n):
        s = sgs[i % signers]
        msg = tag + b"payload-%d" % i
        out.append((msg, s.sign(msg), s.verkey))
    return out


@pytest.fixture
def service(tmp_path):
    """A live server on a CPU verifier + a factory for connected clients."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.crypto_service import (CryptoPlaneServer,
                                                    ServiceEd25519Verifier)
    sock = str(tmp_path / "crypto.sock")
    server = CryptoPlaneServer(CpuEd25519Verifier(), socket_path=sock)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        while not server._stop.is_set():
            await asyncio.sleep(0.05)
        await server.stop()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert started.wait(5.0)
    clients = []

    def connect():
        c = ServiceEd25519Verifier(socket_path=sock)
        clients.append(c)
        return c

    yield server, connect
    for c in clients:
        c.close()
    server._stop.set()
    t.join(timeout=5.0)


def test_verdicts_match_direct_verification(service):
    server, connect = service
    ver = connect()
    items = _make_items(12)
    # corrupt two: flipped sig byte, wrong key
    items[3] = (items[3][0], items[3][1][:32] + bytes(32), items[3][2])
    items[7] = (items[7][0], items[7][1], items[0][2])
    out = ver.verify_batch(items)
    expected = np.ones(12, dtype=bool)
    expected[3] = expected[7] = False
    assert (out == expected).all()


def test_cache_dedupes_across_clients(service):
    server, connect = service
    a, b = connect(), connect()
    items = _make_items(20, tag=b"dedup")
    assert a.verify_batch(items).all()
    dispatched_before = server.stats["dispatched_items"]
    assert b.verify_batch(items).all()          # same content, other client
    # nothing new dispatched: B rode A's cached verdicts
    assert server.stats["dispatched_items"] == dispatched_before
    assert server.stats["cache_hits"] >= 20


def test_pipelined_submit_collect(service):
    _, connect = service
    ver = connect()
    t1 = ver.submit_batch(_make_items(5, tag=b"one"))
    t2 = ver.submit_batch(_make_items(5, tag=b"two"))
    # out-of-order collection: replies are matched by id
    assert ver.collect_batch(t2, wait=True).all()
    assert ver.collect_batch(t1, wait=True).all()


def test_malformed_items_are_false_not_fatal(service):
    _, connect = service
    ver = connect()
    good = _make_items(2)
    bad = [(b"msg", b"short-sig", b"short-key"), good[0], (b"", b"", b"")]
    out = ver.verify_batch(bad)
    assert list(out) == [False, True, False]


def test_connect_fails_fast_without_server(tmp_path):
    from plenum_tpu_torch.parallel.crypto_service import ServiceEd25519Verifier
    with pytest.raises(OSError):
        ServiceEd25519Verifier(socket_path=str(tmp_path / "nope.sock"))


def test_tcp_pool_over_crypto_service():
    """The topology this exists for: a 4-process pool whose nodes all
    verify through ONE crypto-plane process (backend service:cpu), with
    the verdict cache collapsing per-node re-verification."""
    pytest.importorskip(
        "cryptography",
        reason="the TCP node stack's handshake needs the cryptography package")
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool
    from test_torch_tools import retry_port_race
    r = retry_port_race(lambda: run_tcp_pool(
        n_nodes=4, n_txns=60, backend="service:cpu", timeout=90.0))
    assert r["txns_ordered"] == 60, r
    stats = r.get("crypto_service")
    assert stats, "service stats missing from the bench result"
    # 4 nodes x 60 requests: without the cache the plane would dispatch
    # ~4x the unique signatures; with it, roughly one dispatch per unique
    # signature (trustee + 60 users, plus handshake traffic)
    assert stats["cache_hits"] > 0
    assert stats["dispatched_items"] < stats["items"]


def test_cache_poisoning_by_field_shift_rejected(service):
    """(msg, sig+vk[:1], vk[1:]) must NOT share a cache digest with the
    honest (msg, sig, vk): every field is length-prefixed. An attacker
    pre-submitting the shifted triple (malformed -> False) must not make
    the plane reject the honest signature afterwards."""
    _, connect = service
    attacker, honest = connect(), connect()
    (msg, sig, vk) = _make_items(1, tag=b"poison")[0]
    shifted = (msg, sig + vk[:1], vk[1:])
    assert not attacker.verify_batch([shifted]).any()   # cached False
    assert honest.verify_batch([(msg, sig, vk)]).all()  # unaffected


def test_backend_failure_is_loud_and_worker_survives(tmp_path):
    """An inner-verifier exception (device tunnel dropping) must surface
    as an error to waiting clients — never a silent all-False verdict or
    a dead worker thread that wedges every node."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.crypto_service import (CryptoPlaneServer,
                                                    ServiceEd25519Verifier)

    class FlakyVerifier(CpuEd25519Verifier):
        def __init__(self):
            super().__init__()
            self.fail_next = True

        def verify_batch(self, items):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("device tunnel dropped")
            return super().verify_batch(items)

    sock = str(tmp_path / "crypto.sock")
    server = CryptoPlaneServer(FlakyVerifier(), socket_path=sock)
    loop_ready = threading.Event()

    def runner():
        async def run():
            await server.start()
            loop_ready.set()
            while not server._stop.is_set():
                await asyncio.sleep(0.05)
        asyncio.new_event_loop().run_until_complete(run())

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    assert loop_ready.wait(5.0)
    ver = ServiceEd25519Verifier(socket_path=sock)
    items = _make_items(3, tag=b"flaky")
    with pytest.raises(RuntimeError, match="device tunnel dropped"):
        ver.verify_batch(items)
    # the worker survived: the next dispatch succeeds
    assert ver.verify_batch(items).all()
    # the swallow was NAMED, not silent: the audit counters recorded it
    assert server.stats.get("submit_errors", 0) + \
        server.stats.get("collect_errors", 0) >= 1
    ver.close()
    server._stop.set()
    t.join(timeout=5.0)


def test_supervised_inner_degrades_server_to_cpu_not_errors(tmp_path):
    """The production server topology: its inner device verifier rides
    the plane supervisor, so a wedged device yields CPU-hedged VERDICTS
    to every client — not error replies — and the stats op exposes the
    breaker state over the socket."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.crypto_service import (CryptoPlaneServer,
                                                    ServiceEd25519Verifier)
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    device = FaultyVerifier(CpuEd25519Verifier())
    inner = SupervisedVerifier(
        device, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2, cooldown=30.0),
        budget=DeadlineBudget(base=0.2, min_s=0.15, warm_max=0.3,
                              cold_max=0.3))
    sock = str(tmp_path / "crypto.sock")
    server = CryptoPlaneServer(inner, socket_path=sock)
    started = threading.Event()

    def runner():
        async def run():
            await server.start()
            started.set()
            while not server._stop.is_set():
                await asyncio.sleep(0.02)
        asyncio.new_event_loop().run_until_complete(run())

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    assert started.wait(5.0)
    try:
        ver = ServiceEd25519Verifier(socket_path=sock)
        good = _make_items(3, tag=b"sup-ok")
        assert ver.verify_batch(good).all()
        device.wedge()
        mixed = _make_items(4, tag=b"sup-wedge")
        mixed[1] = (mixed[1][0], mixed[1][1][:32] + bytes(32), mixed[1][2])
        # verdicts, not errors: the server hedged on its CPU fallback
        out = ver.verify_batch(mixed)
        assert list(out) == [True, False, True, True]
        stats = ver.stats()
        assert stats["plane"]["hedge_wins"] >= 1
        assert stats["plane"]["verdict_forks"] == 0
        ver.close()
    finally:
        server._stop.set()
        t.join(timeout=5.0)


def test_bls_checks_ride_the_plane_and_dedupe(service):
    """The per-batch BLS aggregate check is the other identical-on-every-
    node pairing; routed through the plane it runs once per host."""
    from plenum_tpu_torch.crypto import bls as bls_mod
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, aggregate_sigs
    from plenum_tpu_torch.parallel.crypto_service import ServiceBlsVerifier

    server, connect = service
    signers = [BlsCryptoSigner(seed=b"svcbls%d" % i + bytes(25))
               for i in range(3)]
    message = b"state-root-over-the-plane"
    agg = aggregate_sigs([s.sign(message) for s in signers])
    vks = [s.pk for s in signers]

    a = ServiceBlsVerifier(socket_path=connect().socket_path)
    bls_mod._BLS_VERDICTS.clear()
    assert a.verify_multi_sig(agg, message, vks)
    pairings_after_first = server.stats.get("bls_pairings", 0)
    assert pairings_after_first >= 1

    # the REAL cross-process claim: a separate OS process (fresh local
    # cache) asking the same check costs the server a lookup, not a
    # pairing — and different verkey order must not change the verdict
    import base64
    import pickle
    import subprocess
    import sys
    blob = base64.b64encode(pickle.dumps(
        (a._client.socket_path, agg, message, list(reversed(vks))))).decode()
    code = (
        "import base64, pickle, sys\n"
        "sock, agg, msg, vks = pickle.loads(base64.b64decode('" + blob + "'))\n"
        "from plenum_tpu_torch.parallel.crypto_service import ServiceBlsVerifier\n"
        "v = ServiceBlsVerifier(socket_path=sock)\n"
        "assert v.verify_multi_sig(agg, msg, vks)\n"
        "print('XPROC-OK')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert "XPROC-OK" in out.stdout, out.stderr[-500:]
    assert server.stats.get("bls_pairings", 0) == pairings_after_first

    # wrong participant set still fails closed
    assert not a.verify_multi_sig(agg, message, vks[:2])
    assert not a.verify_multi_sig(agg, b"other", vks)
    a.close()


def test_bls_single_flight_survives_cancellation(tmp_path):
    """A client disconnect cancels its _process task mid-pairing; the
    single-flight future must still resolve (and the key must be popped)
    so later identical checks don't await a dead future forever."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.crypto_service import CryptoPlaneServer
    server = CryptoPlaneServer(CpuEd25519Verifier(),
                               socket_path=str(tmp_path / "c.sock"))
    in_pairing = threading.Event()
    release = threading.Event()

    def slow_verify(sig, msg, vks):
        in_pairing.set()
        assert release.wait(5.0)
        return True

    server._bls.verify_multi_sig = slow_verify
    msg = b"cancel-regression-%d" % os.getpid()   # dodge the global cache

    async def scenario():
        loop = asyncio.get_running_loop()
        first = asyncio.ensure_future(
            server._bls_check(loop, "sig", msg, ["vk1", "vk2"]))
        while not in_pairing.is_set():
            await asyncio.sleep(0.01)
        first.cancel()                 # the disconnecting client
        with pytest.raises(asyncio.CancelledError):
            await first
        # identical check from a co-hosted node: joins the in-flight
        # pairing and must resolve once it completes
        second = asyncio.ensure_future(
            server._bls_check(loop, "sig", msg, ["vk1", "vk2"]))
        await asyncio.sleep(0.05)
        release.set()
        return await asyncio.wait_for(second, timeout=5.0)

    assert asyncio.run(scenario()) is True
    assert server._bls_pending == {}


# --- double-buffered worker (round 5) -------------------------------------

class _SlowAsyncVerifier:
    """Inner verifier with REAL async token semantics: submit returns
    immediately, the 'device' resolves each token ~30 ms later in a
    background thread — enough for the worker to stage the next wave."""

    def __init__(self):
        from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
        self._cpu = CpuEd25519Verifier()
        self.submitted = []

    def submit_batch(self, items):
        import time
        self.submitted.append([i[0] for i in items])
        return {"t": time.monotonic() + 0.03,
                "verdicts": self._cpu.verify_batch(items)}

    def collect_batch(self, token, wait=True):
        import time
        while time.monotonic() < token["t"]:
            if not wait:
                return None
            time.sleep(0.002)
        return token["verdicts"]

    def verify_batch(self, items):
        return self.collect_batch(self.submit_batch(items), wait=True)


def test_worker_overlaps_waves_and_dedupes_across_them(tmp_path):
    """Wave k+1 must dispatch while wave k is still in flight (overlap),
    and content already computing in wave k must NOT be re-dispatched by a
    later wave — the job rides the in-flight wave."""
    from plenum_tpu_torch.parallel.crypto_service import (CryptoPlaneServer,
                                                    ServiceEd25519Verifier)
    sock = str(tmp_path / "crypto.sock")
    inner = _SlowAsyncVerifier()
    server = CryptoPlaneServer(inner, socket_path=sock)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        while not server._stop.is_set():
            await asyncio.sleep(0.02)
        await server.stop()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert started.wait(5.0)
    try:
        c1 = ServiceEd25519Verifier(socket_path=sock)
        c2 = ServiceEd25519Verifier(socket_path=sock)
        a = _make_items(6, tag=b"waveA-")
        b = _make_items(6, tag=b"waveB-")
        # wave 1: client 1 ships A; then while it is in flight, client 2
        # ships B (new content -> second wave overlapped) AND A again
        # (must attach to wave 1, not re-dispatch)
        t1 = c1.submit_batch(a)
        import time
        time.sleep(0.005)                  # let the worker pick up wave 1
        t2 = c2.submit_batch(b)
        t3 = c2.submit_batch(a)
        ok1 = c1.collect_batch(t1)
        ok2 = c2.collect_batch(t2)
        ok3 = c2.collect_batch(t3)
        assert ok1.all() and ok2.all() and ok3.all()
        # A's messages were dispatched exactly once across all waves
        flat = [m for batch in inner.submitted for m in batch]
        assert len(flat) == len(set(flat)), "re-dispatched content"
        assert server.stats.get("overlapped", 0) >= 1, server.stats
        c1.close(); c2.close()
    finally:
        server._stop.set()
        t.join(timeout=5.0)


def test_submit_failure_with_cross_wave_dependency_is_loud(tmp_path):
    """Regression (round-5 review): wave 1 in flight, a job referencing
    wave-1 content plus new content attaches to wave 2; wave 2's submit
    raises. The job must get an ERROR reply (not hang) and the worker
    thread must survive to serve later requests."""
    from plenum_tpu_torch.parallel.crypto_service import (CryptoPlaneServer,
                                                    ServiceEd25519Verifier)

    class _FlakySubmit(_SlowAsyncVerifier):
        def __init__(self):
            super().__init__()
            self.fail_next = False

        def submit_batch(self, items):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("tunnel dropped")
            return super().submit_batch(items)

    sock = str(tmp_path / "crypto.sock")
    inner = _FlakySubmit()
    server = CryptoPlaneServer(inner, socket_path=sock)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        while not server._stop.is_set():
            await asyncio.sleep(0.02)
        await server.stop()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert started.wait(5.0)
    try:
        c = ServiceEd25519Verifier(socket_path=sock)
        a = _make_items(4, tag=b"dep-a-")
        b = _make_items(4, tag=b"dep-b-")
        t1 = c.submit_batch(a)
        import time
        time.sleep(0.005)            # wave 1 (a) now in flight
        inner.fail_next = True
        t2 = c.submit_batch(a + b)   # depends on wave 1 AND the failing wave
        assert c.collect_batch(t1).all()
        with pytest.raises(RuntimeError):
            c.collect_batch(t2)      # loud error, not a hang
        # worker alive: a fresh request still round-trips
        t3 = c.submit_batch(_make_items(3, tag=b"dep-c-"))
        assert c.collect_batch(t3).all()
        assert server._worker.is_alive()
        c.close()
    finally:
        server._stop.set()
        t.join(timeout=5.0)


def test_tcp_pool_over_crypto_service_on_the_plain_kernels(monkeypatch):
    """service:torch: the service process verifies the nodes' client
    signatures with the plain K3 + K4 (supervised: it reports its plane),
    the nodes reach it through make_verifier("service"). On a loaded host
    a plain dispatch can outrun a supervisor's deadline, and hedging it
    on the CPU is the supervisor's job: here every verdict agrees (no
    fork) and the plain kernels took part; that nothing leaves the card
    is held on the card (chip_smoke.py path G)."""
    pytest.importorskip(
        "cryptography",
        reason="the TCP node stack's handshake needs the cryptography package")
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from test_torch_tools import retry_port_race
    r = retry_port_race(lambda: run_tcp_pool(
        n_nodes=4, n_txns=4, backend="service:torch", service_min_batch=1,
        timeout=90.0))
    assert r["txns_ordered"] == r["txns_requested"] == 4, r
    stats = r["crypto_service"]
    assert stats["dispatches"] >= 1 and stats.get("errors", 0) == 0
    assert stats["dispatched_items"] < stats["items"]
    plane = stats["plane"]
    assert plane["device_batches"] >= 1 and plane["device_errors"] == 0
    assert plane["verdict_forks"] == 0
    # the nodes' own supervisors around their service verifiers report
    assert "crypto_breaker_state" in r["crypto_plane"]


def test_make_verifier_service_is_supervised_by_default(service, monkeypatch):
    """The one remote backend: wrapped in the plane supervisor as the
    reference's factory wraps it (a node outlives a dead service on CPU
    verdicts); supervised=False gives it bare."""
    from plenum_tpu_torch.crypto.ed25519 import make_verifier
    from plenum_tpu_torch.parallel.crypto_service import \
        ServiceEd25519Verifier
    from plenum_tpu_torch.parallel.supervisor import (SupervisedVerifier,
                                                      find_supervisor)
    server, connect = service
    monkeypatch.setenv("PLENUM_CRYPTO_SOCKET", connect().socket_path)
    v = make_verifier("service")
    assert isinstance(v, SupervisedVerifier)
    assert isinstance(find_supervisor(v)._device, ServiceEd25519Verifier)
    items = _make_items(6, tag=b"factory")
    items[2] = (items[2][0], items[2][1][:32] + bytes(32), items[2][2])
    assert list(v.verify_batch(items)) == [True, True, False, True, True,
                                           True]
    assert find_supervisor(v).stats["fallback_batches"] == 0
    bare = make_verifier("service", supervised=False)
    assert type(bare) is ServiceEd25519Verifier
    assert list(bare.verify_batch(items)) == list(v.verify_batch(items))
    bare.close()


def test_make_verifier_service_without_a_server_fails_fast(tmp_path,
                                                           monkeypatch):
    from plenum_tpu_torch.crypto.ed25519 import make_verifier
    monkeypatch.setenv("PLENUM_CRYPTO_SOCKET", str(tmp_path / "none.sock"))
    with pytest.raises(OSError):
        make_verifier("service")


def test_unknown_backends_name_the_service():
    from plenum_tpu_torch.crypto.ed25519 import make_verifier
    from plenum_tpu_torch.ledger.tree_hasher import make_tree_hasher
    with pytest.raises(ValueError, match="'service'"):
        make_verifier("jax")
    with pytest.raises(ValueError, match="'service'"):
        make_tree_hasher("jax")


def test_service_tree_hasher_is_hashlibs():
    """A node whose verifier is remote hashes its ledgers on the host, as
    the reference's make_tree_hasher("service") does."""
    from plenum_tpu.ledger import tree_hasher as ref
    from plenum_tpu_torch.ledger import tree_hasher as port
    h = port.make_tree_hasher("service")
    assert type(h) is port.TreeHasher
    assert type(ref.make_tree_hasher("service")) is ref.TreeHasher
    leaves = [b"leaf-%d" % i for i in range(5)]
    assert h.hash_leaves(leaves) == \
        ref.make_tree_hasher("service").hash_leaves(leaves)


def test_bootstrap_on_the_service_builds_in_both_packages(service,
                                                           monkeypatch):
    """NodeBootstrap(crypto_backend="service") builds in both packages
    on one live service (the same wire protocol), to the same ledger and
    state roots on a seeded genesis; both authenticate one batch through
    the service to the same verdicts."""
    from plenum_tpu.node.bootstrap import NodeBootstrap as RefBootstrap
    from plenum_tpu.tools.local_pool import build_genesis as ref_genesis
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    from plenum_tpu_torch.tools.local_pool import build_genesis
    server, connect = service
    monkeypatch.setenv("PLENUM_CRYPTO_SOCKET", connect().socket_path)
    names = ["Node1", "Node2", "Node3", "Node4"]
    genesis, trustee = build_genesis(names)
    assert ref_genesis(names)[0] == genesis
    port = NodeBootstrap("Node2", genesis_txns=genesis,
                         crypto_backend="service").build()
    ref = RefBootstrap("Node2", genesis_txns=genesis,
                       crypto_backend="service").build()
    port_ledgers, ref_ledgers = dict(port.db.ledgers()), dict(ref.db.ledgers())
    assert sorted(port_ledgers) == sorted(ref_ledgers)
    for lid, ledger in port_ledgers.items():
        assert type(ledger.tree.hasher) is TreeHasher
        assert (ledger.size, ledger.root_hash) == \
            (ref_ledgers[lid].size, ref_ledgers[lid].root_hash), lid
        state, ref_state = port.db.get_state(lid), ref.db.get_state(lid)
        assert (state is None) == (ref_state is None), lid
        if state is not None:
            assert state.committed_head_hash == \
                ref_state.committed_head_hash, lid
    reqs = []
    for i in range(3):
        user = Ed25519Signer(seed=(b"svc-boot-%d" % i).ljust(32, b"\0"))
        req = Request(trustee.identifier, i + 1,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        req.signature = trustee.sign_b58(req.signing_bytes())
        reqs.append(req)
    reqs[1].signature = trustee.sign_b58(b"another message")
    verdicts = port.authenticator.authenticate_batch(reqs)
    assert list(verdicts) == [True, False, True]
    from plenum_tpu.common.request import Request as RefRequest
    ref_reqs = [RefRequest.from_dict(r.to_dict()) for r in reqs]
    assert list(ref.authenticator.authenticate_batch(ref_reqs)) == \
        list(verdicts)
    sup = find_supervisor(port.authenticator.core_authenticator.verifier)
    assert sup.stats["device_batches"] >= 1
    assert sup.stats["fallback_batches"] == 0
    assert server.stats["dispatches"] >= 1


def test_warm_up_runs_beneath_the_supervisor():
    """warm_up verifies one signature on the verifier beneath the plane
    supervisor (whose cold deadline would count a card's first dispatch
    as a miss), leaves the supervisor's counters at 0, and refuses a
    verifier that rejects a valid signature."""
    import torch

    from plenum_tpu_torch.crypto.ed25519 import (CpuEd25519Verifier,
                                                 make_verifier, warm_up)
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        v = make_verifier("torch")
        assert warm_up(v) is v
    finally:
        torch.set_num_threads(threads)
    sup = find_supervisor(v)
    assert sup.stats["device_batches"] == sup.stats["fallback_batches"] == 0
    assert not sup.budget.warmed
    cpu = CpuEd25519Verifier()
    assert warm_up(cpu) is cpu

    class Refusing(CpuEd25519Verifier):
        def verify_batch(self, items):
            return np.zeros(len(items), dtype=bool)

    with pytest.raises(RuntimeError, match="warm-up"):
        warm_up(Refusing())


def test_service_main_warms_its_verifier_before_binding(monkeypatch, tmp_path):
    """The service's verifier takes its first dispatch before the socket
    exists (tcp_pool reads the socket as the service being ready)."""
    from plenum_tpu_torch.crypto import ed25519
    from plenum_tpu_torch.parallel import crypto_service
    order = []

    class Bound(Exception):
        pass

    real_warm_up = ed25519.warm_up

    def warm_up(v):
        order.append("warm")
        return real_warm_up(v)

    def start(self):
        order.append("bind")
        raise Bound

    monkeypatch.setattr(ed25519, "warm_up", warm_up)
    monkeypatch.setattr(crypto_service.CryptoPlaneServer, "start", start)
    with pytest.raises(Bound):
        crypto_service.main(["--backend", "cpu",
                             "--socket", str(tmp_path / "s.sock")])
    assert order == ["warm", "bind"]


# --- federated wave frames + prewarm/pin negotiation -------------------------

def test_federated_wave_frames_dispatch_verbatim(service):
    """`"wave": 1` frames bypass the server's dedup/coalescing: a padded
    bucket of IDENTICAL items dispatches at full width (the federated
    lane's pinned-shape guarantee crosses the wire), while verdicts stay
    correct and still land in the shared digest cache."""
    from plenum_tpu_torch.parallel.crypto_service import FederatedEd25519Client
    server, connect = service
    fed = FederatedEd25519Client(socket_path=connect().socket_path)
    pad = _make_items(1, tag=b"pad")[0]
    before = server.stats["dispatched_items"]
    out = fed.collect_batch(fed.submit_batch([pad] * 16), wait=True)
    assert out.shape == (16,) and out.all()
    assert server.stats["dispatched_items"] - before == 16, \
        "server deduped a wave frame — the dispatched shape shrank"
    assert server.stats.get("wave_frames", 0) >= 1
    # mixed real verdicts round-trip the raw path too
    items = _make_items(6, tag=b"wavemix")
    items[2] = (items[2][0], items[2][1][:32] + bytes(32), items[2][2])
    got = fed.collect_batch(fed.submit_batch(items), wait=True)
    assert list(got) == [True, True, False, True, True, True]
    fed.close()


def test_federated_prewarm_pin_negotiation(service):
    """The prewarm RPC compiles each pad bucket server-side (one
    verbatim all-pad wave per bucket) and answers whether the remote
    inner is device-backed; pin marks warmup over."""
    from plenum_tpu_torch.parallel.crypto_service import FederatedEd25519Client
    server, connect = service
    fed = FederatedEd25519Client(socket_path=connect().socket_path)
    reply = fed.prewarm([8, 16])
    assert reply["warmed"] == [8, 16]
    assert reply["bucketed"] is False       # CPU inner: don't pad for it
    assert server.stats.get("prewarms") == 1
    assert fed.pin()["pinned"] is True
    assert server.stats.get("pinned") == 1
    fed.close()


def test_federated_pipeline_rides_remote_lane(service):
    """End-to-end: a FederatedCryptoPipeline with one REAL remote lane
    over the service socket — prewarm negotiation turns padding off for
    the CPU-backed host, unhinted waves land on the remote, verdicts
    are correct, and no item is double-verified."""
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import TorchEd25519Verifier
    from plenum_tpu_torch.parallel.crypto_service import FederatedEd25519Client
    from plenum_tpu_torch.parallel.federation import FederatedCryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import supervise
    server, connect = service
    sock = connect().socket_path
    class FakeDev(TorchEd25519Verifier):
        def __init__(self):
            super().__init__(device="cpu")

        def submit_batch(self, items):
            return np.ones(len(items), dtype=bool)

        def collect_batch(self, token, wait=True):
            return token

    fed = supervise(FederatedEd25519Client(socket_path=sock),
                    label="remote0")
    pipe = FederatedCryptoPipeline(
        ed_inners=[FakeDev()],
        remote_inners=[fed], hosts=[sock],
        config=Config(PIPELINE_MIN_BUCKET=16, PIPELINE_MAX_BUCKET=64,
                      PIPELINE_FLUSH_WAIT=0.0),
        threaded=False)
    pipe.prewarm([16])
    assert pipe.lanes[1].bucketed is False  # negotiated: CPU host
    pipe.pin()
    n = 0
    toks = []
    for i in range(8):
        items = _make_items(4, tag=b"fed%d-" % i)
        toks.append(pipe.submit_verify(items))
        n += 4
    for t in toks:
        out = pipe.collect_verify(t, wait=True)
        assert out is not None and out.all()
    assert pipe.lanes[1].stats["dispatches"] >= 1, \
        "the remote lane never carried a wave"
    assert pipe.stats["dispatched_items"] == n
    assert pipe.stats["unpinned_shapes"] == 0
    assert pipe.federation_state()["remote_lanes"] == 1
    assert pipe.federation_state()["ship_ms_p95"] > 0.0
    pipe.close()


def test_factory_with_a_roster_builds_the_federated_ring(service):
    """PIPELINE_REMOTE_HOSTS set -> make_crypto_pipeline takes the
    federation branch: one local lane (a CPU lane for "torch") plus one
    supervised remote lane over the service socket; without the roster
    the same call is the single ring exactly. One real signature and one
    forged one settle through the remote lane."""
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.parallel.federation import FederatedCryptoPipeline
    from plenum_tpu_torch.parallel.pipeline import (CryptoPipeline,
                                                    make_crypto_pipeline)
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    server, connect = service
    sock = connect().socket_path
    cfg = dict(PIPELINE_MIN_BUCKET=8, PIPELINE_MAX_BUCKET=16,
               PIPELINE_FLUSH_WAIT=0.0)
    assert type(make_crypto_pipeline(Config(**cfg), "torch")) is \
        CryptoPipeline
    pipe = make_crypto_pipeline(Config(PIPELINE_REMOTE_HOSTS=sock, **cfg),
                                "torch")
    assert type(pipe) is FederatedCryptoPipeline
    assert pipe.n_local == 1 and len(pipe.lanes) == 2
    assert str(pipe.lanes[0].inner._device.device) == "cpu"
    assert all(find_supervisor(l.inner) is not None for l in pipe.lanes)
    assert not pipe.lanes[0].threaded and pipe.lanes[1].threaded
    pipe.prewarm([8])
    assert pipe.lanes[1].bucketed is False   # negotiated: a CPU host
    pipe.pin()
    items = _make_items(2, tag=b"factory")
    items[1] = (items[1][0], items[1][1][:32] + bytes(32), items[1][2])
    tok = pipe.submit_verify(items, lane=None)
    for lane in pipe.lanes[:1]:
        if tok in lane.staged:
            lane.staged.remove(tok)
            lane.first_staged = None
    pipe.lanes[1].staged.append(tok)
    pipe.lanes[1].first_staged = 0.0
    assert list(pipe.collect_verify(tok, wait=True)) == [True, False]
    assert pipe.lanes[1].stats["dispatches"] == 1
    assert pipe.federation_state()["remote_lanes"] == 1
    pipe.close()
