"""The port's copy of tests/test_tools.py, run on plenum_tpu_torch, and
the port's tools held against the reference's.

Ops-surface tests: wallet, keygen, genesis files, and a real 4-process
pool started via the start_node script, written to and read from with the
PoolClient over TCP (nodes on the `cpu` backend), and the reference's
bench configurations config1b and config18 (slow) on the `cpu` backend
(bench_configs defaults to the card). Across the packages: keygen and setup_pool_dir write byte-identical
key and genesis files, and metrics_report derives equal summaries from
one flushed store. The port's entry points (start_node, tcp_pool,
replay, start_observer, ObserverNode, SimObserver) run on the card
unless asked for the CPU, and tcp_pool hides the card from every
process but its owners.

Reference test model: the scripts/ + client e2e flow (SURVEY.md §2 tools,
client wallet).
"""
from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def retry_port_race(fn, tries: int = 3):
    """fn() once more when a node lost its port between tcp_pool's
    _free_ports and its own bind (EADDRINUSE, nothing else): the ports
    are found free and released before the node binds, as in the
    reference, and tests running beside this one open connections whose
    ephemeral ports can take them."""
    for attempt in range(tries):
        try:
            return fn()
        except RuntimeError as exc:
            if "address already in use" not in str(exc) or \
                    attempt == tries - 1:
                raise


# --- wallet ---------------------------------------------------------------

def test_wallet_sign_and_roundtrip(tmp_path):
    from plenum_tpu_torch.client import Wallet
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.utils.base58 import b58decode

    w = Wallet("w1")
    did = w.add_identifier(seed=b"wallet-seed-0001".ljust(32, b"\0"))
    assert w.default_id == did
    req = w.sign_request({"type": NYM, "dest": "X", "verkey": "Y"})
    assert req.identifier == did and req.signature
    ok = CpuEd25519Verifier().verify(
        req.signing_bytes(), b58decode(req.signature),
        b58decode(w.verkey_of(did)))
    assert ok

    # persistence: same keys come back
    path = str(tmp_path / "wallet.bin")
    w.save(path)
    assert oct(os.stat(path).st_mode & 0o777) == "0o600"
    w2 = Wallet.load(path)
    assert w2.identifiers() == [did] and w2.default_id == did
    assert w2.verkey_of(did) == w.verkey_of(did)


# --- keygen + genesis -----------------------------------------------------

def test_keygen_and_genesis_files(tmp_path):
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                 POOL_LEDGER_ID)
    from plenum_tpu_torch.crypto.bls import verify_pop
    from plenum_tpu_torch.tools import genesis as gen
    from plenum_tpu_torch.tools import keygen

    base = str(tmp_path)
    for i, name in enumerate(("Alpha", "Beta")):
        keys = keygen.generate_keys(
            name, seed=(b"kg%d" % i).ljust(32, b"\0"))
        keygen.save_keys(keys, base)
        loaded = keygen.load_keys(base, name)
        assert loaded == keys
        assert verify_pop(keys["bls_pop"], keys["bls_pk"])

    out = gen.build_genesis_files(
        base, [("Alpha", "127.0.0.1", 9701, 9702),
               ("Beta", "127.0.0.1", 9703, 9704)],
        trustee_seed=b"t".ljust(32, b"\0"))
    assert os.path.exists(out["pool_genesis"])
    loaded = gen.load_genesis_files(base)
    assert len(loaded[POOL_LEDGER_ID]) == 2
    assert len(loaded[DOMAIN_LEDGER_ID]) == 1
    data = loaded[POOL_LEDGER_ID][0]["txn"]["data"]["data"]
    assert data["alias"] == "Alpha" and data["node_port"] == 9701


# --- 4 OS processes over real sockets -------------------------------------


@pytest.mark.slow
def test_four_process_pool_orders_nym(tmp_path):
    from plenum_tpu_torch.client import PoolClient, Wallet
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.tools.tcp_pool import setup_pool_dir

    base = str(tmp_path)
    names = ["Node1", "Node2", "Node3", "Node4"]
    trustee_seed = b"proc-trustee".ljust(32, b"\0")
    specs = setup_pool_dir(base, names, trustee_seed)

    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for name in names:
            cmd = [sys.executable, "-m", "plenum_tpu_torch.tools.start_node",
                   "--name", name, "--base-dir", base, "--kv", "memory",
                   "--backend", "cpu"]
            if name == "Node1":
                cmd.append("--record")     # exercised by the replay below
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        # wait for every process to report "started"
        for p in procs:
            line = p.stdout.readline()
            assert b"started" in line, line

        wallet = Wallet("cli")
        trustee_did = wallet.add_identifier(seed=trustee_seed)
        user_did = wallet.add_identifier(seed=b"proc-user".ljust(32, b"\0"))
        req = wallet.sign_request(
            {"type": NYM, "dest": user_did,
             "verkey": wallet.verkey_of(user_did)}, identifier=trustee_did)

        async def run():
            client = PoolClient(
                {name: ("127.0.0.1", spec[3])
                 for name, spec in zip(names, specs)}, f=1)
            try:
                return await client.submit(req, timeout=30.0)
            finally:
                await client.close()

        reply = asyncio.run(run())
        assert reply["op"] == "REPLY", reply
        txn = reply["result"]
        assert txn["txn"]["data"]["dest"] == user_did
        assert txn["txnMetadata"]["seqNo"] == 2

        # offline replay of the recorded node reproduces its ledger state
        # (STACK_COMPANION story: record in production, debug offline)
        procs[0].send_signal(signal.SIGTERM)
        procs[0].wait(timeout=5)
        out = subprocess.run(
            [sys.executable, "-m", "plenum_tpu_torch.tools.replay",
             "--name", "Node1", "--base-dir", base, "--backend", "cpu"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        replayed = json.loads(out.stdout.strip().splitlines()[-1])
        from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
        dom = replayed["ledgers"][str(DOMAIN_LEDGER_ID)] \
            if str(DOMAIN_LEDGER_ID) in replayed["ledgers"] \
            else replayed["ledgers"][DOMAIN_LEDGER_ID]
        assert dom["size"] == 2            # genesis NYM + the ordered one
        assert replayed["last_ordered_3pc"][1] >= 1
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


@pytest.mark.slow
def test_tcp_pool_bench_orders_load():
    """The real-transport benchmark drives a 4-process TCP pool end to end:
    every request reaches an f+1 REPLY quorum over the wire."""
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool
    stats = retry_port_race(lambda: run_tcp_pool(
        n_nodes=4, n_txns=30, backend="cpu", timeout=90.0))
    assert stats["txns_ordered"] == 30, stats
    assert stats["tps"] > 0
    assert stats["p50_latency_ms"] is not None


def test_pipelined_client_survives_dead_node_and_reuse():
    """The pipelined client must tolerate an unreachable node (quorum
    covers it) and be reusable across drive() calls with a clean slate."""
    from plenum_tpu_torch.client import PipelinedPoolClient
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.serialization import pack, unpack

    async def main():
        async def serve(reader, writer):
            try:
                while True:
                    hdr = await reader.readexactly(4)
                    frame = await reader.readexactly(
                        int.from_bytes(hdr, "big"))
                    req = unpack(frame)
                    reply = pack({"op": "REPLY", "result": {"txn": {
                        "metadata": {"from": req["identifier"],
                                     "reqId": req["reqId"]}}}})
                    writer.write(len(reply).to_bytes(4, "big") + reply)
                    await writer.drain()
            except (asyncio.IncompleteReadError, OSError):
                return

        servers = [await asyncio.start_server(serve, "127.0.0.1", 0)
                   for _ in range(3)]
        addrs = {f"N{i}": ("127.0.0.1", s.sockets[0].getsockname()[1])
                 for i, s in enumerate(servers)}
        addrs["Ndead"] = ("127.0.0.1", 1)      # nothing listens there

        client = PipelinedPoolClient(addrs, f=1)
        reqs = [Request("idr", i, {"type": "1"}) for i in range(5)]
        done, _ = await client.drive(reqs, window=3, timeout=10.0)
        assert len(done) == 5

        # reuse: a smaller second batch must NOT be satisfied by stale state
        reqs2 = [Request("idr", 100 + i, {"type": "1"}) for i in range(2)]
        done2, _ = await client.drive(reqs2, window=2, timeout=10.0)
        assert set(done2) == {("idr", 100), ("idr", 101)}
        for s in servers:
            s.close()

    asyncio.run(main())


def test_metrics_report_reads_flushed_history(tmp_path):
    """tools.metrics_report turns a node's flushed metrics store into
    per-metric folds and a derived summary (ref scripts/process_logs)."""
    from plenum_tpu_torch.common.metrics import KvMetricsCollector, MetricsName
    from plenum_tpu_torch.storage.kv_file import KvFile
    from plenum_tpu_torch.tools.metrics_report import main as report_main, report_node

    mdir = tmp_path / "Node1" / "metrics"
    clock = [1000.0]
    m = KvMetricsCollector(KvFile(str(mdir)), now=lambda: clock[0])
    for tick in range(3):
        for _ in range(10):
            m.add_event(MetricsName.ORDERED_BATCH_SIZE, 5)
        m.add_event(MetricsName.PREPARE_PHASE_TIME, 0.040)
        m.add_event(MetricsName.CLIENT_INBOX_DEPTH, tick)  # gauge: last wins
        m.flush()
        clock[0] += 10.0

    folds, summary = report_node(str(mdir), last_s=None)
    assert folds["node.ordered_batch_size"]["count"] == 30
    assert summary["txns_ordered"] == 150
    assert summary["window_s"] == 20.0            # 3 flushes, 10 s apart
    assert summary["tps"] == 7.5                  # 150 txns / 20 s
    assert summary["prepare_phase_ms"] == 40.0
    assert summary["client_inbox_depth_max"] == 2

    # the trailing-window filter drops the first flush
    _, tail = report_node(str(mdir), last_s=10.0)
    assert tail["txns_ordered"] == 100

    # CLI over the whole base dir, machine-readable
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report_main([str(tmp_path), "--json"])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert out["Node1"]["summary"]["txns_ordered"] == 150


def test_metrics_report_commit_stage_percentiles(tmp_path):
    """Commit-path stage timers flush bounded RAW samples so the report
    can print honest p50/p95 per stage (not just fold means), plus the
    pairings-per-batch and plane-dispatch counters that previously never
    reached the report."""
    from plenum_tpu_torch.common.metrics import KvMetricsCollector, MetricsName
    from plenum_tpu_torch.storage.kv_file import KvFile
    from plenum_tpu_torch.tools.metrics_report import report_node

    mdir = tmp_path / "Node1" / "metrics"
    m = KvMetricsCollector(KvFile(str(mdir)), now=lambda: 1000.0)
    for i in range(100):
        m.add_event(MetricsName.COMMIT_BLS_VERIFY_TIME, 0.001 * (i + 1))
        m.add_event(MetricsName.COMMIT_DURABLE_TIME, 0.002)
        m.add_event(MetricsName.BLS_PAIRINGS_PER_BATCH, 2)
    m.add_event(MetricsName.SIG_BATCH_SIZE, 512)
    m.add_event(MetricsName.SIG_PLANE_DISPATCHES, 7)   # cumulative gauge
    m.add_event(MetricsName.BLS_PAIRING_CHECKS, 100)
    m.add_event(MetricsName.BLS_PAIRINGS, 200)
    m.flush()

    folds, summary = report_node(str(mdir), last_s=None)
    assert summary["bls_verify_ms_p50"] == pytest.approx(51.0, abs=2.0)
    assert summary["bls_verify_ms_p95"] == pytest.approx(96.0, abs=2.0)
    assert summary["durable_ms_p50"] == pytest.approx(2.0, abs=0.1)
    assert summary["pairings_per_batch"] == 2.0
    assert summary["pairing_checks_total"] == 100
    assert summary["pairings_total"] == 200
    assert summary["plane_dispatches"] == 7
    assert summary["sig_batch_size_mean"] == 512.0


def test_distinct_signers_config_orders_owner_writes():
    """config1b: n distinct client keys on the authN hot path — every
    ATTRIB owner-signed by its own DID (authorization: owner-or-trustee),
    so the figure reflects diverse-client traffic, not one amortized
    trustee key."""
    from plenum_tpu_torch.tools.bench_configs import config1b_distinct_signers
    r = config1b_distinct_signers(n_txns=40, timeout=60.0, backend="cpu")
    assert r.get("txns_ordered") == 40, r
    assert r["distinct_signers"] == 40


def test_replay_reproduces_span_sequence():
    """Record/replay x tracing determinism guard: replaying a recorded
    node under the mock clock reproduces a BYTE-IDENTICAL span sequence.
    Span timestamps come only from the injectable timer and payloads only
    from message content (wall_durations=False strips the perf_counter
    stage durations, the one legitimately non-deterministic field), so
    any divergence here means a span site leaked wall state into the
    trace — the property the flight-recorder postmortems rely on."""
    from plenum_tpu_torch.common.event_bus import ExternalBus
    from plenum_tpu_torch.common.timer import MockTimer
    from plenum_tpu_torch.common.tracing import Tracer, span_sequence
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.network import SimNetwork, SimRandom
    from plenum_tpu_torch.node import Node, NodeBootstrap
    from plenum_tpu_torch.node.recorder import Recorder, attach_recorder, replay
    from plenum_tpu_torch.storage.kv_memory import KvMemory
    from test_torch_pool import NODES, make_genesis, signed_nym

    genesis, trustee = make_genesis(NODES)
    timer = MockTimer()
    net = SimNetwork(timer, SimRandom(11))
    config = Config(Max3PCBatchWait=0.05, crypto_backend="cpu")
    recorder = Recorder(KvMemory(), now=timer.get_current_time)
    nodes = {}
    for name in NODES:
        bus = net.create_peer(name)
        components = NodeBootstrap(name, genesis_txns=genesis,
                                   crypto_backend="cpu").build()
        tracer = Tracer(name, timer.get_current_time,
                        wall_durations=False) if name == "Alpha" else None
        nodes[name] = Node(name, timer, bus, components, config=config,
                           tracer=tracer)
        if name == "Alpha":
            # before connect_all: the Connected events must be recorded
            attach_recorder(nodes[name], recorder)
    net.connect_all()

    user = Ed25519Signer(seed=b"replay-span-user".ljust(32, b"\0"))
    req = signed_nym(trustee, user, 1)
    for name in NODES:
        nodes[name].handle_client_message(req.to_dict(), "cli")
    for _ in range(100):
        for node in nodes.values():
            node.prod()
        timer.advance(0.05)
    live = span_sequence(nodes["Alpha"].tracer.snapshot())
    assert b'"ordered"' in live and b'"reply"' in live

    # fresh Alpha from the same genesis; feed the recorded stream back
    first_ts = next(ts for ts, *_ in recorder.iter_records())
    timer2 = MockTimer(start=first_ts)
    bus2 = ExternalBus(send_handler=lambda msg, dst: None)
    components2 = NodeBootstrap("Alpha", genesis_txns=genesis,
                                crypto_backend="cpu").build()
    tracer2 = Tracer("Alpha", timer2.get_current_time,
                     wall_durations=False)
    node2 = Node("Alpha", timer2, bus2, components2, config=config,
                 tracer=tracer2)
    replay(recorder.iter_records(), node2, timer2)
    assert span_sequence(tracer2.snapshot()) == live


def test_log_analyzer_unit(tmp_path):
    """Analyzer halves: error clustering over text, per-view timeline
    over structured events (ref scripts/process_logs redesign)."""
    import json as _json
    from plenum_tpu_torch.tools.log_analyzer import analyze_node
    d = tmp_path / "NodeX"
    d.mkdir()
    (d / "node.log").write_text(
        "2026-01-01 WARNING stack undecodable message from Node2\n"
        "2026-01-01 WARNING stack undecodable message from Node3\n"
        "2026-01-01 ERROR svc handler failed for PrePrepare 17 from Node4\n"
        "plain info noise that must be ignored\n"
        "2026-01-01 ERROR svc handler failed for PrePrepare 99 from Node4\n")
    rows = [
        {"t": 10.0, "event": "restored_from_audit", "data": [0, 0]},
        {"t": 11.0, "event": "suspicion", "data": [21, "Node1"]},
        {"t": 12.5, "event": "vc_stall_phases",
         "data": {"detect": 11.0, "vote": 12.5, "start": 12.56,
                  "new_view": 12.58, "order": 12.9}},
        {"t": 13.0, "event": "view_change_complete", "data": 1},
        {"t": 14.0, "event": "catchup_started", "data": None},
    ]
    with open(d / "events.jsonl", "w") as fh:
        for r in rows:
            fh.write(_json.dumps(r) + "\n")
        fh.write('{"t": 15.0, "event": "torn')   # torn tail: tolerated
    rep = analyze_node(str(d))
    assert rep["event_counts"]["suspicion"] == 1
    # two clusters: the repeated undecodable (x2) and the failed handler
    # (x2, seq-no digits normalized into one template)
    levels = {(c["level"], c["count"]) for c in rep["error_clusters"]}
    assert levels == {("WARNING", 2), ("ERROR", 2)}
    views = rep["views"]
    assert [v["view_no"] for v in views] == [0, 1]
    assert views[0]["vc_stall"]["total_s"] == 1.9
    assert views[0]["vc_stall"]["phases"]["order"] == 1.9
    assert views[1]["events"] == {"catchup_started": 1}


def test_durable_spylog_survives_torn_tail(tmp_path):
    """Crash mid-write tears a line; the restarted log starts on a fresh
    line and the analyzer skips ONLY the torn line (review findings)."""
    from plenum_tpu_torch.tools.log_analyzer import read_events
    from plenum_tpu_torch.tools.start_node import _DurableSpylog
    p = str(tmp_path / "events.jsonl")
    log = _DurableSpylog(p, now=lambda: 1.0)
    log.append(("view_change_complete", 1))
    log._fh.close()
    with open(p, "a") as fh:
        fh.write('{"t": 2.0, "event": "torn')      # crash mid-write
    log2 = _DurableSpylog(p, now=lambda: 3.0)      # restart
    log2.append(("catchup_started", None))
    log2._fh.close()
    rows = read_events(p)
    assert [r["event"] for r in rows] == ["view_change_complete",
                                          "catchup_started"]


def test_start_node_chunked_backend_is_durable(tmp_path):
    """--kv chunked must build a node on KvChunked ledgers (review
    finding: it silently fell back to in-memory storage)."""
    pytest.importorskip(
        "cryptography",
        reason="build_node stands up the TCP stack, which needs cryptography")
    from plenum_tpu_torch.storage.kv_chunked import KvChunked
    from plenum_tpu_torch.tools.start_node import build_node
    from plenum_tpu_torch.tools.tcp_pool import setup_pool_dir
    base = str(tmp_path)
    setup_pool_dir(base, ["N1", "N2", "N3", "N4"], b"t" * 32)
    prodable, node, _reg = build_node("N1", base, backend="cpu",
                                      kv="chunked")
    lid = 1
    log = node.c.db.get_ledger(lid)._log
    assert isinstance(log, KvChunked), type(log)
    node.c.db.close()


# --- the port's tools against the reference's -------------------------------

def _tree_bytes(base: str) -> dict:
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, base)] = fh.read()
    return out


def test_setup_pool_dir_is_byte_identical_across_packages(tmp_path,
                                                          monkeypatch):
    """keygen + genesis for the same names, ports and trustee seed: every
    key and genesis file the port writes is the reference's, byte for
    byte, and the port's start_node reads the reference's files."""
    from plenum_tpu.tools import keygen as ref_keygen
    from plenum_tpu.tools import tcp_pool as ref_pool
    from plenum_tpu_torch.tools import keygen, tcp_pool
    ports = list(range(9800, 9808))
    for mod in (ref_pool, tcp_pool):
        monkeypatch.setattr(mod, "_free_ports", lambda n: ports[:n])
    names = ["Node1", "Node2", "Node3", "Node4"]
    seed = b"parity-trustee".ljust(32, b"\0")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    assert tcp_pool.setup_pool_dir(ours, names, seed) == \
        ref_pool.setup_pool_dir(theirs, names, seed)
    files = _tree_bytes(ours)
    assert files == _tree_bytes(theirs)
    assert {"Node1/keys.json", "pool_genesis.json",
            "domain_genesis.json"} <= set(files)
    assert keygen.load_keys(theirs, "Node3") == \
        ref_keygen.load_keys(ours, "Node3")
    for i in range(3):
        seed_i = (b"kg-parity-%d" % i).ljust(32, b"\0")
        assert keygen.generate_keys("N%d" % i, seed=seed_i) == \
            ref_keygen.generate_keys("N%d" % i, seed=seed_i)


def test_metrics_report_derives_the_references_summary(tmp_path):
    """One store flushed by the reference's collector, with every metric
    name the node emits: fold_rows and derive_summary of both packages
    give the same folds and summaries, over the whole store and over a
    trailing window."""
    import random

    from plenum_tpu.common.metrics import (KvMetricsCollector as RefCollector,
                                           MetricsName as RefNames)
    from plenum_tpu.storage.kv_file import KvFile as RefKvFile
    from plenum_tpu.tools import metrics_report as ref
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.tools import metrics_report as port
    names = sorted({v for k, v in vars(RefNames).items()
                    if k.isupper() and isinstance(v, str)})
    assert names == sorted({v for k, v in vars(MetricsName).items()
                            if k.isupper() and isinstance(v, str)})
    names += ["transport.tx.PREPREPARE", "transport.tx_count.PREPREPARE",
              "transport.rx.PROPAGATE", "transport.tx.PROPAGATE",
              "transport.tx_count.PROPAGATE"]
    rng = random.Random(5)
    clock = [500.0]
    path = str(tmp_path / "Node1" / "metrics")
    m = RefCollector(RefKvFile(path), now=lambda: clock[0])
    for _ in range(4):
        for name in names:
            for _ in range(rng.randrange(1, 6)):
                m.add_event(name, rng.choice([rng.random(),
                                              rng.randrange(1, 900)]))
        m.flush()
        clock[0] += 7.5
    rows = port.read_store(path)
    assert rows == ref.read_store(path)
    folds = port.fold_rows(rows)
    assert folds == ref.fold_rows(rows)
    for span in (0.0, 22.5):
        assert port.derive_summary(folds, span) == \
            ref.derive_summary(folds, span)
    assert port.report_node(path, last_s=8.0) == ref.report_node(path, 8.0)


# --- the port's entry points run on the card unless asked -------------------

class _Built(Exception):
    pass


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """start_node, tcp_pool, replay and start_observer (scripts and
    functions), ObserverNode and SimObserver name "cuda" unless the
    caller names "cpu" or "torch"; the reference's JAX names are
    refused."""
    import inspect

    from plenum_tpu_torch.ingress.observer_reads import SimObserver
    from plenum_tpu_torch.node import observer_node
    from plenum_tpu_torch.tools import (replay, start_node, start_observer,
                                        tcp_pool)
    for fn, param in ((start_node.build_node, "backend"),
                      (tcp_pool.run_tcp_pool, "backend"),
                      (replay.replay_node, "backend"),
                      (observer_node.ObserverNode, "crypto_backend"),
                      (SimObserver, "crypto_backend")):
        default = inspect.signature(fn).parameters[param].default
        assert default == ("service:cuda" if fn is tcp_pool.run_tcp_pool
                           else "cuda"), fn

    asked = []

    def capture(*args, **kw):
        asked.append((args, kw))
        raise _Built

    base = str(tmp_path)
    tcp_pool.setup_pool_dir(base, ["N1", "N2", "N3", "N4"], b"t" * 32)
    monkeypatch.setattr(start_node, "build_node", capture)
    monkeypatch.setattr(tcp_pool, "run_tcp_pool", capture)
    monkeypatch.setattr(replay, "replay_node", capture)
    monkeypatch.setattr(observer_node, "ObserverNode", capture)
    for main, argv in (
            (start_node.main, ["--name", "N1", "--base-dir", base]),
            (tcp_pool.main, []),
            (replay.main, ["--name", "N1", "--base-dir", base]),
            (start_observer.main, ["--name", "o1", "--base-dir", base])):
        with pytest.raises(_Built):
            main(argv)
    assert asked[0][0][2] == "cuda"
    assert asked[1][0] == (4, 200, "service:cuda")
    assert asked[2][0] == ("N1", base, "cuda")
    assert asked[3][1]["crypto_backend"] == "cuda"
    for main, argv in (
            (start_node.main, ["--name", "N1", "--base-dir", base,
                               "--backend", "jax"]),
            (tcp_pool.main, ["--backend", "service:jax"]),
            (replay.main, ["--name", "N1", "--base-dir", base,
                           "--backend", "jax"]),
            (start_observer.main, ["--name", "o1", "--base-dir", base,
                                   "--backend", "jax"])):
        with pytest.raises(SystemExit):
            main(argv)


class _FakeProc:
    def __init__(self, cmd):
        self.cmd = cmd

    def poll(self):
        return None

    def send_signal(self, sig):
        pass

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


@pytest.mark.parametrize("backend", ["cpu", "torch", "cuda", "service:cpu",
                                     "service:torch", "service:cuda",
                                     "service:cuda-sharded"])
def test_tcp_pool_hides_the_card_from_all_but_its_owners(backend, tmp_path,
                                                         monkeypatch):
    """The reference sets JAX_PLATFORMS=cpu for every node; the port sets
    CUDA_VISIBLE_DEVICES="" for every process that does not own the card:
    the nodes unless they verify on it themselves ("cuda"), and a service
    whose inner is a host verifier. Service nodes reach the service by
    its socket, by the bare "service" backend."""
    from plenum_tpu_torch.tools import tcp_pool
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    spawned = []

    def popen(cmd, env=None, **kw):
        spawned.append((cmd, env))
        if "plenum_tpu_torch.parallel.crypto_service" in cmd:
            open(cmd[cmd.index("--socket") + 1], "w").close()
            return _FakeProc(cmd)
        raise _Built

    monkeypatch.setattr(tcp_pool.subprocess, "Popen", popen)
    with pytest.raises(_Built):
        tcp_pool.run_tcp_pool(4, 1, backend, base_dir=str(tmp_path))
    node_cmd, node_env = spawned[-1]
    assert node_cmd[node_cmd.index("--backend") + 1] == \
        ("service" if backend.startswith("service:") else backend)
    assert node_env["CUDA_VISIBLE_DEVICES"] == \
        ("0" if backend == "cuda" else "")
    assert node_env["PYTHONPATH"] == tcp_pool.REPO
    if backend.startswith("service:"):
        (svc_cmd, svc_env), = spawned[:-1]
        inner = backend.split(":", 1)[1]
        assert svc_cmd[svc_cmd.index("--backend") + 1] == inner
        assert svc_cmd[svc_cmd.index("--min-batch") + 1] == "128"
        assert svc_env["CUDA_VISIBLE_DEVICES"] == \
            ("0" if inner.startswith("cuda") else "")
        assert node_env["PLENUM_CRYPTO_SOCKET"] == \
            svc_cmd[svc_cmd.index("--socket") + 1]
    else:
        assert len(spawned) == 1


def test_tcp_pool_on_the_plain_kernels_orders_every_txn(monkeypatch):
    """Every node on backend torch: each verifies its client signatures
    with the kernels' plain versions behind its own supervisor, which
    reports through the node's metrics (on a loaded host it may hedge a
    slow plain dispatch on the CPU, its job; chip_smoke.py path G holds
    the card's nodes to no fallback)."""
    pytest.importorskip(
        "cryptography",
        reason="the TCP node stack's handshake needs the cryptography package")
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    r = retry_port_race(lambda: run_tcp_pool(n_nodes=4, n_txns=3,
                                             backend="torch", timeout=90.0))
    assert r["txns_ordered"] == r["txns_requested"] == 3, r
    assert "crypto_breaker_state" in r["crypto_plane"]


def test_start_node_supervises_and_warms_the_card_verifier(tmp_path,
                                                           monkeypatch):
    """A `cuda` node's verifier rides the plane supervisor (the
    reference's device nodes do; the factory leaves the card's bare) and
    is warmed before the node takes work; other backends keep the
    bootstrap's own verifier."""
    from plenum_tpu_torch.crypto import ed25519
    from plenum_tpu_torch.node import bootstrap
    from plenum_tpu_torch.tools import start_node, tcp_pool
    asked = []

    def make_verifier(backend, **kw):
        asked.append(("make", backend, kw))
        return "the card's verifier"

    def warm_up(v):
        asked.append(("warm", v))
        return v

    def built(self):
        asked.append(("bootstrap", self.crypto_backend, self.verifier))
        raise _Built

    monkeypatch.setattr(ed25519, "make_verifier", make_verifier)
    monkeypatch.setattr(ed25519, "warm_up", warm_up)
    monkeypatch.setattr(bootstrap.NodeBootstrap, "build", built)
    base = str(tmp_path)
    tcp_pool.setup_pool_dir(base, ["N1", "N2", "N3", "N4"], b"t" * 32)
    for backend in ("cuda", "service", "cpu"):
        with pytest.raises(_Built):
            start_node.build_node("N1", base, backend=backend)
    assert asked == [("make", "cuda", {"supervised": True}),
                     ("warm", "the card's verifier"),
                     ("bootstrap", "cuda", "the card's verifier"),
                     ("bootstrap", "service", None),
                     ("bootstrap", "cpu", None)]


@pytest.mark.slow
def test_config18_autopilot_heals_zipfian_flood_hands_off():
    """The ISSUE 18 acceptance bench: config12's zipfian hot-range
    flood with AUTOPILOT=True and ZERO test-driven actuation — the
    autopilot must split the hot shard on its own cadence and the run
    must recover to >= 0.8x pre-flood TPS with a clean control-ledger
    audit."""
    from plenum_tpu_torch.tools.bench_configs import config18_autopilot
    out = config18_autopilot(backend="cpu")
    assert "error" not in out, out
    assert out["test_driven_actuations"] == 0
    assert out["recovery_ratio"] >= 0.8, out
    assert out["audit_problems"] == [], out
    assert out["split_evidence"]["hot_shard"] == 0
    assert out["migration"]["phase"] == "done", out
