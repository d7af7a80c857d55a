"""Start one validator node as an OS process.

Reference behavior: scripts/start_plenum_node — load the node's keys and the
genesis files from a base dir, stand up the real transport stacks, and run
the node until killed. A 4-node localhost pool is four of these processes
(ports from the genesis node specs) — see tests/test_tools.py for the
scripted version.

    python -m plenum_tpu_torch.tools.start_node --name Node1 --base-dir /tmp/pool \
        [--backend cuda|service|cpu|torch] [--kv file|memory]

The default backend, cuda, verifies the node's client signatures on the
card (supervised: a card fault turns into CPU verdicts that the node's
metrics count); service ships them to the crypto-service process that owns the
card (socket from PLENUM_CRYPTO_SOCKET); cpu and torch (the kernels'
plain versions) stay on the host.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from collections import deque


class _DurableSpylog(deque):
    """The node's bounded in-memory event trace, made durable: every
    append also writes a JSONL row {"t", "event", "data"} that
    tools.log_analyzer reads back for per-view postmortem timelines."""

    def __init__(self, path: str, now=time.time, seed=()):
        super().__init__(maxlen=1000)
        self._now = now
        self._fh = open(path, "a", buffering=1)   # line-buffered
        # a crash mid-write leaves a torn line with no newline; start on
        # a fresh line so the first post-restart event stays parseable
        try:
            if os.path.getsize(path) > 0:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._fh.write("\n")
        except OSError:
            pass
        for item in seed:
            self.append(item)

    def append(self, item) -> None:
        super().append(item)
        try:
            event, data = item if isinstance(item, tuple) and \
                len(item) == 2 else (str(item), None)
            self._fh.write(json.dumps(
                {"t": self._now(), "event": event, "data": data},
                default=repr) + "\n")
        except Exception:
            pass          # a full disk must not take down consensus


def build_node(name: str, base_dir: str, backend: str = "cuda",
               kv: str = "file", record: bool = False):
    """-> (prodable, node, registry) ready for a Looper."""
    from plenum_tpu_torch.common.node_messages import POOL_LEDGER_ID
    from plenum_tpu_torch.common.timer import QueueTimer
    from plenum_tpu_torch.config import load_config
    from plenum_tpu_torch.network.sealed_client import SealedClientStack
    from plenum_tpu_torch.network.tcp_stack import NodeRegistry, TcpStack
    from plenum_tpu_torch.node import Node, NodeBootstrap
    from plenum_tpu_torch.node.looper import Prodable
    from plenum_tpu_torch.tools.genesis import load_genesis_files
    from plenum_tpu_torch.tools.keygen import load_keys

    # operator overrides ride one env var of JSON (the reference layers
    # /etc + network + user config the same way, common/config_util.py);
    # unknown keys fail loudly in load_config. Merged FIRST so every
    # consumer below — data_dir, the bootstrap's crypto plane, the
    # stacks — sees ONE config, never a CLI/env split.
    overrides = json.loads(os.environ.get("PLENUM_CONFIG_JSON", "{}"))
    config = load_config({"crypto_backend": backend, "kv_backend": kv},
                         overrides)
    backend, kv = config.crypto_backend, config.kv_backend

    keys = load_keys(base_dir, name)
    genesis = load_genesis_files(base_dir)

    registry = NodeRegistry()
    my_ha = my_client_ha = None
    for txn in genesis[POOL_LEDGER_ID]:
        data = txn["txn"]["data"]["data"]
        alias = data["alias"]
        registry.set(alias, data["node_ip"], data["node_port"],
                     bytes.fromhex(data["verkey"]))
        if alias == name:
            my_ha = (data["node_ip"], data["node_port"])
            my_client_ha = (data["client_ip"], data["client_port"])
    if my_ha is None:
        raise SystemExit(f"{name} is not in the pool genesis")

    if kv not in ("file", "memory", "native", "chunked"):
        raise SystemExit(f"unknown kv backend {kv!r}")
    data_dir = os.path.join(base_dir, name, "data") if kv != "memory" \
        else None
    # "file" keeps the historical meaning "durable, best engine" (the
    # bootstrap's default picks the native store with file fallback);
    # "native"/"chunked" select those engines explicitly
    storage_backend = kv if kv in ("native", "chunked") else "native"
    # a node process on the card rides the plane supervisor, as the
    # reference's device nodes do: it outlives a card fault on CPU
    # verdicts, and the supervisor's counters reach the metrics history;
    # warmed before the node takes work, so no deadline sees the card's
    # first dispatch
    verifier = None
    if backend == "cuda":
        from plenum_tpu_torch.crypto.ed25519 import make_verifier, warm_up
        verifier = warm_up(make_verifier("cuda", supervised=True))
    components = NodeBootstrap(
        name, genesis_txns=genesis, data_dir=data_dir,
        crypto_backend=backend, storage_backend=storage_backend,
        verifier=verifier,
        bls_seed=bytes.fromhex(keys["bls_seed"]),
        # commitment scheme rides the ONE config (PLENUM_CONFIG_JSON
        # {"STATE_COMMITMENT": "verkle"}) — the whole pool must agree,
        # and an observer follows with start_observer --state-commitment
        state_commitment=config.STATE_COMMITMENT,
        state_commitment_per_ledger=config.STATE_COMMITMENT_PER_LEDGER,
        verkle_width=config.VERKLE_WIDTH).build()
    timer = QueueTimer(time.perf_counter)
    # durable metrics history next to the node's keys so operators can run
    # tools.metrics_report after (or during) a run — the reference flushes
    # to a RocksDB metrics store the same way (KvStoreMetricsCollector,
    # common/metrics_collector.py:428) and analyzes it with process_logs.
    # Kept even with --kv memory: the node data may be ephemeral, but the
    # performance history is what post-mortems need.
    from plenum_tpu_torch.common.metrics import KvMetricsCollector
    from plenum_tpu_torch.storage.kv_file import KvFile
    metrics = KvMetricsCollector(
        KvFile(os.path.join(base_dir, name, "metrics")))
    # durable text log (WARNING+ from transport/services) next to the
    # keys: the error-clustering half of tools.log_analyzer reads it
    # (the reference analyzes node logs with scripts/process_logs)
    import logging
    lh = logging.FileHandler(os.path.join(base_dir, name, "node.log"))
    lh.setLevel(logging.WARNING)
    lh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s"))
    logging.getLogger().addHandler(lh)
    node_stack = TcpStack(name, my_ha[0], my_ha[1], registry,
                          seed=bytes.fromhex(keys["seed"]))
    # the client port seals any connection that asks for it under the
    # node's key, as the reference's CurveZMQ client stack does
    client_stack = SealedClientStack(
        name, my_client_ha[0], my_client_ha[1], on_request=None,
        seed=bytes.fromhex(keys["seed"]),
        max_connections=config.MAX_CONNECTED_CLIENTS,
        idle_timeout=config.CLIENT_CONN_IDLE_TIMEOUT)
    # flight recorder: per-digest span ring + anomaly auto-dumps next to
    # the keys (<node>/<node>-flight-N.json). clock_domain="wall": each
    # OS process runs its own perf_counter epoch, so the tracer anchors
    # its monotonic timeline to time.time() once at construction and
    # tools.trace_report aligns the pool's dumps from those anchors.
    from plenum_tpu_torch.common.tracing import make_tracer
    tracer = make_tracer(name, timer.get_current_time, config=config,
                         dump_dir=os.path.join(base_dir, name),
                         clock_domain="wall", wall=time.time)
    node = Node(name, timer, node_stack.bus, components,
                client_send=client_stack.send, config=config,
                metrics=metrics, tracer=tracer)
    # live fleet telemetry: snapshots spool next to the keys as a
    # rotating atomic window (<node>/telemetry/<node>-telemetry-N.json)
    # so tools.fleet_console can follow a live TCP pool from disk
    # without touching the process
    if node.telemetry.enabled:
        node.telemetry.spool_dir = os.path.join(base_dir, name, "telemetry")
    # durable structured event log: every spylog entry (view changes,
    # catchups, suspicions, VC stall phases) appends a JSONL row that
    # tools.log_analyzer turns into per-view timelines. Seeded with the
    # entries the constructor already traced (audit restore etc.).
    node.spylog = _DurableSpylog(
        os.path.join(base_dir, name, "events.jsonl"),
        now=time.time, seed=node.spylog)
    # late-bound: the recorder may wrap handle_client_message below, and the
    # client stack must call through the WRAPPED method
    client_stack._on_request = \
        lambda msg, frm: node.handle_client_message(msg, frm)
    # observer eviction must close the connection so the follower redials
    node.observable._close = client_stack._drop_client
    # observer pushes pack the batch once, not once per registered observer
    node.observable._send_many = client_stack.send_many

    # transport stats -> metrics history: dropped frames/sessions (silent
    # loss) and per-type tx/rx byte counters, flushed as cumulative gauges
    # that tools.metrics_report reads back (max = total)
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.common.timer import RepeatingTimer

    def sample_transport_stats():
        s = node_stack.stats
        metrics.add_event(MetricsName.TRANSPORT_DROPPED_FRAMES,
                          s["dropped_frames"])
        metrics.add_event(MetricsName.TRANSPORT_DROPPED_SESSIONS,
                          s["dropped_sessions"])
        for direction, table in (("tx", s["tx_msgs"]), ("rx", s["rx_msgs"])):
            total = 0
            for op, (count, nbytes) in table.items():
                total += nbytes
                metrics.add_event(f"transport.{direction}.{op}", nbytes)
                metrics.add_event(f"transport.{direction}_count.{op}", count)
            metrics.add_event(MetricsName.TRANSPORT_TX_BYTES if
                              direction == "tx" else
                              MetricsName.TRANSPORT_RX_BYTES, total)

    node._transport_stats_timer = RepeatingTimer(
        timer, config.METRICS_FLUSH_INTERVAL, sample_transport_stats)
    # the SIGTERM tail-flush must carry the FINAL totals too
    node._sample_transport_stats = sample_transport_stats

    if record:
        # the reference's STACK_COMPANION=1 mode: record every ingress +
        # prod tick durably so tools.replay can re-run this node offline
        from plenum_tpu_torch.node.recorder import Recorder, attach_recorder
        from plenum_tpu_torch.storage.kv_file import KvFile
        rec_dir = os.path.join(base_dir, name, "recorder")
        attach_recorder(node, Recorder(KvFile(rec_dir),
                                       now=timer.get_current_time))

    def sync_registry_from_pool():
        """Pool-ledger NODE txns drive the transport allowlist + dialing
        (ref kit_zstack connectToMissing / pool_manager reconnect)."""
        members = set(node.pool_manager.node_names)
        for alias in members:
            info = node.pool_manager.node_info(alias) or {}
            vk = info.get("verkey")
            if vk and "node_ip" in info:
                registry.set(alias, info["node_ip"], info["node_port"],
                             bytes.fromhex(vk))
        for alias in registry.names():
            if alias not in members:
                registry.remove(alias)
        node_stack.maintain_connections()

    node.on_pool_changed_callbacks.append(sync_registry_from_pool)
    return Prodable(node, node_stack, client_stack, timer), node, registry


def main(argv=None):
    from plenum_tpu_torch.node.looper import Looper

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", required=True)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--backend", default="cuda",
                    choices=["cpu", "cuda", "service", "torch"])
    ap.add_argument("--kv", default="file",
                    choices=["file", "memory", "native", "chunked"])
    ap.add_argument("--record", action="store_true",
                    help="record all ingress for offline replay")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="run under cProfile; dump pstats to PATH on SIGTERM"
                         " (feeds tools.perf_budget — the Amdahl breakdown)")
    args = ap.parse_args(argv)

    prodable, node, _ = build_node(args.name, args.base_dir, args.backend,
                                   args.kv, record=args.record)
    # host-span sessions on request: SIGUSR1 opens one, SIGUSR2 closes it
    # and writes its figures next to the keys (common/host_spans.py)
    from plenum_tpu_torch.common.host_spans import serve_sessions
    serve_sessions(prodable, os.path.join(args.base_dir, args.name,
                                          "host_spans.json"))
    import signal as _signal
    profiler = None
    if args.profile:
        import cProfile
        # CPU-time timer, not wall: bench pools timeshare one core, and a
        # wall-clock profile would charge each function for time spent
        # preempted (sum across N processes then exceeds wall by ~Nx).
        # process_time counts only cycles this process actually burned.
        profiler = cProfile.Profile(time.process_time)
        profiler.enable()

    # SIGTERM only SETS a flag: the tail work (profiler dump + metrics
    # flush) runs from the event loop below, where no accumulator can be
    # mid-mutation — flushing from signal context raced add_event and
    # could silently lose the tail flush. Escalation keeps a WEDGED node
    # killable: a second SIGTERM (or the alarm if the loop never polls
    # the flag) hard-exits without the tail flush.
    term = {"requested": False}

    def _request_term(signum, frame):
        if term["requested"]:           # second SIGTERM: loop is stuck
            os._exit(143)
        term["requested"] = True
        _signal.alarm(10)               # loop dead -> SIGALRM hard-exits

    _signal.signal(_signal.SIGALRM, lambda s, f: os._exit(143))

    def _finalize_and_exit():
        # the loop is provably alive here — stand down the dead-loop
        # alarm so a >10s flush isn't hard-killed mid-append (a second
        # SIGTERM still escalates if the flush itself wedges)
        _signal.alarm(0)
        if profiler is not None:
            profiler.disable()
            profiler.dump_stats(args.profile)
        try:
            # capture the tail of the run: gauges + accumulators since the
            # last periodic flush would otherwise die with the process
            node._sample_transport_stats()
            node._flush_metrics()
        except Exception:
            pass
        try:
            # the flight-recorder ring's last seconds go to disk too, so
            # a pool torn down mid-incident still yields waterfalls
            node.tracer.dump()
        except Exception:
            pass
        # 128+SIGTERM: supervisors must see termination, not a clean exit
        os._exit(143)

    _signal.signal(_signal.SIGTERM, _request_term)
    looper = Looper()
    looper.add(prodable)

    async def forever():
        print(json.dumps({"started": args.name,
                          "node_port": prodable.node_stack.port,
                          "client_port": prodable.client_stack.port}),
              flush=True)
        last_status = time.monotonic()
        while True:
            await asyncio.sleep(0.25)
            if term["requested"]:
                _finalize_and_exit()
            if time.monotonic() - last_status >= 60:
                last_status = time.monotonic()
                info = node.validator_info()
                print(json.dumps(
                    {"uptime": round(info["uptime"], 1),
                     "last_ordered_3pc": info["last_ordered_3pc"],
                     "connected": info["connected"]}), flush=True)

    looper.run(forever())


if __name__ == "__main__":
    main()
