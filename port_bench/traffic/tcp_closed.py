"""Closed-loop NYM writes into the tcpsvc deployment.

The system under test is the port's tcpsvc layout, through its own entry
points: a pool directory from `tools.tcp_pool.setup_pool_dir` (keygen and
genesis), one crypto host (`parallel/crypto_service.py`, run by
`port_bench/svc_host.py`) that owns the card, and one
`tools/start_node --kv file --backend service` process per validator,
which sees no GPU and ships its client signatures to the crypto host. The
nodes talk to each other over sealed TCP on 127.0.0.1; this process is the
clients, each connection to a node's client port sealed under the node's
key from the pool genesis (`network/sealed_client.py`).

On a machine of PIN_MIN_CORES or more, each process is pinned to cores of
its own (`os.sched_setaffinity`), a stand-in for separate hosts: a core a
node, two for the crypto host, the rest for the clients.

The loop keeps `in_flight` requests unanswered across the four client
ports: each request goes to every node, and counts as answered once f + 1
nodes agree, by REPLYs naming one seqNo and txnTime, or by NACKs. After
the window no request is added; the loop runs on until every request sent
has its answer and every node has answered every request (at most
`drain_s`). Then the nodes are stopped, and each node's domain ledger,
its root and its committed state root are read back from its durable
store (`port_bench.stores`) for the plain reference to judge
(`port_bench.reference.pool_check`).

Traced (`--trace 1`): at the window's edges each node opens and closes a
host-span session (SIGUSR1, SIGUSR2; `common/host_spans.serve_sessions`)
and writes it next to its keys, and the crypto host traces the card and
its own spans (`port_bench/svc_host.py`).
The crypto host's counters are read through its `stats` request at both
edges, in every run.
"""
from __future__ import annotations

import asyncio
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from port_bench import spec, stats, stores
from port_bench.reference import codec, pool_check
from port_bench.traffic import corpus
from port_bench.traffic.pool_closed import Answers

SPAN_FILE = "host_spans.json"
PIN_MIN_CORES = 8
WARM_S = 2.0          # of the closed loop before the window opens


def _trustee_secret(ctx) -> bytes:
    return ctx.conf["deployment"]["trustee_seed"].encode().ljust(32, b"\0")


class Prepared:
    """The corpus being signed and the deployment being started, both
    beside the process's own imports."""

    def __init__(self, ctx):
        n_req = ctx.params["presigned"]
        bad = corpus.corrupted_indices(ctx.seed, n_req,
                                       ctx.params["corrupt_per_1000"])
        self.making = corpus.Making(corpus.pool_slice, n_req + 1, bad,
                                    (ctx.seed, _trustee_secret(ctx)),
                                    workers=ctx.workers)
        seam = Seam()
        for hook in ctx.hooks.get("built", ()):
            hook(ctx, {"nodes": {}, "pipe": seam})
        self.dep = Deployment(ctx, tempfile.mkdtemp(prefix="pb_tcpsvc_"))
        # the crypto host first, beside this process's imports: the
        # nodes connect to it as they build
        self.dep.start_crypto_host(seam.wraps())
        self.error = None
        self.thread = threading.Thread(target=self._start, daemon=True)
        self.thread.start()

    def _start(self) -> None:
        try:
            self.dep.start()
        except BaseException as exc:          # raised again by started()
            self.error = exc

    def started(self) -> dict:
        """Wait for the deployment -> each node's client port."""
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.dep.ports

    def stop(self) -> None:
        self.making.stop()
        self.dep.stopping = True
        self.thread.join(timeout=60)
        self.dep.stop()
        shutil.rmtree(self.dep.base, ignore_errors=True)


def prepare(ctx):
    """Start signing the requests (the last one warms the pool up) and
    starting the deployment while the process loads the port. A program
    whose client port cannot seal cannot run the configuration: it fails
    here, before anything starts."""
    if not os.path.exists(os.path.join(
            spec.ROOT, "plenum_tpu_torch", "network", "sealed_client.py")):
        raise spec.SpecError("the program's client port cannot seal "
                             "(no network/sealed_client.py)")
    return Prepared(ctx)


def abandon(prepared) -> None:
    prepared.stop()


class Seam:
    """What a "built" hook of `port_bench.faults` is handed in place of
    the ring: the crypto host's verifier, which those hooks wrap
    (`pipe._ed_inner = Fault(pipe._ed_inner)`). The wrappers they leave
    are put around the crypto host's verifier in its own process."""

    class Inner:
        pass

    def __init__(self):
        self._ed_inner = self.Inner()

    def wraps(self) -> list[str]:
        out, v = [], self._ed_inner
        while not isinstance(v, self.Inner):
            out.append(type(v).__name__)
            v = v._inner
        return list(reversed(out))


class Deployment:
    """The five processes, their directory and their outputs."""

    def __init__(self, ctx, base: str):
        self.ctx, self.base = ctx, base
        self.names = [f"Node{i + 1}" for i in range(
            ctx.conf["deployment"]["nodes"])]
        self.sock = os.path.join(base, "crypto.sock")
        self.report = os.path.join(base, "svc_report.json")
        self.svc = None
        self.nodes: dict[str, subprocess.Popen] = {}
        self.ports: dict[str, int] = {}
        self.marks: dict[str, float] = {}
        self.stopping = False
        env = dict(os.environ, PYTHONPATH=spec.ROOT)
        # no setting of the environment's reaches a node: its
        # configuration is the port's Config defaults and the
        # configuration file's node_config (start_nodes)
        env.pop("PLENUM_CONFIG_JSON", None)
        self.env = env

    def start(self) -> None:
        """The pool directory, then, once the crypto host has bound its
        socket, the nodes, which connect to it as they build."""
        from plenum_tpu_torch.tools.tcp_pool import setup_pool_dir
        p = self.ctx.params
        setup_pool_dir(self.base, self.names, _trustee_secret(self.ctx))
        self.marks["pool_dir"] = time.perf_counter()
        self.wait_crypto_host(p["start_timeout_s"])
        self.marks["crypto_host"] = time.perf_counter()
        self.start_nodes()
        self.ports = self.wait_nodes(p["start_timeout_s"])
        self.marks["nodes"] = time.perf_counter()

    def _log(self, who: str):
        return open(os.path.join(self.base, f"{who}.log"), "wb")

    def start_crypto_host(self, wraps: list[str]) -> None:
        inner = "cuda" if self.ctx.backend == "cuda" else self.ctx.backend
        dep = self.ctx.conf["deployment"]
        cmd = [sys.executable, "-m", "port_bench.svc_host",
               "--report", self.report]
        if self.ctx.trace:
            cmd.append("--trace")
        for name in wraps:
            cmd += ["--wrap", name]
        cmd += ["--", "--socket", self.sock, "--backend", inner,
                "--min-batch", str(dep["crypto_host_min_batch"])]
        cmd += self.ctx.params.get("service_args", [])
        env = self.env if inner.startswith("cuda") else \
            dict(self.env, CUDA_VISIBLE_DEVICES="")
        with self._log("crypto_host") as log:
            self.svc = subprocess.Popen(cmd, env=env, cwd=spec.ROOT,
                                        stdout=log, stderr=subprocess.STDOUT)
        self.pin(self.svc.pid, "crypto_host")

    def wait_crypto_host(self, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        while not os.path.exists(self.sock):
            if self.svc.poll() is not None:
                raise RuntimeError("the crypto host exited at start: "
                                   + self.tail("crypto_host"))
            if time.perf_counter() > deadline or self.stopping:
                raise RuntimeError("the crypto host never bound its socket")
            time.sleep(0.05)

    def start_nodes(self) -> None:
        dep = self.ctx.conf["deployment"]
        env = dict(self.env, CUDA_VISIBLE_DEVICES="",
                   PLENUM_CRYPTO_SOCKET=self.sock)
        # the configuration's node settings, the one way start_node takes
        # any (a JSON object of Config keys; unknown keys fail its start)
        if self.ctx.conf.get("node_config"):
            env["PLENUM_CONFIG_JSON"] = json.dumps(
                self.ctx.conf["node_config"])
        for name in self.names:
            cmd = [sys.executable, "-m", "plenum_tpu_torch.tools.start_node",
                   "--name", name, "--base-dir", self.base,
                   "--kv", dep["node_kv"], "--backend", dep["node_backend"]]
            with self._log(name) as log:
                self.nodes[name] = subprocess.Popen(
                    cmd, env=env, cwd=spec.ROOT, stdout=log,
                    stderr=subprocess.STDOUT)
            self.pin(self.nodes[name].pid, name)

    def cores(self, who: str):
        """With PIN_MIN_CORES or more: a core a node, two for the crypto
        host, the rest for this process (the clients), each a stand-in for
        a host of its own. -> the set, or None."""
        n = os.cpu_count() or 1
        if n < PIN_MIN_CORES:
            return None
        if who == "crypto_host":
            return {4, 5}
        if who == "clients":
            return set(range(6, n))
        return {self.names.index(who)}

    def pin(self, pid: int, who: str) -> None:
        cores = self.cores(who)
        if cores is not None:
            os.sched_setaffinity(pid, cores)

    def cpu_s(self) -> dict:
        """CPU seconds (user and system, every thread) each process has
        used so far: its /proc/<pid>/stat, this process's os.times()."""
        tick = os.sysconf("SC_CLK_TCK")
        out = {}
        for who, p in [("crypto_host", self.svc)] + list(self.nodes.items()):
            try:
                with open(f"/proc/{p.pid}/stat") as fh:
                    f = fh.read().rsplit(")", 1)[1].split()
                out[who] = (int(f[11]) + int(f[12])) / tick
            except (OSError, ValueError, IndexError):
                out[who] = float("nan")
        t = os.times()
        out["clients"] = t.user + t.system
        return out

    def wait_nodes(self, timeout: float) -> dict:
        """Each node's "started" line -> {name: client port}."""
        deadline = time.perf_counter() + timeout
        ports: dict[str, int] = {}
        while len(ports) < len(self.names):
            for name in self.names:
                if name in ports:
                    continue
                for line in self.text(name).splitlines():
                    if line.startswith("{") and '"started"' in line:
                        ports[name] = json.loads(line)["client_port"]
                if name not in ports and self.nodes[name].poll() is not None:
                    raise RuntimeError(f"{name} exited at start: "
                                       + self.tail(name))
            if time.perf_counter() > deadline or self.stopping:
                raise RuntimeError(f"nodes never started: "
                                   f"{sorted(set(self.names) - set(ports))}")
            time.sleep(0.05)
        return ports

    def text(self, who: str) -> str:
        try:
            with open(os.path.join(self.base, f"{who}.log"), "rb") as fh:
                return fh.read().decode(errors="replace")
        except OSError:
            return ""

    def tail(self, who: str, n: int = 2000) -> str:
        return self.text(who)[-n:]

    def signal_nodes(self, sig) -> None:
        for p in self.nodes.values():
            if p.poll() is None:
                p.send_signal(sig)

    def signal_crypto_host(self, sig) -> None:
        if self.svc is not None and self.svc.poll() is None:
            self.svc.send_signal(sig)

    def stop_nodes(self) -> dict:
        """SIGTERM (each node flushes and exits 143) -> exit codes."""
        self.signal_nodes(signal.SIGTERM)
        codes = {}
        for name, p in self.nodes.items():
            try:
                codes[name] = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[name] = p.wait()
        return codes

    def stop(self) -> None:
        for p in list(self.nodes.values()) + [self.svc]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    def read_json(self, path: str, timeout: float):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                with open(path) as fh:
                    return json.load(fh)
            except (OSError, ValueError):
                time.sleep(0.05)
        return None


def _service_stats(sock: str) -> dict:
    from plenum_tpu_torch.parallel.crypto_service import \
        ServiceEd25519Verifier
    client = ServiceEd25519Verifier(socket_path=sock)
    try:
        return client.stats()
    finally:
        client.close()


class Loop:
    """The clients: one sealed connection a node (`connect_sealed`, each
    node checked against its verkey), each request to all of them, packed
    once and sealed for each. Requests sent before the window are `warm`:
    they pace the pool into its steady state and are judged on the
    ledgers, but are neither timed nor counted."""

    def __init__(self, ports: dict, verkeys: dict, reqs: list,
                 by_digest: dict, quorum: int):
        from plenum_tpu_torch.common.serialization import pack, unpack
        self._pack, self._unpack = pack, unpack
        self.ports, self.verkeys = ports, verkeys
        self.reqs, self.by_digest = reqs, by_digest
        self.answers = Answers(quorum)
        self.sent: dict[int, float] = {}
        self.warm: set[int] = set()
        self.warm_settled = 0
        self._warm_votes: dict[int, int] = {}
        # per node, the requests it answered (a REPLY or a NACK)
        self.answered = {n: set() for n in ports}
        self.counts = {"unknown_replies": 0, "load_shed": 0}
        self.settled = asyncio.Event()
        self.conns: dict = {}

    async def connect(self) -> None:
        from plenum_tpu_torch.network.sealed_client import connect_sealed
        for name, port in self.ports.items():
            self.conns[name] = await connect_sealed(
                "127.0.0.1", port, self.verkeys[name], timeout=10.0)
        self.readers = [asyncio.get_running_loop().create_task(
            self._read(name)) for name in self.conns]

    async def close(self) -> None:
        for t in self.readers:
            t.cancel()
        for conn in self.conns.values():
            conn.close()

    def send(self, i: int, warm: bool = False) -> None:
        data = self._pack(self.reqs[i][0])
        if warm:
            self.warm.add(i)
        else:
            self.sent[i] = time.perf_counter()
        for conn in self.conns.values():
            conn.send_packed(data)

    def in_flight(self) -> int:
        """Requests sent and not yet answered by a quorum."""
        return (len(self.warm) + len(self.sent) - self.warm_settled
                - len(self.answers.answer))

    async def flush(self) -> None:
        for conn in self.conns.values():
            await conn.drain()

    def _on(self, name: str, msg: dict) -> None:
        op = msg.get("op")
        now = time.perf_counter()
        if op == "REPLY":
            result = msg.get("result", {})
            i = self.by_digest.get(result.get("txn", {}).get(
                "metadata", {}).get("digest"))
        elif op in ("REQNACK", "REJECT"):
            i = msg.get("req_id", 0) - 1
        else:
            if op == "LOAD_SHED":
                self.counts["load_shed"] += 1
            return
        if i in self.warm:
            self.answered[name].add(i)
            votes = self._warm_votes[i] = self._warm_votes.get(i, 0) + 1
            if votes == self.answers.quorum:
                self.warm_settled += 1
        elif i in self.sent:
            self.answered[name].add(i)
            if op == "REPLY":
                meta = result.get("txnMetadata", {})
                self.answers.reply(i, name, (meta.get("seqNo"),
                                             meta.get("txnTime")), now)
            else:
                self.answers.nack(i, name, now)
        else:
            self.counts["unknown_replies"] += 1
            return
        self.settled.set()

    async def _read(self, name: str) -> None:
        conn = self.conns[name]
        while True:
            msg = self._unpack(await conn.recv())
            if isinstance(msg, dict):
                self._on(name, msg)

    async def wait(self, timeout: float) -> None:
        """Until an answer arrives (or one arrived since the last wait)."""
        try:
            await asyncio.wait_for(self.settled.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self.settled.clear()

    def all_answered(self) -> bool:
        """Every request has its answer, and every node answered each."""
        want = set(self.sent) | self.warm
        return len(self.answers.answer) == len(self.sent) and all(
            want <= got for got in self.answered.values())


async def _drive(ctx, dep: Deployment, ports, reqs, by_digest, marks,
                 trace: bool) -> dict:
    p, conf = ctx.params, ctx.conf
    n_req = p["presigned"]
    loop = Loop(ports, _node_verkeys(dep.base), reqs, by_digest,
                conf["guarantees"]["ack_quorum"])
    await loop.connect()
    in_flight = p["in_flight"]
    own_cores = os.sched_getaffinity(0)
    try:
        # warm-up: one request end to end on every node, then WARM_S of
        # the closed loop, so that the window opens on the steady state
        loop.send(n_req, warm=True)
        await loop.flush()
        deadline = time.perf_counter() + p["warm_timeout_s"]
        while not all(n_req in got for got in loop.answered.values()):
            if time.perf_counter() > deadline:
                raise RuntimeError("the warm-up request was not answered by "
                                   "every node")
            await loop.wait(0.5)
        nxt = 0
        t_warm = time.perf_counter() + WARM_S
        while time.perf_counter() < t_warm:
            while nxt < n_req and loop.in_flight() < in_flight:
                loop.send(nxt, warm=True)
                nxt += 1
            await loop.flush()
            await loop.wait(0.05)
        marks["warm"] = time.perf_counter()

        before = _service_stats(dep.sock)
        dep.pin(os.getpid(), "clients")
        cpu0 = dep.cpu_s()
        if trace:
            dep.signal_nodes(signal.SIGUSR1)
        dep.signal_crypto_host(signal.SIGUSR1)
        setup_s = time.perf_counter() - ctx.t_process
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        ran_dry = False
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            while nxt < n_req and loop.in_flight() < in_flight:
                loop.send(nxt)
                nxt += 1
            if nxt == n_req:
                ran_dry = True
            await loop.flush()
            await loop.wait(min(0.05, t_end - now))
        if trace:
            dep.signal_nodes(signal.SIGUSR2)
        dep.signal_crypto_host(signal.SIGUSR2)
        after = _service_stats(dep.sock)
        cpu1 = dep.cpu_s()

        deadline = time.perf_counter() + p["drain_s"]
        while not loop.all_answered() and time.perf_counter() < deadline:
            await loop.wait(0.25)
    finally:
        await loop.close()
        os.sched_setaffinity(0, own_cores)
    return {"loop": loop, "setup_s": setup_s, "t0": t0, "t_end": t_end,
            "ran_dry": ran_dry, "stats": (before, after),
            "cpu_share": {k: (cpu1[k] - cpu0[k]) / ctx.seconds
                          for k in cpu0}}


def _delta(before: dict, after: dict, key: str):
    if key not in before or key not in after:
        return None
    return after[key] - before[key]


def run(ctx) -> dict:
    marks = {"imported": time.perf_counter()}
    prepared = ctx.prepared if ctx.prepared is not None else prepare(ctx)
    try:
        return _run(ctx, prepared, marks)
    finally:
        prepared.stop()


def _run(ctx, prepared: Prepared, marks: dict) -> dict:
    conf, p = ctx.conf, ctx.params
    trustee_secret = _trustee_secret(ctx)
    dep = prepared.dep
    reqs = prepared.making.get()
    by_digest = {d: i for i, (_, d, _) in enumerate(reqs)}
    gc.freeze()           # the corpus is the benchmark's, not the pool's
    marks["corpus"] = time.perf_counter()
    ports = prepared.started()
    marks.update(dep.marks)
    _check_genesis(dep, trustee_secret)
    if ctx.trace:
        # the crypto host's profiler is set up before the window opens
        if dep.read_json(dep.report + ".ready", p["start_timeout_s"]) \
                is None:
            raise RuntimeError("the crypto host's trace was never ready")
        marks["trace_ready"] = time.perf_counter()

    got = asyncio.run(_drive(ctx, dep, ports, reqs, by_digest, marks,
                             ctx.trace))
    loop, t_end = got["loop"], got["t_end"]
    before, after = got["stats"]
    svc_report = dep.read_json(dep.report, 120.0)
    final_stats = _service_stats(dep.sock)
    sessions = {}
    if ctx.trace:
        for name in dep.names:
            sessions[name] = dep.read_json(
                os.path.join(dep.base, name, SPAN_FILE), 30.0)
    codes = dep.stop_nodes()
    for hook in ctx.hooks.get("stopped", ()):
        hook(ctx, {"base": dep.base, "names": dep.names})
    outputs = {name: stores.read_domain(dep.base, name)
               for name in dep.names}
    plane = final_stats.get("plane", {})
    off_card = plane.get("fallback_batches", 0) + plane.get("hedge_wins", 0)
    off_card += sum(_node_off_card(dep.base, name) for name in dep.names)

    sent, answer = loop.sent, loop.answers.answer
    checks = pool_check.judge(
        reqs=reqs, sent=sent, answer=answer, outputs=outputs,
        trustee_vk=corpus.verkey_of(trustee_secret), seed=ctx.seed,
        sample=p["reference_sample"],
        genesis_txns=conf["deployment"]["domain_txns_at_start"])
    checks["ran_dry"] = int(got["ran_dry"])
    checks["off_card_waves"] = off_card
    checks["stray_replies"] = loop.counts["unknown_replies"]
    checks["load_shed"] = loop.counts["load_shed"]
    checks["node_unanswered"] = sum(len((set(sent) | loop.warm) - got_)
                                    for got_ in loop.answered.values())
    checks["service_errors"] = final_stats.get("errors", 0)
    checks["node_exits"] = sum(1 for c in codes.values()
                               if c not in (143, -signal.SIGTERM))

    acked_in_window = sum(1 for a in answer.values()
                          if a[0] == "ack" and a[2] <= t_end)
    lat = [answer[i][2] - t for i, t in sent.items()
           if t < t_end and i in answer and answer[i][0] == "ack"]
    per_s = [0] * int(ctx.seconds)
    for a in answer.values():
        k = int(a[-1] - got["t0"])
        if a[0] == "ack" and 0 <= k < len(per_s):
            per_s[k] += 1
    failed = sum(1 for i in sent if i not in answer
                 or (answer[i][0] == "ack") != reqs[i][2])
    svc_window = {k: _delta(before, after, k) for k in (
        "items", "cache_hits", "dispatches", "dispatched_items",
        "dispatched_keys", "queued_jobs", "queue_wait_s", "batches")}
    node1 = sessions.get(dep.names[0]) or {}
    report = svc_report or {}
    return {
        "setup_s": got["setup_s"],
        "window_s": ctx.seconds,
        "end_to_end": {"write_tps": stats.rate(acked_in_window,
                                               ctx.seconds)},
        "attempted": len(sent),
        "failed": failed,
        "checks": {k: (v, 0) for k, v in checks.items()},
        "memory_peak_bytes": report.get("memory_peak_bytes", 0),
        "trace": report.get("trace"),
        "notes": [
            f"writes acked in the window: {acked_in_window}; latency "
            f"samples: {len(lat)}; sent: {len(sent)}; corrupted sent: "
            f"{sum(1 for i in sent if not reqs[i][2])}",
            "crypto host over the window: " + ", ".join(
                f"{k} {v}" for k, v in svc_window.items()),
            f"node1 session: {node1.get('txns')} txns in "
            f"{node1.get('batches')} 3PC batches; node exit codes {codes}",
            f"writes acked a second over the window: {per_s}; warm-up "
            f"writes: {len(loop.warm)}",
            "CPU over the window, cores: " + ", ".join(
                f"{k} {v:.3f}" for k, v in got["cpu_share"].items()),
            "set-up milestones (s from the process's start): "
            + ", ".join(f"{k} {v - ctx.t_process:.3f}" for k, v in
                        sorted(marks.items(), key=lambda kv: kv[1]))],
        "collected": {
            "latencies_s": lat,
            "sessions": sessions,
            "ordered_batches": node1.get("batches"),
            "ordered_txns": node1.get("txns"),
            "svc_window": svc_window,
            "svc_report": svc_report},
    }


def _node_off_card(base: str, name: str) -> int:
    """Batches a stopped node verified off the crypto host: its service
    verifier's supervisor's CPU fallbacks and hedge wins, from the metrics
    store it flushed on SIGTERM (tools/metrics_report)."""
    from plenum_tpu_torch.tools.metrics_report import (derive_summary,
                                                       fold_rows, read_store)
    summary = derive_summary(fold_rows(read_store(
        os.path.join(base, name, "metrics"))), 0.0)
    return (summary.get("crypto_fallback_batches", 0)
            + summary.get("crypto_hedge_wins", 0))


def _node_verkeys(base: str) -> dict:
    """Each node's Ed25519 verkey, from the pool genesis."""
    from plenum_tpu_torch.common.node_messages import POOL_LEDGER_ID
    from plenum_tpu_torch.network.sealed_client import node_verkeys
    from plenum_tpu_torch.tools.genesis import load_genesis_files
    return node_verkeys(load_genesis_files(base)[POOL_LEDGER_ID])


def _check_genesis(dep: Deployment, trustee_secret: bytes) -> None:
    """The pool's genesis trustee is the configuration's trustee_seed."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.tools.genesis import load_genesis_files
    genesis = load_genesis_files(dep.base)[DOMAIN_LEDGER_ID]
    vk = corpus.verkey_of(trustee_secret)
    dests = {t["txn"]["data"].get("dest") for t in genesis}
    if codec.did_of(vk) not in dests:
        raise RuntimeError("the pool's genesis trustee is not the "
                           "configuration's trustee_seed")
