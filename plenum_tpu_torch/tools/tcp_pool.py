"""Real-transport pool benchmark: N OS processes over TCP under write load.

The in-process benchmark (tools/local_pool.py) measures the consensus
pipeline over the deterministic sim fabric; THIS tool stands up the same
pool the way an operator would — keygen + genesis + one start_node process
per validator, authenticated-encrypted TCP between them (network/tcp_stack)
— and drives pre-signed NYM writes through the client ports with a
pipelined streaming client, reporting wall-clock TPS and commit latency.
This is the framework's analog of benchmarking the reference's
scripts/start_plenum_node x4 localhost pool.

    python -m plenum_tpu_torch.tools.tcp_pool --nodes 4 --txns 200 [--json]
        [--backend service:cuda|service:cuda-sharded|service:cpu|cuda|cpu]

The default, service:cuda, is the tcpsvc topology on the card: one
crypto-service process owns the GPU and verifies every node's client
signatures; the node processes see no GPU.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def setup_pool_dir(base: str, names: list[str], trustee_seed: bytes):
    """keygen + genesis files for a localhost pool -> port specs."""
    from plenum_tpu_torch.tools import genesis as gen
    from plenum_tpu_torch.tools import keygen

    ports = _free_ports(2 * len(names))
    specs = []
    for i, name in enumerate(names):
        keygen.save_keys(keygen.generate_keys(
            name, seed=(b"tcppool%d" % i).ljust(32, b"\0")), base)
        specs.append((name, "127.0.0.1", ports[2 * i], ports[2 * i + 1]))
    gen.build_genesis_files(base, specs, trustee_seed)
    return specs


def _wait_all_started(procs, deadline_s: float) -> None:
    """Wait (bounded!) for every child to print its "started" line — a
    wedged child must fail the bench, never hang it."""
    import selectors
    deadline = time.perf_counter() + deadline_s
    sel = selectors.DefaultSelector()
    pending = {}
    for p in procs:
        os.set_blocking(p.stdout.fileno(), False)
        sel.register(p.stdout, selectors.EVENT_READ, p)
        pending[p.stdout.fileno()] = b""
    try:
        while pending:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise RuntimeError(
                    f"{len(pending)} node(s) never reported 'started'")
            for key, _ in sel.select(timeout=remaining):
                fd = key.fileobj.fileno()
                chunk = key.fileobj.read() or b""
                buf = pending[fd] + chunk
                if b"started" in buf:
                    sel.unregister(key.fileobj)
                    del pending[fd]
                elif key.data.poll() is not None:
                    raise RuntimeError(
                        f"node exited before starting: {buf!r}")
                else:
                    pending[fd] = buf
    finally:
        sel.close()
        for p in procs:
            if p.poll() is None:
                os.set_blocking(p.stdout.fileno(), True)


async def drive_load(addrs, f, requests, window: int, timeout: float):
    """-> (done {key: t_done}, submit_times {key: t_sent})."""
    from plenum_tpu_torch.client.pipelined import PipelinedPoolClient
    client = PipelinedPoolClient(addrs, f)
    return await client.drive(requests, window=window, timeout=timeout)


def run_tcp_pool(n_nodes: int = 4, n_txns: int = 200,
                 backend: str = "service:cuda",
                 base_dir: str | None = None, timeout: float = 120.0,
                 profile_dir: str | None = None,
                 service_min_batch: int | None = None,
                 window: int = 100,
                 config_overrides: dict | None = None) -> dict:
    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.execution.txn import NYM

    names = [f"Node{i + 1}" for i in range(n_nodes)]
    f = (n_nodes - 1) // 3
    tmp = base_dir or tempfile.mkdtemp(prefix="plenum_tcp_pool_")
    trustee_seed = b"tcp-pool-trustee".ljust(32, b"\0")
    specs = setup_pool_dir(tmp, names, trustee_seed)

    env = dict(os.environ, PYTHONPATH=REPO)
    # reproducibility: node config comes ONLY from the explicit param —
    # a stray PLENUM_CONFIG_JSON in the operator shell must not silently
    # reconfigure every bench node
    env.pop("PLENUM_CONFIG_JSON", None)
    if config_overrides:
        env["PLENUM_CONFIG_JSON"] = json.dumps(config_overrides)
    procs = []
    service_proc = None
    # "service:<inner>" runs the cross-process crypto plane: ONE process
    # owns the card/verifier, nodes ship batches to it (n co-hosted nodes
    # share one verifier and one verdict cache; parallel/crypto_service.py)
    try:
        if backend.startswith("service:"):
            inner = backend.split(":", 1)[1]
            sock_path = os.path.join(tmp, "crypto.sock")
            # the service is the card's one owner; a host-only inner
            # sees no GPU, as the nodes below
            service_env = env if inner.startswith("cuda") else \
                dict(env, CUDA_VISIBLE_DEVICES="")
            service_proc = subprocess.Popen(
                [sys.executable, "-m", "plenum_tpu_torch.parallel.crypto_service",
                 "--socket", sock_path, "--backend", inner,
                 # only the sharded plane pads (to this power of two); the
                 # single-device verifier takes every batch as it comes
                 "--min-batch", str(service_min_batch if service_min_batch
                                    else 128)],
                env=service_env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            deadline = time.perf_counter() + 240.0   # nvcc may build
            while time.perf_counter() < deadline:
                if os.path.exists(sock_path):
                    break
                if service_proc.poll() is not None:
                    raise RuntimeError("crypto service died during startup")
                time.sleep(0.2)
            else:
                raise RuntimeError("crypto service never bound its socket")
            env = dict(env, PLENUM_CRYPTO_SOCKET=sock_path)
            backend = "service"
        # a node on the card owns a CUDA context of its own; every other
        # node sees no GPU (the reference's JAX_PLATFORMS=cpu)
        node_env = env if backend == "cuda" else \
            dict(env, CUDA_VISIBLE_DEVICES="")
        for name in names:
            cmd = [sys.executable, "-m", "plenum_tpu_torch.tools.start_node",
                   "--name", name, "--base-dir", tmp, "--kv", "memory",
                   "--backend", backend]
            if profile_dir:
                cmd += ["--profile",
                        os.path.join(profile_dir, f"{name}.pstats")]
            procs.append(subprocess.Popen(
                cmd, env=node_env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        _wait_all_started(procs, deadline_s=60.0)

        wallet = Wallet("bench")
        trustee_did = wallet.add_identifier(seed=trustee_seed)
        requests = []
        for i in range(n_txns):
            user = wallet.add_identifier(
                seed=(b"tcpu%d" % i).ljust(32, b"\0")[:32])
            requests.append(wallet.sign_request(
                {"type": NYM, "dest": user,
                 "verkey": wallet.verkey_of(user)}, identifier=trustee_did))

        addrs = {name: ("127.0.0.1", spec[3])
                 for name, spec in zip(names, specs)}
        t0 = time.perf_counter()
        done, submit_times = asyncio.run(
            drive_load(addrs, f, requests, window=window, timeout=timeout))
        t_total = (max(done.values()) - t0) if done else 0.0
        lat = sorted(done[k] - submit_times[k] for k in done)
        service_stats = None
        if service_proc is not None:
            try:
                from plenum_tpu_torch.parallel.crypto_service import \
                    ServiceEd25519Verifier
                service_stats = ServiceEd25519Verifier(
                    socket_path=env["PLENUM_CRYPTO_SOCKET"]).stats()
            except Exception:
                pass
        result = {
            **({"crypto_service": service_stats} if service_stats else {}),
            "transport": "tcp", "nodes": n_nodes, "backend": backend,
            "txns_ordered": len(done), "txns_requested": n_txns,
            "seconds": round(t_total, 3),
            "tps": round(len(done) / t_total, 1) if t_total > 0 else 0.0,
            "p50_latency_ms": round(
                statistics.median(lat) * 1000, 1) if lat else None,
            "p99_latency_ms": round(
                lat[int(len(lat) * 0.99)] * 1000, 1) if lat else None,
        }
        # bytes-on-wire + loss accounting from a node's flushed metrics
        # history (SIGTERM first so the tail flush carries final totals)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        try:
            from plenum_tpu_torch.tools.metrics_report import (derive_summary,
                                                         fold_rows,
                                                         read_store)
            folds = fold_rows(read_store(os.path.join(tmp, names[0],
                                                      "metrics")))
            # one derivation (cum-as-max, propagate op set) lives in
            # metrics_report; this just renames the keys the bench wants
            summary = derive_summary(folds, 0.0)
            for src, dst in (
                    ("transport_tx_bytes_per_txn", "tx_bytes_per_txn"),
                    ("propagate_tx_bytes_per_txn",
                     "propagate_tx_bytes_per_txn"),
                    ("transport_dropped_frames", "dropped_frames"),
                    ("propagate_inbox_depth_max",
                     "propagate_inbox_depth_max")):
                if summary.get(src) is not None:
                    result[dst] = summary[src]
            # commit-path stage percentiles + pairing/group-commit counters
            # (derive_summary computes them from the flushed raw samples)
            stage = {k: summary[k] for k in summary
                     if k.startswith(("bls_verify_ms", "apply_ms",
                                      "durable_ms", "reply_ms"))
                     or k in ("pairings_per_batch",
                              "group_commit_batches_mean",
                              "plane_dispatches", "sig_batch_size_mean")}
            if stage:
                result["commit_stage"] = stage
            # plane-supervisor health: breaker state, fallback volume,
            # hedge wins, deadline distribution (degraded-mode acceptance:
            # these must be on the bench line, not buried in a KV store).
            # Gated on the breaker gauge: only configs that actually RAN a
            # device plane report a backend_state — a pure-CPU pool must
            # not claim a healthy device it never had.
            if "crypto_breaker_state" in summary:
                plane = {k: summary[k] for k in summary
                         if k.startswith(("crypto_", "deadline_ms_",
                                          "bls_batch", "bls_local"))}
                result["crypto_plane"] = plane
                result["backend_state"] = {
                    "closed": "ok", "half_open": "fallback",
                    "open": "open"}.get(
                        plane["crypto_breaker_state"], "ok")
        except Exception:
            pass                     # byte accounting is best-effort extra
        return result
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        if service_proc is not None:
            service_proc.terminate()
            try:
                service_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                service_proc.kill()
        if base_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txns", type=int, default=200)
    ap.add_argument("--backend", default="service:cuda",
                    choices=["cpu", "cuda", "torch", "service:cpu",
                             "service:cuda", "service:cuda-sharded",
                             "service:torch"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    stats = run_tcp_pool(args.nodes, args.txns, args.backend)
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"{stats['txns_ordered']}/{stats['txns_requested']} txns in "
              f"{stats['seconds']}s over TCP -> {stats['tps']} TPS "
              f"(p50 {stats['p50_latency_ms']} ms, "
              f"p99 {stats['p99_latency_ms']} ms)")


if __name__ == "__main__":
    main()
