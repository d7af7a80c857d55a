"""Run a real-time N-node pool in one process and measure write throughput.

This is the framework's equivalent of standing up the reference's 4-node local
pool under NYM load and reading the Monitor (BASELINE.md's prescription for
producing the north-star numbers). Nodes are real Node instances over
SimNetwork with microsecond latencies; time is REAL (QueueTimer over
perf_counter), so the printed TPS/latency are wall-clock measurements of the
full pipeline: client authN -> propagate quorum -> 3PC (with BLS signing and
order-time aggregate verification) -> execute -> REPLY.

Usage:  python -m plenum_tpu_torch.tools.local_pool --nodes 4 --txns 200 \
            --backend cpu|cuda|cuda-percall|torch [--json]

Backends: "cuda" (run_load's default) verifies every client signature on
the card, K3 + K4 through the shared ring; "torch" is the same ring on the
kernels' plain versions on the CPU (tests: keep its buckets small through
config_overrides); "cpu" is the host baseline, with no ring.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time


def pool_bls_keys(names) -> dict:
    """node name -> BLS verkey under the name-seeded derivation every
    in-process genesis uses (build_genesis below, tests/test_pool.py).
    THE one copy: a verifying read client fed keys derived any other way
    would silently reject every proof and fall back to broadcast."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    return {n: BlsCryptoSigner(seed=n.encode().ljust(32, b"\0")[:32]).pk
            for n in names}


def build_genesis(names, node_data_extra=None):
    """Pool + domain genesis txns for a named node set -> (genesis, trustee).

    node_data_extra: optional {name: dict} merged into each NODE txn's data
    (the TCP runner adds node_ip/node_port/client_ip/client_port here, the
    same fields the reference pool ledger carries)."""
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                       POOL_LEDGER_ID)
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NODE, NYM, TRUSTEE

    trustee = Ed25519Signer(seed=b"local-pool-trustee".ljust(32, b"\0"))
    bls_keys = pool_bls_keys(names)
    pool_txns = []
    for i, name in enumerate(names):
        data = {"alias": name, "services": ["VALIDATOR"],
                "blskey": bls_keys[name]}
        if node_data_extra and name in node_data_extra:
            data.update(node_data_extra[name])
        txn = txn_lib.new_txn(NODE, {"dest": f"{name}Dest", "data": data})
        # genesis nodes are steward-owned by the trustee so owner-only
        # NODE edits (BLS key rotation, readdressing) are exercisable
        # against a genesis pool (churn soak, membership fuzz)
        txn["txn"].setdefault("metadata", {})["from"] = trustee.identifier
        txn_lib.set_seq_no(txn, i + 1)
        pool_txns.append(txn)
    nym = txn_lib.new_txn(NYM, {"dest": trustee.identifier,
                                "verkey": trustee.verkey_b58,
                                "role": TRUSTEE})
    txn_lib.set_seq_no(nym, 1)
    return {POOL_LEDGER_ID: pool_txns, DOMAIN_LEDGER_ID: [nym]}, trustee


def build_pool(n_nodes: int, backend: str, seed: int = 1,
               trace: bool = False, config_overrides: dict = None,
               genesis: tuple = None, rows: dict = None):
    """n_nodes Nodes on one SimNetwork and one real-time QueueTimer ->
    (names, nodes, timer, trustee, replies, Reply, DOMAIN_LEDGER_ID,
    plane, net); replies[name] lists (time, message, client) for every
    message the node sent a client.

    genesis: (genesis txns, trustee) for the names Node1..Noden,
    build_genesis's by default. rows: convert.replica_rows of one replica
    built on that genesis; every node then starts from a copy of its
    stores (convert.bootstrap_from_rows) instead of replaying the
    genesis, which at a production-size domain takes minutes."""
    from plenum_tpu_torch import convert
    from plenum_tpu_torch.common.host_spans import instrument_pool
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, Reply
    from plenum_tpu_torch.common.timer import QueueTimer
    from plenum_tpu_torch.common.tracing import Tracer
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import make_verifier
    from plenum_tpu_torch.network import SimNetwork, SimRandom
    from plenum_tpu_torch.node import Node, NodeBootstrap

    names = [f"Node{i + 1}" for i in range(n_nodes)]
    genesis, trustee = genesis if genesis is not None else \
        build_genesis(names)

    timer = QueueTimer(time.perf_counter)
    net = SimNetwork(timer, SimRandom(seed))
    net.set_latency(0.00005, 0.0002)       # LAN-ish, not the sim default 0.5s
    # 50ms partial-batch wait measured best here (fewer, fuller 3PC
    # batches amortize the per-batch BLS sign+aggregate-verify; p99
    # halves vs 5ms while p50 holds)
    config = Config(Max3PCBatchWait=0.05, crypto_backend=backend,
                    STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
                    **(config_overrides or {}))
    replies: dict[str, list] = {n: [] for n in names}
    nodes = {}
    # co-hosted nodes share ONE crypto plane: the verify kernel is
    # serial-depth bound, so n_nodes small dispatches per cycle cost
    # ~n_nodes times one combined dispatch. With CRYPTO_PIPELINE (the
    # default) that plane is the fused pipeline ring — client-auth
    # Ed25519, BLS batch checks, AND Merkle hashing all coalesce/dedup
    # across the co-hosted nodes; otherwise the legacy Ed25519-only
    # CoalescingVerifier.
    plane = None
    pipeline = None
    plane_per_node = False
    if backend == "cuda-percall":
        # A/B baseline arm: every node runs its own supervised device
        # verifier and every call site's batch dispatches ALONE — the
        # pre-pipeline per-call behavior the coalescing win is measured
        # against
        config = config.replace(crypto_backend="cuda",
                                CRYPTO_PIPELINE=False)
        backend = "cuda"
        plane_per_node = True
    elif backend in ("cuda", "torch"):
        from plenum_tpu_torch.crypto.ed25519 import CoalescingVerifier
        # one shape covering the coalesced steady state: every node can
        # stage a full CLIENT quota and a full PROPAGATE quota in the same
        # cycle, so the ring's bucket ladder reaches the next power of two
        # covering both
        per_node = (config.LISTENER_MESSAGE_QUOTA
                    + config.REMOTES_MESSAGE_QUOTA)
        bucket = 1
        while bucket < n_nodes * per_node:
            bucket *= 2
        # supervised, and the run reports its counters: a device wedge
        # mid-bench degrades the pool to CPU-speed verdicts (breaker +
        # hedged fallback) instead of blanking the run — the bench line
        # then reports backend_state and fallback_batches
        if config.CRYPTO_PIPELINE:
            from plenum_tpu_torch.parallel.pipeline import \
                make_crypto_pipeline
            # the factory takes the reference's three arms: the federated
            # ring when PIPELINE_REMOTE_HOSTS rosters crypto hosts, one
            # breakable lane per device when PIPELINE_DEVICES != 1 (on
            # "torch" CPU lanes), else the single-device ring; it owns
            # the shape policy: its pinned bucket ladder covers the
            # coalesced steady state
            pipeline = make_crypto_pipeline(
                config.replace(PIPELINE_MAX_BUCKET=max(
                    bucket, config.PIPELINE_MAX_BUCKET)),
                backend, supervised=True)
            plane = pipeline.verifier()
        else:
            plane = CoalescingVerifier(
                make_verifier(backend, supervised=True))
    for name in names:
        bus = net.create_peer(name)
        kw = dict(
            genesis_txns=genesis, crypto_backend=backend,
            # cuda-percall: each node its own supervised verifier (the
            # port's make_verifier leaves the card's bare unless asked)
            verifier=(make_verifier(backend, supervised=True)
                      if plane_per_node else
                      None if pipeline is not None else plane),
            pipeline=pipeline,
            state_commitment=config.STATE_COMMITMENT,
            state_commitment_per_ledger=config.STATE_COMMITMENT_PER_LEDGER,
            verkle_width=config.VERKLE_WIDTH)
        components = (NodeBootstrap(name, **kw) if rows is None else
                      convert.bootstrap_from_rows(name, rows, **kw)).build()
        # traced runs carry real Tracers (shared in-process clock, so
        # assembly alignment is the identity); untraced runs keep the
        # NullTracer fast path and stay the honest TPS figures
        tracer = Tracer(name, timer.get_current_time,
                        clock_domain="shared") if trace else None
        nodes[name] = Node(
            name, timer, bus, components,
            client_send=lambda msg, client, n=name: replies[n].append(
                (time.perf_counter(), msg, client)),
            config=config, tracer=tracer)
    net.connect_all()
    # host spans by layer (common/host_spans.py): one attribute check a
    # call until a torch profiler session records or an operator enables
    # the recorder
    instrument_pool(nodes, timer, net)
    return (names, nodes, timer, trustee, replies, Reply, DOMAIN_LEDGER_ID,
            plane, net)


def commit_stage_stats(metrics) -> dict:
    """Post-ordering stage percentiles + pairing counters from an
    IN-PROCESS node's MetricsCollector (no flush required: the plain
    collector retains accumulators and their bounded raw samples).
    Keys match the bench line: bls_verify_ms/apply_ms/durable_ms/reply_ms
    p50+p95, pairings_per_batch, group_commit_batches."""
    from plenum_tpu_torch.common.metrics import MetricsName, percentile
    acc = metrics.accumulators
    out = {}
    for key, label in ((MetricsName.COMMIT_BLS_VERIFY_TIME, "bls_verify_ms"),
                       (MetricsName.COMMIT_APPLY_TIME, "apply_ms"),
                       (MetricsName.COMMIT_WAVE_TIME, "commit_wave_ms"),
                       (MetricsName.COMMIT_DURABLE_TIME, "durable_ms"),
                       (MetricsName.COMMIT_REPLY_TIME, "reply_ms")):
        a = acc.get(key)
        if a is not None and a.samples:
            out[f"{label}_p50"] = round(percentile(a.samples, 0.5) * 1000, 3)
            out[f"{label}_p95"] = round(percentile(a.samples, 0.95) * 1000, 3)
    for key, label in ((MetricsName.BLS_PAIRINGS_PER_BATCH,
                        "pairings_per_batch"),
                       (MetricsName.GROUP_COMMIT_BATCHES,
                        "group_commit_batches")):
        a = acc.get(key)
        if a is not None and a.count:
            out[label] = round(a.total / a.count, 2)
    return out


def run_load(n_nodes: int = 4, n_txns: int = 200, backend: str = "cuda",
             timeout: float = 120.0, trace: bool = False,
             config_overrides: dict = None, window: int = 256,
             on_pin=None) -> dict:
    """window: max requests in flight while feeding. 256 floods the
    pipeline (the headline shape); small windows trickle config7-style
    per-tick batches (the pipeline A/B's coalescing measurement).
    on_pin: called with the pool's ring once it is warmed and pinned,
    just before the timed phase (the port's hook for reading the ring's
    counters over that phase)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM

    (names, nodes, timer, trustee,
     replies, Reply, DOMAIN_LEDGER_ID, plane, net) = build_pool(
         n_nodes, backend, trace=trace, config_overrides=config_overrides)

    # pre-sign the whole workload so client-side signing isn't measured
    requests = []
    for i in range(n_txns):
        user = Ed25519Signer(seed=(b"lpu%d" % i).ljust(32, b"\0")[:32])
        req = Request(trustee.identifier, i + 1,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        req.signature = trustee.sign_b58(req.signing_bytes())
        requests.append(req)

    def prod_all():
        timer.service()
        for node in nodes.values():
            node.prod()
        if plane is not None:
            # every node has staged its cycle's signatures: one dispatch
            plane.flush()

    # warmup: one txn end-to-end (builds and loads the kernels' library,
    # fills the per-verkey point caches)
    warm = requests.pop()
    submit_times = {}
    for n in names:
        nodes[n].handle_client_message(warm.to_dict(), "warmup")
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        prod_all()
        if any(isinstance(m, Reply) for _, m, _ in replies[names[0]]):
            break
    for n in names:
        replies[n].clear()

    # pipeline warmup contract: run the pad buckets steady state will
    # dispatch WHILE THE CLOCK IS NOT RUNNING, then pin — after pin() the
    # ring only selects warmed shapes (pad up / split), so the timed
    # phase sees no first-use cost of a shape. The warmup txn above only
    # reaches the smallest bucket.
    pipe = getattr(plane, "_pipeline", None) if plane is not None else None
    if pipe is not None:
        pipe.prewarm(pipe.buckets[:2])
        # cmt ladder for the fused commit wave: level flushes across the
        # co-hosted replicas dedup to small job counts, so a short pow-2
        # ladder covers steady state (bigger levels split at the cap)
        pipe.prewarm_cmt([1, 2, 4, 8])
        pipe.pin()
        if on_pin is not None:
            on_pin(pipe)

    n_txns = len(requests)
    t_start = time.perf_counter()
    next_submit = 0
    done = 0
    first_reply: dict[str, float] = {}
    deadline = time.perf_counter() + timeout
    while done < n_txns and time.perf_counter() < deadline:
        # feed in chunks so the propagate pipeline stays busy but inboxes
        # don't balloon
        while next_submit < n_txns and next_submit - done < window:
            req = requests[next_submit]
            submit_times[req.digest] = time.perf_counter()
            for n in names:
                nodes[n].handle_client_message(req.to_dict(), "bench")
            next_submit += 1
        prod_all()
        for ts, msg, _client in replies[names[0]]:
            if isinstance(msg, Reply):
                digest = msg.result.get("txn", {}).get("metadata", {}) \
                    .get("digest")
                if digest and digest not in first_reply:
                    first_reply[digest] = ts
        done = len(first_reply)
    t_total = time.perf_counter() - t_start

    latencies = sorted(first_reply[d] - submit_times[d]
                       for d in first_reply if d in submit_times)
    sizes = {nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size for n in names}
    stage = commit_stage_stats(nodes[names[0]].metrics)
    trace_summary = None
    if trace:
        # assemble the per-node rings into the bench line's waterfall
        # summary, and check stage sums against the MEASURED client e2e
        # latency (submit -> first REPLY) — both ride one process clock
        from plenum_tpu_torch.common.metrics import percentile
        from plenum_tpu_torch.tools.trace_report import assemble, summarize
        report = assemble([nodes[n].tracer.snapshot() for n in names])
        trace_summary = summarize(report)
        ratios = []
        for digest, per_node in report["requests"].items():
            e2e = (first_reply.get(digest, 0.0)
                   - submit_times.get(digest, 0.0))
            wf = per_node.get(names[0])
            if wf is not None and e2e > 0:
                ratios.append(wf["total"] / e2e)
        if ratios:
            trace_summary["stage_sum_vs_e2e_p50"] = round(
                percentile(ratios, 0.5), 4)
    plane_stats = None
    pipeline_summary = None
    if plane is not None:
        from plenum_tpu_torch.parallel.supervisor import find_supervisor
        sup = find_supervisor(plane)
        if sup is not None:
            st = sup.supervisor_stats()
            plane_stats = {k: st[k] for k in
                           ("breaker_state", "breaker_opens",
                            "fallback_batches", "hedge_wins",
                            "deadline_misses", "device_batches")}
        pipe = getattr(plane, "_pipeline", None)
        if pipe is not None:
            pipeline_summary = pipe.summary()
    percall = None
    if backend == "cuda-percall":
        # baseline arm: per-call dispatch accounting straight from each
        # node's supervised verifier (device_items are REAL items — the
        # inner pads after the supervisor counts)
        from plenum_tpu_torch.parallel.supervisor import find_supervisor
        tb = ti = 0
        for n in names:
            v = getattr(nodes[n].c.authenticator.core_authenticator,
                        "verifier", None)
            sup = find_supervisor(v)
            if sup is not None:
                tb += sup.stats["device_batches"]
                ti += sup.stats["device_items"]
        percall = {"device_batches": tb, "device_items": ti,
                   "items_per_dispatch": round(ti / tb, 2) if tb else 0.0}
    # controller trajectory from the master PRIMARY (Node1 under the
    # round-robin selector): final knob positions + the rolling per-stage
    # p50/p95 vs the SLO that put them there — the bench line's view of
    # the closed loop
    ctl = getattr(nodes[names[0]], "batch_controller", None)
    return {
        **({"trace": trace_summary} if trace_summary else {}),
        **({"pipeline": pipeline_summary} if pipeline_summary else {}),
        **({"percall": percall} if percall else {}),
        **({"controller": ctl.trajectory()} if ctl is not None else {}),
        **({"commit_stage": stage} if stage else {}),
        **({"crypto_plane": plane_stats,
            "backend_state": {"closed": "ok", "half_open": "fallback",
                              "open": "open"}[plane_stats["breaker_state"]]}
           if plane_stats else {}),
        "backend": backend,
        "nodes": n_nodes,
        "txns_ordered": done,
        "txns_requested": n_txns,
        "seconds": round(t_total, 3),
        "tps": round(done / t_total, 1) if t_total > 0 else 0.0,
        "p50_latency_ms": round(
            statistics.median(latencies) * 1000, 1) if latencies else None,
        "p99_latency_ms": round(
            latencies[int(len(latencies) * 0.99)] * 1000, 1)
        if latencies else None,
        "ledger_sizes_agree": len(sizes) == 1,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--txns", type=int, default=200)
    ap.add_argument("--backend", default="cuda",
                    choices=["cpu", "cuda", "cuda-percall", "torch"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    stats = run_load(args.nodes, args.txns, args.backend)
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"{stats['txns_ordered']}/{stats['txns_requested']} txns in "
              f"{stats['seconds']}s -> {stats['tps']} TPS "
              f"(p50 {stats['p50_latency_ms']} ms, "
              f"p99 {stats['p99_latency_ms']} ms, backend={stats['backend']})")


if __name__ == "__main__":
    main()
