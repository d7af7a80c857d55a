"""Churn soak: sustained writes under live membership churn, with
BOUNDED-GROWTH assertions on every in-memory structure that must not leak.

The plain soak (tools/soak.py) answers "does steady-state load leak?".
This one answers the nastier question ROADMAP item 5 asks: does the pool
leak while the WAN is degraded and the membership itself keeps changing —
demotions, re-promotions, BLS key rotations, primary demotions — for
minutes on end? Every churn event exercises exactly the structures that
have historically grown without bound (stashed future-view messages,
request state, per-view vote sets, verdict caches).

The bounded-growth verdicts come from the fleet history plane
(observability/history.py): every node's TelemetryEmitter ships its
``footprint`` section into one FleetAggregator, whose GrowthWatch fits
growth-rate trends per gauge and raises edge-triggered
``unbounded_growth`` alerts, and whose HistoryRecorder keeps a
queryable per-interval ring of the whole run. The soak FAILS if any
growth alert pages (exempt chain-growth gauges aside) — plus a
hard-cap backstop over the same ``Node.footprint()`` gauges, because a
leak that plateaus below the trend threshold but above its design cap
is still a leak:

* flight-recorder rings            (<= TRACE_RING_SIZE per node)
* metrics accumulators             (bounded name set, samples <= cap)
* stashing-router queues+discarded (<= router limit / 1000-deque)
* propagator request state / dedup map (TTL-swept)
* read-plane result cache          (bounded per-ledger shards)
* view-change + instance-change vote sets (retired per view)
* BLS sig/pending-order maps       (GC'd at stable checkpoints)

``leak_rate > 0`` injects a synthetic unbounded gauge (``leaky_stash``)
into one node's footprint source — the self-test that proves the
detector pages, and pages exactly once (edge-triggered), naming the
gauge.

Runs on SIMULATED time (MockTimer + SimNetwork under the `lossy_wan`
topology preset), so "10 minutes" means 10 simulated minutes of timer
fires and churn events, wall-bounded only by host speed.

    python -m plenum_tpu_torch.tools.churn_soak --seconds 600 [--backend cpu] [--json]

The fast tier-1 smoke (tests/test_torch_resilience.py) runs the same loop for
a few sim-minutes; the full 10-minute run is the `soak`-marked test.
"""
from __future__ import annotations

import argparse
import json


def _bounds_snapshot(pool) -> dict:
    """One sample of every bounded-growth structure, max across nodes.

    The per-structure walk lives in ``Node.footprint()`` now — the same
    gauges the telemetry footprint section ships — so the soak, the
    emitter, and the aggregator's growth trends all read ONE
    accounting. Only the metrics-collector internals (not footprint
    gauges: they meter the meter) stay hand-sampled here.
    """
    out = {"metrics_accs": 0, "metrics_samples_max": 0}
    for node in pool.nodes.values():
        for gauge, value in node.footprint().items():
            out[gauge] = max(out.get(gauge, 0), value)
        accs = node.metrics.accumulators
        out["metrics_accs"] = max(out["metrics_accs"], len(accs))
        out["metrics_samples_max"] = max(
            out["metrics_samples_max"],
            max((len(a.samples or ()) for a in accs.values()), default=0))
    return out


def _check_bounds(sample: dict, config, n_validators: int) -> list[str]:
    """-> list of violated-bound descriptions (empty = healthy).

    Hard caps backstop the growth verdicts: kv_* gauges (chain growth
    by design, GROWTH_EXEMPT) carry no cap.
    """
    caps = {
        "flight_ring_entries": config.TRACE_RING_SIZE,
        "metrics_accs": 256,                 # the MetricsName namespace
        "metrics_samples_max": 256,          # metrics.SAMPLE_CAP
        "stashed_entries": 8 * 1000,         # routers' discarded deques +
        #                                      transient stash churn
        "request_state_entries": 5000,       # TTL-swept under FAST sweeps
        "dedup_map_entries": 5000,
        "read_cache_entries": 4 * 4096,
        # view-change votes (a few views in flight) + instance-change
        # votes (MAX_FUTURE_VIEWS rows) land in ONE combined gauge
        "vc_vote_entries": (4 + 130) * n_validators,
        "bls_sig_entries": 2 * config.CHK_FREQ * n_validators,
        "bls_verdict_cache_entries": 16384,  # bls._BLS_VERDICTS_MAX
    }
    return [f"{k}={sample[k]} > cap {caps[k]}"
            for k in caps if sample.get(k, 0) > caps[k]]


def run_churn_soak(seconds: float = 600.0, seed: int = 11,
                   wave_s: float = 20.0, leak_rate: float = 0.0,
                   crypto_backend: str = "cuda") -> dict:
    """Drive a 5-node sim pool (4 validators + 1 churning member) over the
    lossy_wan topology for `seconds` of SIMULATED time: steady writes
    plus one churn event per wave; the fleet aggregator's growth
    verdicts + history ring judge bounded growth, with the hard caps as
    backstop. `leak_rate > 0` adds a synthetic ever-growing
    ``leaky_stash`` gauge (entries per telemetry tick) to Alpha's
    footprint — the detector self-test. `crypto_backend` is the nodes'
    (the card unless asked for "cpu" or "torch")."""
    import sys
    sys.path.insert(0, _tests_dir())
    from test_torch_pool import Pool, signed_nym            # noqa: E402
    from test_torch_scale import signed_node_services       # noqa: E402

    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import NODE
    from plenum_tpu_torch.network import make_topology
    from plenum_tpu_torch.observability import (GROWTH_EXEMPT_GAUGES,
                                          FleetAggregator, HistoryRecorder)

    names = ["Alpha", "Beta", "Gamma", "Delta", "Eps"]
    config = Config(Max3PCBatchWait=0.05, crypto_backend=crypto_backend,
                    PRIMARY_HEALTH_CHECK_FREQ=0.5,
                    ORDERING_PROGRESS_TIMEOUT=2.0,
                    STATE_FRESHNESS_UPDATE_INTERVAL=3.0,
                    VIEW_CHANGE_TIMEOUT=8.0, NEW_VIEW_TIMEOUT=4.0,
                    OUTDATED_REQS_CHECK_INTERVAL=5.0,
                    EXECUTED_REQ_RETENTION=10.0,
                    PROPAGATE_BODYLESS_REQ_TIMEOUT=10.0)
    pool = Pool(names=names, seed=seed, config=config)
    pool.net.set_topology(make_topology("lossy_wan", names))

    # The history plane: every node ships snapshots into one aggregator;
    # growth trends + the per-interval ring come for free with ingest.
    agg = FleetAggregator(config=config)
    agg.attach_history(HistoryRecorder(
        max_slots=getattr(config, "HISTORY_MAX_SLOTS", 512)))
    for node in pool.nodes.values():
        node.telemetry.add_sink(agg.ingest)

    if leak_rate > 0:
        alpha = pool.nodes["Alpha"]
        real_footprint = alpha._telemetry_footprint_state
        ticks = {"n": 0}

        def leaky_footprint() -> dict:
            out = real_footprint()
            ticks["n"] += 1
            out["leaky_stash"] = int(64 + ticks["n"] * leak_rate)
            return out

        # re-registering under the same source name replaces the real one
        alpha.telemetry.add_source("footprint", leaky_footprint)

    req_id = 0
    rotation_no = 0

    def write(n_writes: int) -> None:
        nonlocal req_id
        for _ in range(n_writes):
            req_id += 1
            user = Ed25519Signer(
                seed=(b"churn%08d" % req_id).ljust(32, b"\0")[:32])
            pool.submit(signed_nym(pool.trustee, user, req_id))
            pool.run(0.5)

    def churn(event_no: int) -> str:
        nonlocal req_id, rotation_no
        req_id += 1
        kind = event_no % 3
        if kind == 0:
            # demote the 5th member ... or re-promote it if demoted
            demoted = "Eps" not in pool.nodes["Alpha"].validators
            pool.submit(signed_node_services(
                pool.trustee, "Eps",
                ["VALIDATOR"] if demoted else [], req_id))
            return "promote" if demoted else "demote"
        if kind == 1:
            # rotate a non-primary validator's BLS key, then re-key the
            # node's signer (the operator restart, simulated in place)
            primary = pool.nodes["Alpha"].master_replica.data.primary_name
            victim = next(n for n in ("Beta", "Gamma", "Delta")
                          if n != primary)
            rotation_no += 1
            new_signer = BlsCryptoSigner(
                seed=(b"rot%s%04d" % (victim.encode(), rotation_no))
                .ljust(32, b"\0")[:32])
            req = Request(pool.trustee.identifier, req_id,
                          {"type": NODE, "dest": f"{victim}Dest",
                           "data": {"blskey": new_signer.pk,
                                    "blskey_pop":
                                    new_signer.generate_pop()}})
            req.signature = pool.trustee.sign_b58(req.signing_bytes())
            pool.submit(req)
            pool.run(3.0)
            if victim in pool.nodes:
                pool.nodes[victim].replicas.master.bls._signer = new_signer
            return f"rotate:{victim}"
        # demote the current primary -> forced view change; but never
        # shrink below 4 validators (f must stay >= 1 for the soak to
        # keep meaning BFT) — re-promote a demoted member instead
        validators = pool.nodes["Alpha"].validators
        demoted = [n for n in names if n not in validators]
        if demoted:
            pool.submit(signed_node_services(pool.trustee, demoted[0],
                                             ["VALIDATOR"], req_id))
            return f"repromote:{demoted[0]}"
        primary = pool.nodes["Alpha"].master_replica.data.primary_name
        pool.submit(signed_node_services(pool.trustee, primary, [],
                                         req_id))
        return f"demote_primary:{primary}"

    samples = [_bounds_snapshot(pool)]
    events: list[str] = []
    violations: list[str] = []
    elapsed = 0.0
    wave_no = 0
    while elapsed < seconds:
        write(3)
        events.append(churn(wave_no))
        pool.run(wave_s - 5.0)      # writes/churn above consumed ~5 sim-s
        elapsed += wave_s
        wave_no += 1
        sample = _bounds_snapshot(pool)
        samples.append(sample)
        bad = _check_bounds(sample, config,
                            len(pool.nodes["Alpha"].validators))
        if bad:
            violations.append(f"wave {wave_no}: " + "; ".join(bad))

    # final convergence: the surviving validator set must order one more
    # write everywhere (liveness after minutes of churn)
    req_id += 1
    user = Ed25519Signer(seed=(b"churn-final%d" % seed)
                         .ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, req_id))
    pool.run(30.0)
    validators = pool.nodes["Alpha"].validators
    sizes = {n: pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in validators if n in pool.nodes}
    converged = len(set(sizes.values())) == 1

    # growth verdicts + alert audit from the history plane
    verdicts = agg.growth_verdicts()
    growth_alerts = [a.to_dict() for a in agg.alerts
                     if a.kind == "unbounded_growth"
                     and a.severity == "page"]
    unexpected = [a for a in growth_alerts
                  if not (leak_rate > 0 and a["subject"] == "leaky_stash")]
    growing = sorted(g for g, v in verdicts.items()
                     if v.get("verdict") == "growing"
                     and g not in GROWTH_EXEMPT_GAUGES
                     and not (leak_rate > 0 and g == "leaky_stash"))
    hist = agg.history

    first, last = samples[0], samples[-1]
    return {
        "sim_seconds": elapsed, "waves": wave_no, "events": events,
        "txns_submitted": req_id,
        "converged": converged, "ledger_sizes": sizes,
        "bounds_ok": not violations and not unexpected and not growing,
        "violations": violations,
        "bounds_first": first, "bounds_last": last,
        "bounds_max": {k: max(s.get(k, 0) for s in samples)
                       for k in last},
        "growth_verdicts": verdicts,
        "growth_alerts": growth_alerts,
        "growth_unexpected": [a["subject"] for a in unexpected] + growing,
        "history_rows": len(hist.rows), "history_seq": hist.seq,
        "history_tail": hist.query(max_points=12),
    }


def _tests_dir() -> str:
    """The in-process Pool/signed_nym helpers live in tests/ next to the
    package — the soak reuses them instead of forking a third pool
    builder."""
    import os
    import plenum_tpu_torch
    return os.path.join(
        os.path.dirname(os.path.dirname(plenum_tpu_torch.__file__)), "tests")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=float, default=600.0,
                    help="SIMULATED seconds of churn load")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--leak-rate", type=float, default=0.0,
                    help="inject a synthetic leak of N entries per "
                         "telemetry tick (detector self-test)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--backend", default="cuda",
                    choices=["cpu", "cuda", "torch"])
    args = ap.parse_args(argv)
    out = run_churn_soak(args.seconds, seed=args.seed,
                         leak_rate=args.leak_rate,
                         crypto_backend=args.backend)
    print(json.dumps(out if args.json else out, indent=None
                     if args.json else 2))
    return 0 if (out["bounds_ok"] and out["converged"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
