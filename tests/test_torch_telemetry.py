"""The port's copy of tests/test_telemetry.py, run on plenum_tpu_torch
(nodes on the CPU).

Live fleet telemetry plane (plenum_tpu_torch/observability/).

Covers the plane's acceptance gates: snapshot-stream determinism on the
seeded timer (the tracing-determinism guard pattern), multi-window
burn-rate alerting (a client flood MUST fire the ingress SLO alert; an
idle pool must fire NONE), device_flap degrading + recovering the
crypto health score, the zipfian hot-shard load-imbalance flag, the
disabled path collapsing to one attribute check (microbench-pinned),
the metrics lint (every MetricsName in the snapshot schema or
exempted), pool-wide percentile merging in metrics_report, and the
fleet_console --check self-test.
"""
from __future__ import annotations

import json
import time

import pytest

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.timer import MockTimer
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.observability import (NULL_TELEMETRY, FleetAggregator,
                                      TelemetryEmitter, make_telemetry,
                                      snapshot_bytes)

from test_torch_pool import Pool, signed_nym

FAST_BURN = dict(Max3PCBatchWait=0.05,
                 SLO_BURN_FAST_WINDOW=3.0,
                 SLO_BURN_SLOW_WINDOW=10.0,
                 TELEMETRY_INTERVAL=0.5)


def _wire_aggregator(pool, config=None):
    agg = FleetAggregator(config=config or pool.config)
    for node in pool.nodes.values():
        assert node.telemetry.enabled
        node.telemetry.add_sink(agg.ingest)
    return agg


# --- disabled path ----------------------------------------------------------

def test_null_telemetry_disabled_cost_microbench():
    """TELEMETRY=False must collapse the plane to one attribute check
    per call site (the NullTracer acceptance pattern): no timer, no
    snapshot work, and the guarded-check pattern itself within 2% of a
    1 ms/txn budget at a generous 4 sites per txn."""
    telemetry = NULL_TELEMETRY
    assert telemetry.enabled is False
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        if telemetry.enabled:
            telemetry.tick()
    per_site = (time.perf_counter() - t0) / n
    assert per_site * 4 < 0.02 * 0.001, \
        f"{per_site * 1e9:.0f} ns/site exceeds the disabled budget"


def test_disabled_node_gets_null_telemetry_and_no_timer():
    timer = MockTimer()
    made = make_telemetry("N", MetricsCollector(), timer.get_current_time,
                          config=Config(TELEMETRY=False), timer=timer)
    assert made is NULL_TELEMETRY
    assert timer.size == 0                      # no snapshot timer registered
    pool = Pool(config=Config(Max3PCBatchWait=0.05, TELEMETRY=False))
    assert all(node.telemetry is NULL_TELEMETRY
               for node in pool.nodes.values())


# --- snapshot mechanics -----------------------------------------------------

def test_emitter_counter_deltas_and_flush_rebase():
    timer = MockTimer()
    metrics = MetricsCollector()
    em = TelemetryEmitter("N", metrics, timer.get_current_time,
                          config=Config())
    metrics.add_event("node.propagates", 1)
    metrics.add_event("node.propagates", 1)
    s1 = em.snapshot()
    assert s1["counters"]["node.propagates"][0] == 2
    metrics.add_event("node.propagates", 1)
    s2 = em.snapshot()
    assert s2["counters"]["node.propagates"][0] == 1     # delta, not total
    # a collector flush (KvMetricsCollector) drops accumulators; the
    # next interval's fold IS the delta — no negative or double counts
    metrics.flush()
    for _ in range(5):
        metrics.add_event("node.propagates", 1)
    s3 = em.snapshot()
    assert s3["counters"]["node.propagates"][0] == 5
    assert [s["seq"] for s in (s1, s2, s3)] == [0, 1, 2]


def test_spool_is_bounded_and_atomic(tmp_path):
    timer = MockTimer()
    metrics = MetricsCollector()
    em = TelemetryEmitter("N1", metrics, timer.get_current_time,
                          config=Config(TELEMETRY_SPOOL_MAX=4),
                          spool_dir=str(tmp_path))
    for i in range(10):
        metrics.add_event("node.propagates", 1)
        timer.advance(1.0)
        em.tick()
    files = sorted(tmp_path.glob("N1-telemetry-*.json"))
    assert len(files) == 4                      # rotating window, bounded
    snaps = [json.loads(f.read_text()) for f in files]
    assert max(s["seq"] for s in snaps) == 9    # newest snapshot present
    assert not list(tmp_path.glob("*.tmp"))     # atomic: no torn leftovers


def test_snapshot_stream_determinism():
    """The tracing guard pattern for the telemetry plane: the SAME seeded sim
    workload run twice produces byte-identical snapshot streams
    (wall_sums=False strips the perf_counter-derived sums/percentiles,
    the one legitimately non-deterministic field — the tracer's
    wall_durations twin)."""
    def run_once():
        pool = Pool(seed=7, config=Config(**FAST_BURN))
        for node in pool.nodes.values():
            node.telemetry.wall_sums = False
        u = Ed25519Signer(seed=b"det-user".ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, u, 1))
        pool.run(8.0)
        return b"|".join(snapshot_bytes(s)
                         for s in pool.nodes["Alpha"].telemetry.ring)
    a, b = run_once(), run_once()
    assert a == b and len(a) > 100
    # the reference's pool, the same seed and write: the same stream
    from plenum_tpu.config import Config as RefConfig
    from plenum_tpu.crypto.ed25519 import Ed25519Signer as RefSigner
    from plenum_tpu.observability import snapshot_bytes as ref_bytes
    from test_pool import Pool as RefPool, signed_nym as ref_signed_nym
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        ref = RefPool(seed=7, config=RefConfig(**FAST_BURN))
        for node in ref.nodes.values():
            node.telemetry.wall_sums = False
        ref.submit(ref_signed_nym(
            ref.trustee, RefSigner(seed=b"det-user".ljust(32, b"\0")), 1))
        ref.run(8.0)
    assert a == b"|".join(ref_bytes(s)
                          for s in ref.nodes["Alpha"].telemetry.ring)


def test_telemetry_ships_over_sim_network_wire():
    """The best-effort TELEMETRY wire message: every node ships its
    snapshots to Beta (TELEMETRY_SHIP_TO — the production wiring, full
    wire pack/unpack roundtrip), whose attached FleetAggregator
    composes the whole pool's view."""
    pool = Pool(config=Config(**FAST_BURN, TELEMETRY_SHIP_TO="Beta"))
    beta = pool.nodes["Beta"]
    agg = FleetAggregator(config=pool.config)
    beta.fleet_aggregator = agg                  # wire-ingest only
    pool.run(5.0)
    # every OTHER node's snapshots arrived across the wire
    assert set(agg.latest) == {"Alpha", "Gamma", "Delta"}
    assert agg.latest["Alpha"]["state"]["node"]["validators"] == 4
    # Beta ships nowhere (it hosts the aggregator); attach adds its own
    # stream through the in-process sink seam
    assert pool.nodes["Alpha"].telemetry.ship is not None
    assert beta.telemetry.ship is None
    beta.attach_fleet_aggregator(agg)
    pool.run(2.0)
    assert set(agg.latest) == set(pool.names)


# --- burn-rate alerting -----------------------------------------------------

def test_burn_tracker_multi_window_rule():
    from plenum_tpu_torch.observability import BurnRateTracker
    tr = BurnRateTracker(budget=0.05, threshold=2.0,
                         fast_window=3.0, slow_window=10.0)
    # below MIN_SAMPLES nothing can page, however bad the fraction
    tr.note(0.0, 5, 5)
    assert not tr.alerting(0.0)
    for i in range(1, 12):
        tr.note(float(i), 4, 5)
    assert tr.alerting(11.0)                     # both windows burning
    # recovery: fast window clears first, the alert rule follows it
    for i in range(12, 20):
        tr.note(float(i), 0, 5)
    assert not tr.alerting(19.0)


def test_idle_pool_fires_zero_alerts():
    """Zero false positives: an idle 4-node pool with the full telemetry
    plane on raises NO alerts across a long quiet stretch."""
    pool = Pool(config=Config(**FAST_BURN))
    agg = _wire_aggregator(pool)
    u = Ed25519Signer(seed=b"idle-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(30.0)
    assert agg.snapshots > 100
    assert agg.alerts == [], \
        f"idle pool alerted: {[a.to_dict() for a in agg.alerts]}"
    assert all(agg.node_health(n) == 1.0 for n in pool.names)


def test_client_flood_fires_ingress_burn_alert():
    """A sustained flood through the front door must fire the ingress
    SLO burn-rate alert (sheds + over-SLO queue waits burn the error
    budget on both windows) — and the alert lands in the node's
    flight-recorder ring as a structured anomaly."""
    from plenum_tpu_torch.client.sim_clients import burst_writes
    from plenum_tpu_torch.ingress import IngressPlane
    config = Config(**FAST_BURN, INGRESS_CLIENT_QUEUE_CAP=4,
                    INGRESS_SLO_P95=0.2)
    pool = Pool(config=config)
    alpha = pool.nodes["Alpha"]
    agg = FleetAggregator(config=config, tracer=alpha.tracer,
                          metrics=alpha.metrics)
    for node in pool.nodes.values():
        node.telemetry.add_sink(agg.ingest)
    ingress = {n: IngressPlane(pool.nodes[n]) for n in pool.names}
    pool.run(3.0)                                # healthy datum
    assert not [a for a in agg.alerts if a.kind == "slo_burn.ingress"]
    # repeated hot-client bursts: well past the per-client caps, every
    # wave shedding the surplus, sustained across both burn windows
    for wave in range(10):
        for client, req in burst_writes(pool.trustee, 8, 10,
                                        seed=wave + 1):
            for n in pool.names:
                ingress[n].submit(req.to_dict(), client)
        pool.run(1.5)
    fired = [a for a in agg.alerts
             if a.kind == "slo_burn.ingress" and a.severity == "page"]
    assert fired, f"flood never fired: {[a.to_dict() for a in agg.alerts]}"
    assert fired[0].detail["fast"] >= config.SLO_BURN_THRESHOLD
    # structured alert reached the flight-recorder ring
    kinds = [e[1] for e in alpha.tracer.ring]
    assert any(k == "anomaly.alert.slo_burn.ingress" for k in kinds)
    # and the alert-volume counter reached metrics
    assert alpha.metrics.accumulators[MetricsName.TELEMETRY_ALERTS].count >= 1


def test_silent_node_goes_stale_not_frozen_at_healthy():
    """A crashed/partitioned node must read as DOWN: once its last
    snapshot ages past TELEMETRY_STALE_AFTER (vs the fleet clock), its
    health drops to 0.0, the sweep raises the health alert, and its
    ordered-rate contribution decays — never frozen-at-last-healthy."""
    pool = Pool(config=Config(**FAST_BURN, TELEMETRY_STALE_AFTER=3.0))
    agg = _wire_aggregator(pool)
    u = Ed25519Signer(seed=b"stale-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(5.0)
    assert agg.node_health("Delta") == 1.0
    # Delta goes dark; the rest of the pool keeps snapshotting
    pool.nodes["Delta"].telemetry.stop()
    pool.run(10.0)
    assert agg.node_stale("Delta")
    assert agg.node_health("Delta") == 0.0
    stale_alerts = [a for a in agg.alerts
                    if a.kind == "health.node" and a.subject == "Delta"
                    and a.severity == "warn"]
    assert stale_alerts and stale_alerts[0].detail.get("stale_s", 0) > 3.0
    # the live members are untouched
    assert all(agg.node_health(n) == 1.0
               for n in ("Alpha", "Beta", "Gamma"))


def test_single_abusive_client_does_not_page_pool_slo():
    """The breadth rule: ONE client hammering past its per-client cap is
    the fairness mechanism working, not pool overload — its sheds must
    not burn the pool's ingress error budget (no false page), while the
    same volume spread over many clients does (pinned by the flood
    test)."""
    from plenum_tpu_torch.client.sim_clients import burst_writes
    from plenum_tpu_torch.ingress import IngressPlane
    config = Config(**FAST_BURN, INGRESS_CLIENT_QUEUE_CAP=4,
                    INGRESS_SLO_P95=0.2)
    pool = Pool(config=config)
    agg = _wire_aggregator(pool, config=config)
    ingress = {n: IngressPlane(pool.nodes[n]) for n in pool.names}
    pool.run(3.0)
    # one client, same aggregate volume as the flood's waves
    for wave in range(10):
        for client, req in burst_writes(pool.trustee, 1, 80,
                                        seed=wave + 1):
            for n in pool.names:
                ingress[n].submit(req.to_dict(), client)
        pool.run(1.5)
    assert ingress[pool.names[0]].stats["shed_client_cap"] > 0
    pages = [a for a in agg.alerts
             if a.kind == "slo_burn.ingress" and a.severity == "page"]
    assert pages == [], \
        f"one capped client paged the pool: {[a.to_dict() for a in pages]}"


def test_device_flap_degrades_crypto_health_and_recovers():
    """The acceptance arc: a wedged crypto plane opens the breaker ->
    the node's health score degrades; the plane heals and the breaker
    re-closes -> health recovers to 1.0."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2, cooldown=1.0),
        budget=DeadlineBudget(base=0.4, min_s=0.2, warm_max=1.0,
                              cold_max=1.0))
    pool = Pool(config=Config(**FAST_BURN), verifier=sup)
    sup.set_clock(pool.timer.get_current_time)
    faulty.set_clock(pool.timer.get_current_time)
    agg = _wire_aggregator(pool)

    u1 = Ed25519Signer(seed=b"flap-user1".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u1, 1))
    pool.run(5.0)
    assert agg.node_health("Alpha") == 1.0

    faulty.wedge()                               # the fault lands
    u2 = Ed25519Signer(seed=b"flap-user2".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u2, 2))
    pool.run(8.0)
    assert sup.breaker.state != "closed"
    degraded = agg.node_health("Alpha")
    assert degraded is not None and degraded <= 0.5, \
        f"breaker {sup.breaker.state} but health {degraded}"

    faulty.heal()                                # recovery
    u3 = Ed25519Signer(seed=b"flap-user3".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u3, 3))
    pool.run(20.0)
    assert sup.breaker.state == "closed"
    assert agg.node_health("Alpha") == 1.0


# --- sharded fabric: imbalance + health exposure ----------------------------

def test_zipfian_hot_shard_flags_imbalance():
    """A 90:10 hot-key skew onto shard 0 must push the load-imbalance
    index past the threshold and name shard 0 hot — the per-shard load
    signal elastic resharding will consume — and surface per-shard
    health through the router summary and `shards` metrics."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.shards import ShardedSimFabric
    fab = ShardedSimFabric(
        n_shards=2, nodes_per_shard=3, seed=5,
        config=Config(Max3PCBatchWait=0.05, TELEMETRY_INTERVAL=0.5,
                      STATE_FRESHNESS_UPDATE_INTERVAL=600.0))
    by_shard: dict[int, list] = {0: [], 1: []}
    i = 0
    while min(len(v) for v in by_shard.values()) < 40 and i < 400:
        i += 1
        user = Ed25519Signer(seed=(b"zh%08d" % i).ljust(32, b"\0")[:32])
        req = Request(fab.trustee.identifier, i,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        req.signature = fab.trustee.sign_b58(req.signing_bytes())
        sid = fab.router.shard_of(req)
        if sid in by_shard:
            by_shard[sid].append(req)
    for j in range(40):
        fab.submit_write(by_shard[0][j] if j % 10 else by_shard[1][j // 10])
        if j % 8 == 7:
            fab.run(1.0)
    fab.run(10.0)
    fab.ordered_counts()
    index, hot = fab.aggregator.load_imbalance()
    assert hot == 0 and index is not None and index >= 1.5, \
        f"hot shard not flagged: index={index} hot={hot} " \
        f"rates={fab.aggregator.ordered_rates()}"
    assert any(a.kind == "shard.imbalance" for a in fab.aggregator.alerts)
    # satellite: per-shard health is visible at the routing layer and in
    # the shards metrics section (signal only — no routing change)
    summary = fab.router.summary()
    assert summary["shard_health"] == {0: 1.0, 1: 1.0}
    assert summary["degraded_shards"] == []
    health_acc = fab.metrics.accumulators.get(MetricsName.SHARD_HEALTH)
    imb_acc = fab.metrics.accumulators.get(MetricsName.SHARD_IMBALANCE)
    assert health_acc is not None and health_acc.count >= 2
    assert imb_acc is not None and imb_acc.max >= 1.5
    # the read ladder exposes the same health signal
    driver = fab.read_driver()
    assert driver.shard_health() == {0: 1.0, 1: 1.0}
    # and the fabric summary carries the full fleet columns
    s = fab.summary()
    assert s["hot_shard"] == 0 and s["load_imbalance"] == index




# --- metrics_report pool merge (satellite) ----------------------------------

def test_pool_percentiles_merge_reservoirs_not_average():
    """Pool p50/p95 must come from the UNION of the nodes' sampled
    reservoirs. With two nodes at 1 ms and 100 ms, averaging per-node
    p50s would invent a ~50 ms figure no request ever saw; the merged
    p95 must sit at the slow node's value."""
    from plenum_tpu_torch.common.metrics import percentile
    from plenum_tpu_torch.tools.metrics_report import (merge_node_folds,
                                                 pool_summary)
    name = "commit_path.durable_time"
    ordered = {"count": 10, "sum": 150.0, "min": 10, "max": 20,
               "mean": 15.0, "first_ts": 0.0, "last_ts": 10.0,
               "flushes": 1}
    per_node = {
        "A": {name: {"count": 100, "sum": 0.1, "min": 0.001, "max": 0.001,
                     "mean": 0.001, "first_ts": 0.0, "last_ts": 10.0,
                     "flushes": 1, "samples": [0.001] * 100},
              "node.ordered_batch_size": dict(ordered)},
        "B": {name: {"count": 100, "sum": 10.0, "min": 0.1, "max": 0.1,
                     "mean": 0.1, "first_ts": 0.0, "last_ts": 10.0,
                     "flushes": 1, "samples": [0.1] * 100},
              "node.ordered_batch_size": dict(ordered)},
    }
    merged = merge_node_folds(per_node)
    samples = merged[name]["samples"]
    assert len(samples) == 200
    p50 = percentile(samples, 0.5)
    p95 = percentile(samples, 0.95)
    assert p50 in (0.001, 0.1)                   # a real observed value
    assert p95 == pytest.approx(0.1)             # the slow node dominates
    avg_of_p50s = (0.001 + 0.1) / 2
    assert abs(p50 - avg_of_p50s) > 0.04         # NOT the averaged figure
    assert merged[name]["count"] == 200
    assert merged[name]["min"] == 0.001 and merged[name]["max"] == 0.1
    summary = pool_summary(per_node)
    assert summary["nodes"] == 2
    assert summary["durable_ms_p95"] == pytest.approx(100.0)
    # the ordered stream is REPLICATED on every node: the pool figure
    # must be de-replicated, not the nodes' sum (2x reality)
    assert summary["txns_ordered"] == 150
    assert summary["tps"] == pytest.approx(15.0)


# --- lint + console self-tests (tier-1 gates) -------------------------------

def test_metrics_lint_is_clean_and_catches_gaps(monkeypatch):
    from plenum_tpu_torch.tools.metrics_lint import run_lint
    out = run_lint()
    assert out["check"] == "ok", out["problems"]
    assert out["covered"] + out["exempted"] == out["metrics"]
    # a counter added without schema coverage must FAIL the lint
    monkeypatch.setattr(MetricsName, "BOGUS_NEW", "bogus.new_counter",
                        raising=False)
    out2 = run_lint()
    assert out2["check"] == "FAIL"
    assert any("bogus.new_counter" in p for p in out2["problems"])


def test_fleet_console_check_smoke(capsys):
    """`fleet_console --check` is the tier-1 self-test gate (the
    trace_report --check pattern): synthetic healthy / overload /
    crypto-fault / hot-shard streams through the REAL aggregator."""
    from plenum_tpu_torch.tools import fleet_console
    assert fleet_console.main(["--check"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["check"] == "ok"


def test_fleet_console_reads_spool_dir(tmp_path):
    """End-to-end over the on-disk seam: a pool spools snapshots, the
    console builds the fleet view from the files alone."""
    pool = Pool(config=Config(**FAST_BURN))
    for n, node in pool.nodes.items():
        node.telemetry.spool_dir = str(tmp_path / n / "telemetry")
    u = Ed25519Signer(seed=b"spool-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(6.0)
    from plenum_tpu_torch.tools.fleet_console import build_view, render
    agg, incidents = build_view([str(tmp_path)], config=pool.config)
    assert set(agg.latest) == set(pool.names)
    assert all(agg.node_health(n) == 1.0 for n in pool.names)
    assert agg.alerts == []
    text = render(agg, incidents)
    assert "Alpha" in text and "alerts: 0 active" in text


def test_aggregator_alert_lands_in_flight_ring_and_incidents():
    """Structured alerts mirror into an attached tracer ring and merge
    into the cross-node incident timeline."""
    from plenum_tpu_torch.common.tracing import Tracer
    from plenum_tpu_torch.observability import incident_timelines
    clock = {"t": 0.0}
    tracer = Tracer("agg", lambda: clock["t"])
    agg = FleetAggregator(config=Config(SLO_BURN_FAST_WINDOW=3.0,
                                        SLO_BURN_SLOW_WINDOW=10.0),
                          tracer=tracer)
    for i in range(15):
        clock["t"] = float(i)
        agg.ingest({"v": 1, "node": "N1", "seq": i, "t": float(i),
                    "counters": {}, "sampled": {},
                    "state": {"ingress": {"slo": [5, 5]},
                              "node": {"ordered_total": 0}}})
    assert any(a.kind == "slo_burn.ingress" for a in agg.alerts)
    assert any(e[1] == "anomaly.alert.slo_burn.ingress"
               for e in tracer.ring)
    incidents = incident_timelines([tracer.snapshot()], alerts=agg.alerts)
    assert incidents and any("alert.slo_burn.ingress" in inc["kinds"]
                             for inc in incidents)


@pytest.mark.parametrize("name", [
    "test_telemetry_ships_over_sim_network_wire",
    "test_idle_pool_fires_zero_alerts",
    "test_client_flood_fires_ingress_burn_alert",
    "test_silent_node_goes_stale_not_frozen_at_healthy",
    "test_single_abusive_client_does_not_page_pool_slo",
    "test_device_flap_degrades_crypto_health_and_recovers",
    "test_fleet_console_reads_spool_dir",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_telemetry as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
