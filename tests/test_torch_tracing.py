"""The port's tracing plane (plenum_tpu_torch/common/tracing.py) and its
waterfall assembly (tools/trace_report.py), held to the cases of the
reference's tests/test_tracing.py (the log analyzer's merge of flight
dumps and the sim-pool waterfalls on the port's pool included), and to
the reference's tracer itself on the same seeded event stream."""
from __future__ import annotations

import json
import random
import time

import pytest

from plenum_tpu.common import tracing as ref_tracing
from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import (SAMPLE_CAP, Accumulator,
                                             percentile)
from plenum_tpu_torch.common.node_messages import Reply
from plenum_tpu_torch.common.tracing import NULL_TRACER, Tracer, span_sequence
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.tools.trace_report import (assemble,
                                                 attribution_summary,
                                                 summarize)

from test_torch_pool import Pool, signed_nym


def test_percentile_nearest_rank_pins():
    assert percentile([1, 2, 3, 4], 0.5) == 2
    assert percentile([1, 2, 3, 4], 0.25) == 1
    assert percentile([1, 2, 3, 4], 0.75) == 3
    assert percentile([1, 2, 3, 4], 1.0) == 4
    assert percentile([1, 2, 3, 4], 0.0) == 1
    assert percentile([7], 0.95) == 7
    assert percentile(list(range(1, 101)), 0.5) == 50
    assert percentile(list(range(1, 101)), 0.95) == 95
    assert percentile(list(range(1, 101)), 1.0) == 100
    assert percentile([3, 1, 2], 0.5) == 2          # unsorted input
    assert percentile([], 0.5) is None


def test_accumulator_reservoir_is_deterministic_and_unbiased():
    stream = [float(v) for v in range(SAMPLE_CAP * 4)]
    a1 = Accumulator(keep_samples=True, seed=7)
    a2 = Accumulator(keep_samples=True, seed=7)
    for v in stream:
        a1.add(v)
        a2.add(v)
    assert a1.samples == a2.samples
    assert len(a1.samples) == SAMPLE_CAP
    tail = sum(1 for v in a1.samples if v >= SAMPLE_CAP)
    assert tail > SAMPLE_CAP // 2, tail
    a3 = Accumulator(keep_samples=True, seed=8)
    for v in stream:
        a3.add(v)
    assert a3.samples != a1.samples                 # seeds decorrelate
    assert a1.count == len(stream) and a1.max == stream[-1]


def test_null_tracer_disabled_cost_microbench():
    """Tracing disabled costs one attribute check per guarded site: under
    2% of a 1 ms/txn budget at ~12 sites per ordered txn."""
    tracer = NULL_TRACER
    assert tracer.enabled is False
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        if tracer.enabled:
            tracer.emit("stage", "key", None)
    per_site = (time.perf_counter() - t0) / n
    sites_per_txn = 12
    budget = 0.02 * 0.001       # 2% of 1 ms
    assert per_site * sites_per_txn < budget, \
        f"{per_site * 1e9:.0f} ns/site x {sites_per_txn} sites " \
        f"exceeds {budget * 1e6:.0f} us/txn"


def test_flight_recorder_ring_bounds_and_auto_dump(tmp_path):
    clock = {"t": 0.0}
    tr = Tracer("N1", lambda: clock["t"], ring_size=8,
                dump_dir=str(tmp_path), min_dump_interval=5.0)
    for i in range(20):
        tr.emit("stage", f"k{i}")
    assert len(tr.ring) == 8                        # bounded
    tr.anomaly("suspicion", {"code": 1})            # auto-dump fires
    tr.anomaly("suspicion", {"code": 2})            # debounced away
    dumps = sorted(tmp_path.glob("N1-flight-*.json"))
    assert len(dumps) == 1
    clock["t"] = 10.0
    tr.anomaly("suspicion", {"code": 3})            # past the debounce
    assert len(sorted(tmp_path.glob("N1-flight-*.json"))) == 2
    snap = json.loads(dumps[0].read_text())
    assert snap["node"] == "N1"
    assert len(snap["events"]) == 8
    assert snap["events"][-1][1] == "anomaly.suspicion"
    assert snap["anomalies"] == 1                   # at dump time


def test_breaker_transitions_reach_flight_recorder():
    from plenum_tpu_torch.parallel.supervisor import CircuitBreaker
    tr = Tracer("N", lambda: 0.0)
    br = CircuitBreaker(fail_threshold=2, cooldown=1.0, now=lambda: 0.0)
    br.on_transition = lambda old, new: tr.anomaly(
        "breaker", {"from": old, "to": new})
    br.record_failure()
    br.record_failure()                             # -> open
    br.to_half_open()
    br.close()
    hops = [(e[3]["from"], e[3]["to"]) for e in tr.ring
            if e[1] == "anomaly.breaker"]
    assert hops == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


def _order_one_traced(pool, req):
    """Submit and run until a Reply lands; -> (t_submit, t_reply) sim
    times measured the way a client would."""
    t0 = pool.timer.get_current_time()
    pool.submit(req)
    for _ in range(1000):
        for node in pool.nodes.values():
            node.prod()
        if any(isinstance(m, Reply)
               for m, _ in pool.client_msgs[pool.names[0]]):
            return t0, pool.timer.get_current_time()
        pool.timer.advance(0.01)
    raise AssertionError("request never ordered")


def test_sim_waterfall_stage_sum_matches_e2e():
    """The tentpole acceptance shape on the deterministic sim: every node
    produces a full per-request waterfall, stage sums telescope to within
    10% of the measured end-to-end latency, and pool-level attribution
    reports p50/p95 for each stage including cross-node network time."""
    pool = Pool()
    user = Ed25519Signer(seed=b"waterfall-user".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, 1)
    t_submit, t_reply = _order_one_traced(pool, req)
    e2e = t_reply - t_submit
    assert e2e > 0
    pool.run(3.0)       # let the slower replicas finish their own commits

    report = assemble([pool.nodes[n].tracer.snapshot()
                       for n in pool.names])
    assert req.digest in report["requests"]
    per_node = report["requests"][req.digest]
    assert set(per_node) == set(pool.names)         # every node's view
    for node_name, wf in per_node.items():
        for stage in ("crypto", "propagate", "queue", "ordering",
                      "durable", "reply"):
            assert stage in wf["stages"], (node_name, wf["stages"])
        # stages telescope: their sum IS the node's ingress->reply span
        assert wf["total"] == pytest.approx(wf["end"] - wf["start"],
                                            abs=1e-9), node_name
    # the node whose client reply defined the measured e2e: stage sum
    # within 10% (+1 prod step of measurement granularity)
    wf = per_node[pool.names[0]]
    assert abs(wf["total"] - e2e) <= 0.1 * e2e + 0.011, (wf["total"], e2e)
    att = attribution_summary(report)
    for stage in ("network", "crypto", "propagate", "queue", "ordering",
                  "durable", "reply", "apply_wall", "durable_wall"):
        assert stage in att, sorted(att)
        assert att[stage]["p50_ms"] >= 0
        assert att[stage]["p95_ms"] >= att[stage]["p50_ms"]
    # the compact bench-line summary rides the same report
    summary = summarize(report)
    assert summary["requests_traced"] == 1
    # a clamped out-of-order stage (a replica can admit the pre-prepare
    # before its own propagate quorum) may shave the ratio slightly
    assert summary["stage_sum_ratio_p50"] == pytest.approx(1.0, abs=0.02)


def test_anomalies_recorded_across_view_change():
    """A primary blackout's story lands in the flight recorder: VC start
    + completion anomalies on the survivors, and the assembled report's
    anomaly timeline carries them in order."""
    from plenum_tpu_torch.config import Config
    pool = Pool(config=Config(Max3PCBatchWait=0.05, crypto_backend="cpu",
                              PRIMARY_HEALTH_CHECK_FREQ=0.5,
                              ORDERING_PROGRESS_TIMEOUT=2.0,
                              STATE_FRESHNESS_UPDATE_INTERVAL=3.0,
                              VIEW_CHANGE_TIMEOUT=8.0,
                              NEW_VIEW_TIMEOUT=4.0))
    from plenum_tpu_torch.network import Discard, match_dst, match_frm
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    pool.net.add_rule(Discard(), match_dst(primary))
    pool.net.add_rule(Discard(), match_frm(primary))
    user = Ed25519Signer(seed=b"vc-anomaly-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, 1),
                to=[n for n in pool.names if n != primary])
    pool.run(25.0)
    survivors = [n for n in pool.names if n != primary]
    assert all(pool.nodes[n].master_replica.view_no >= 1
               for n in survivors)
    report = assemble([pool.nodes[n].tracer.snapshot()
                       for n in survivors])
    kinds = [k for (_t, _n, k, _d) in report["anomalies"]]
    assert "view_change_start" in kinds
    assert "view_change_complete" in kinds
    # completion never precedes the first start in the aligned timeline
    assert kinds.index("view_change_start") \
        < kinds.index("view_change_complete")


# --- tooling smoke (the tier-1 CI satellite) --------------------------------

def test_trace_report_check_smoke(capsys):
    """`trace_report --check` assembles a synthetic two-node fixture with
    skewed wall anchors and asserts alignment + waterfall invariants —
    the tier-1 smoke for the assembly path."""
    from plenum_tpu_torch.tools.trace_report import main
    assert main(["--check"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["check"] == "ok"
    assert not out["problems"]


def test_log_analyzer_ingests_flight_dumps(tmp_path):
    """log_analyzer merges flight-recorder anomaly timelines (wall-
    aligned, deduplicated across a dump series) into its per-view
    report next to the spylog-sourced events."""
    from plenum_tpu_torch.tools.log_analyzer import analyze_node
    node_dir = tmp_path / "Node1"
    node_dir.mkdir()
    rows = [{"t": 100.0, "event": "suspicion", "data": [13, "Beta"]},
            {"t": 101.0, "event": "view_change_complete", "data": 1},
            {"t": 102.0, "event": "executed", "data": [1, 1]}]
    (node_dir / "events.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    dump = {"node": "Node1", "clock_domain": "wall", "mono_anchor": 0.0,
            "wall_anchor": 100.0, "dumped_at": 3.0, "anomalies": 2,
            "events": [
                [0.2, "pp_sent", "b" * 8, {"seq": 1, "reqs": []}],
                [0.5, "anomaly.breaker", "",
                 {"from": "closed", "to": "open"}],
                [2.5, "anomaly.catchup", "", None]]}
    (node_dir / "Node1-flight-0.json").write_text(json.dumps(dump))
    # a second overlapping dump (auto-dump cascade) must not double-count
    (node_dir / "Node1-flight-1.json").write_text(json.dumps(dump))

    rep = analyze_node(str(node_dir))
    assert rep["flight_anomalies"] == 2
    assert rep["event_counts"]["flight.breaker"] == 1
    assert rep["event_counts"]["flight.catchup"] == 1
    # wall-aligned: breaker (100.5) falls in the view-0 segment, catchup
    # (102.5) after the view change -> view-1 segment
    assert rep["views"][0]["events"].get("flight.breaker") == 1
    assert rep["views"][1]["events"].get("flight.catchup") == 1


def test_waterfall_out_of_order_points_stay_disjoint():
    """A replica can admit the PRE-PREPARE before its OWN propagate
    quorum completes; the waterfall must not re-count the overlap into
    the ordering stage — stage sums always telescope to the observed
    first->last span (regression: overlapping stages inflated totals
    past end-start and poisoned the 10% acceptance ratio)."""
    req, batch = "r" * 8, "b" * 8
    dump = {"node": "N", "clock_domain": "shared", "mono_anchor": 0.0,
            "wall_anchor": None, "dumped_at": 20.0, "anomalies": 0,
            "events": [
                [1.0, "ingress", req, None],
                [2.0, "auth", req, {"ok": True}],
                # pp arrives at t=3, BEFORE the local quorum at t=5
                [3.0, "pp_recv", batch, {"seq": 1, "reqs": [req]}],
                [5.0, "propagate_quorum", req, {"votes": 2}],
                [10.0, "ordered", batch, {"seq": 1}],
                [11.0, "durable", "", {"seqs": [1]}],
                [13.0, "reply", req, {"seq": 1}]]}
    report = assemble([dump])
    wf = report["requests"][req]["N"]
    assert wf["total"] == pytest.approx(wf["end"] - wf["start"], abs=1e-9)
    assert wf["total"] == pytest.approx(12.0, abs=1e-9)   # 13 - 1
    assert wf["stages"]["queue"] == 0.0                   # clamped
    # ordering starts where the covered prefix ends (t=5), not at pp t=3
    assert wf["stages"]["ordering"] == pytest.approx(5.0, abs=1e-9)


def test_span_sequence_canonical():
    tr = Tracer("N", lambda: 1.5)
    tr.emit("ingress", "d1", {"frm": "cli"})
    a = span_sequence(tr.snapshot())
    b = span_sequence(tr.snapshot())
    assert a == b and b"ingress" in a
    assert span_sequence(None) == b""


@pytest.mark.parametrize("seed", [1, 2])
def test_tracer_matches_reference_on_one_event_stream(seed, tmp_path):
    """One seeded stream of spans, anomalies and clock steps through both
    packages' tracers: the same snapshots, canonical span bytes and
    dumped files; the stage names are the reference's."""
    rng = random.Random(seed)
    clocks = [{"t": 0.0}, {"t": 0.0}]
    made = []
    for mod, clock, sub in ((ref_tracing, clocks[0], "ref"),
                            (tracing, clocks[1], "port")):
        made.append(mod.make_tracer("N", lambda c=clock: c["t"],
                                    dump_dir=str(tmp_path / sub)))
    stages = [tracing.INGRESS, tracing.AUTH, tracing.DEVICE,
              tracing.DEVICE_CONTROLLER, tracing.ORDERED]
    for _ in range(300):
        step = rng.random() * 2
        stage = rng.choice(stages)
        key = "k%d" % rng.randrange(50)
        data = {"n": rng.randrange(1000)} if rng.random() < 0.5 else None
        anomaly = rng.random() < 0.05
        for tr, clock in zip(made, clocks):
            clock["t"] += step
            if anomaly:
                tr.anomaly("breaker", data)
            else:
                tr.emit(stage, key, data)
    ref_tr, port_tr = made
    assert port_tr.snapshot() == ref_tr.snapshot()
    assert span_sequence(port_tr.snapshot()) == \
        ref_tracing.span_sequence(ref_tr.snapshot())
    assert port_tr.dumps_written == ref_tr.dumps_written > 0
    for i in range(port_tr.dumps_written):
        name = f"N-flight-{i}.json"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    names = {k: v for k, v in vars(tracing).items()
             if k.isupper() and isinstance(v, (str, int))}
    assert names == {k: v for k, v in vars(ref_tracing).items()
                     if k.isupper() and isinstance(v, (str, int))}
