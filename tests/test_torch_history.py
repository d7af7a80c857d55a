"""The port's copy of tests/test_history.py, run on plenum_tpu_torch (nodes
on the CPU); the sentinel's report over the repo's BENCH_r*.json is
also held to the reference tool's.

Fleet history plane: durable time-series ring, growth verdicts,
footprint accounting, and the perf-regression sentinel.

Covers observability/history.py (HistoryRecorder + GrowthWatch), the
node's resource-footprint gauges (Node.footprint() -> telemetry
"footprint" section -> aggregator growth trends), the history ring's
replay determinism (the telemetry twin of the tracer guard), the
correlate.py control-ledger + history-context merge, and
tools/perf_sentinel.py's variance-aware regression gating over the
repo's own BENCH_r*.json trajectory.
"""
import json
import os

import pytest

from plenum_tpu_torch.common.metrics import MetricsName
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.observability import (GROWTH_EXEMPT_GAUGES,
                                      FleetAggregator, GrowthWatch,
                                      HistoryRecorder, linear_slope)

from test_torch_pool import Pool, signed_nym

FAST = dict(Max3PCBatchWait=0.05, TELEMETRY_INTERVAL=0.5)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- growth verdicts --------------------------------------------------------

def test_linear_slope_units_and_degenerate_inputs():
    assert linear_slope([(0.0, 0.0), (10.0, 50.0)]) == 5.0
    assert linear_slope([(0.0, 3.0)]) is None            # one point
    assert linear_slope([(2.0, 1.0), (2.0, 9.0)]) is None  # zero t-spread
    assert abs(linear_slope([(t, 7.0) for t in range(10)])) < 1e-12


def test_growthwatch_three_gates():
    """bounded / growing / insufficient, and the two quiet gates: a
    gauge below its absolute floor never pages, and a gauge breathing
    within a fraction of its level never pages."""
    w = GrowthWatch(window=60.0, min_points=4, floor=64.0, fraction=0.5)
    assert w.verdict("missing")["verdict"] == "insufficient"
    for i in range(3):
        w.note("young", float(i), 100.0 + i)
    assert w.verdict("young")["verdict"] == "insufficient"
    # a steep ramp that is still TINY (below floor) stays quiet
    for i in range(10):
        w.note("tiny", float(i), 2.0 * i)         # ends at 18 < 64
    assert w.verdict("tiny")["verdict"] == "bounded"
    # a large gauge breathing within its level stays quiet
    for i in range(10):
        w.note("breathing", float(i), 5000.0 + (i % 3))
    assert w.verdict("breathing")["verdict"] == "bounded"
    # a real leak: outruns both floor and fraction-of-mean
    for i in range(10):
        w.note("leak", float(i) * 6.0, 64.0 + 40.0 * i)
    v = w.verdict("leak")
    assert v["verdict"] == "growing" and v["slope_per_s"] > 0
    assert "kv_entries" in GROWTH_EXEMPT_GAUGES


def test_growthwatch_projects_over_observed_span_not_full_window():
    """Ten samples spanning 9 s must not be extrapolated over a 120 s
    window — a sawtooth phase at cold start would page on noise."""
    w = GrowthWatch(window=120.0, min_points=8, floor=64.0, fraction=0.5)
    for i in range(10):
        w.note("saw", float(i), 120.0 + (i % 5) * 8)
    v = w.verdict("saw")
    assert v["verdict"] == "bounded", v
    # projected reflects the 9 s span (slope ~1.9/s -> ~17), not 120 s
    assert v["projected"] < 64.0

def test_growthwatch_per_gauge_floors():
    w = GrowthWatch(window=60.0, min_points=4, floor=64.0,
                    floors={"ring": 4097.0})
    for i in range(10):
        w.note("ring", float(i) * 6.0, 100.0 + 300.0 * i)   # cold fill
        w.note("other", float(i) * 6.0, 100.0 + 300.0 * i)
    assert w.verdict("ring")["verdict"] == "bounded"     # below its cap
    assert w.verdict("other")["verdict"] == "growing"
    assert set(w.verdicts()) == {"ring", "other"}


# --- the history ring -------------------------------------------------------

def test_history_ring_bounds_and_slot_rotation(tmp_path):
    rec = HistoryRecorder(dir=str(tmp_path), max_slots=8)
    for i in range(20):
        rec.append({"t": float(i), "tps": i * 10})
    assert len(rec.rows) == 8 and rec.seq == 20
    files = sorted(tmp_path.glob("history-*.json"))
    assert len(files) == 8                       # rotating slot window
    assert not list(tmp_path.glob("*.tmp"))      # atomic: no torn leftovers
    newest = max(json.loads(f.read_text())["seq"] for f in files)
    assert newest == 19
    # every in-memory row carries schema version + seq
    assert all(r["v"] == 1 for r in rec.rows)


def test_history_spool_survives_midwrite_crash(tmp_path, monkeypatch):
    """A crash between tmp-write and rename must leave the previous
    slot content intact, and load() must skip torn files."""
    rec = HistoryRecorder(dir=str(tmp_path), max_slots=4)
    rec.append({"t": 0.0, "tps": 1})
    real_replace = os.replace

    def crashy(src, dst):
        raise OSError("disk gone mid-rename")
    monkeypatch.setattr(os, "replace", crashy)
    rec.append({"t": 1.0, "tps": 2})             # spool fails, no raise
    monkeypatch.setattr(os, "replace", real_replace)
    assert len(rec.rows) == 2                    # in-memory ring unharmed
    on_disk = json.loads((tmp_path / "history-0.json").read_text())
    assert on_disk["seq"] == 0                   # old row still whole
    # a torn file (half-written JSON) is skipped on load
    (tmp_path / "history-2.json").write_text('{"seq": 2, "t":')
    loaded = HistoryRecorder.load(str(tmp_path), max_slots=4)
    assert [r["seq"] for r in loaded.rows] == [0]
    assert loaded.seq == 1


def test_history_query_windowing_and_downsample():
    rec = HistoryRecorder(max_slots=256)
    for i in range(100):
        rec.append({"t": float(i), "tps": i})
    assert [r["t"] for r in rec.window(10.0, 12.0)] == [10.0, 11.0, 12.0]
    picked = rec.query(max_points=10)
    assert len(picked) == 10
    assert picked[0]["t"] == 0.0 and picked[-1]["t"] == 99.0
    assert [r["t"] for r in picked] == sorted(r["t"] for r in picked)
    assert rec.query(max_points=1) == [rec.rows[-1]]
    # byte-canonical serialization exists and is stable
    assert rec.history_bytes() == rec.history_bytes()


def _seeded_history_run():
    pool = Pool(seed=7, config=Config(**FAST))
    for node in pool.nodes.values():
        node.telemetry.wall_sums = False
    agg = FleetAggregator(config=pool.config)
    agg.attach_history(HistoryRecorder(max_slots=128))
    for node in pool.nodes.values():
        node.telemetry.add_sink(agg.ingest)
    u = Ed25519Signer(seed=b"hist-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(8.0)
    return agg


def test_history_ring_replay_determinism():
    """The SAME seeded sim run twice produces a byte-identical history
    ring (wall_sums=False strips RSS + the process-wide verdict cache —
    the non-replayable gauges). The telemetry twin of the tracer's
    wall_durations guard, extended to the fleet row."""
    a, b = _seeded_history_run(), _seeded_history_run()
    assert a.history.history_bytes() == b.history.history_bytes()
    assert len(a.history.rows) > 5
    row = a.history.rows[-1]
    assert row["nodes"] == 4
    fp = row["footprint"]
    assert "process_rss_bytes" not in fp         # stripped for replay
    assert "bls_verdict_cache_entries" not in fp
    assert fp["kv_entries"] > 0


# --- footprint gauges -------------------------------------------------------

def test_node_footprint_gauges_and_metrics_flush():
    pool = Pool(config=Config(**FAST))
    u = Ed25519Signer(seed=b"fp-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(8.0)
    alpha = pool.nodes["Alpha"]
    fp = alpha.footprint()
    for gauge in ("kv_entries", "kv_disk_bytes", "flight_ring_entries",
                  "stashed_entries", "request_state_entries",
                  "dedup_map_entries", "read_cache_entries",
                  "vc_vote_entries", "bls_sig_entries",
                  "bls_verdict_cache_entries"):
        assert isinstance(fp[gauge], int), gauge
    assert fp["kv_entries"] > 0
    # the flush-cadence sampler lands the gauges in the metrics
    # namespace (the sim pool's plain collector never flushes, so
    # drive the sampler directly)
    alpha._sample_footprint_gauges()
    summary = alpha.metrics.summary()
    assert MetricsName.FOOTPRINT_KV_ENTRIES in summary
    assert MetricsName.FOOTPRINT_FLIGHT_RING in summary
    # and the telemetry snapshot ships the footprint section
    snap = alpha.telemetry.ring[-1]
    state_fp = snap["state"]["footprint"]
    assert state_fp["kv_entries"] == pool.nodes["Alpha"].footprint()["kv_entries"]
    assert "process_rss_bytes" in state_fp       # wall_sums=True default


def test_aggregator_fleet_footprint_and_growth_in_summary():
    pool = Pool(config=Config(**FAST))
    agg = FleetAggregator(config=pool.config)
    for node in pool.nodes.values():
        node.telemetry.add_sink(agg.ingest)
    u = Ed25519Signer(seed=b"sum-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u, 1))
    pool.run(10.0)
    summary = agg.fleet_summary()
    fp = summary["footprint"]
    assert fp["kv_entries"] > 0
    verdicts = agg.growth_verdicts()
    assert set(verdicts) >= {"kv_entries", "flight_ring_entries"}
    # a healthy pool: no unbounded_growth alert fired
    assert not [a for a in agg.alerts if a.kind == "unbounded_growth"]


# --- correlate: control ledger + history context ----------------------------

def test_incident_timeline_merges_control_and_history():
    from plenum_tpu_torch.observability.correlate import (format_incidents,
                                                    incident_timelines)
    hist = HistoryRecorder(max_slots=32)
    for i in range(10):
        hist.append({"t": float(i), "tps": 100 + i, "health_min": 1.0})
    alerts = [{"t": 9.5, "kind": "slo_burn.ordering", "subject": "pool",
               "severity": "page", "detail": {}}]
    control = [{"t": 9.8, "policy": "burn", "action": "rate_limit",
                "subject": "pool", "evidence": {}, "cites": []}]
    incidents = incident_timelines([], alerts=alerts, control=control)
    assert len(incidents) == 1
    kinds = incidents[0]["kinds"]
    assert kinds == {"alert.slo_burn.ordering": 1, "control.rate_limit": 1}
    # with a history ring attached, the incident carries walk-in context
    incidents = incident_timelines([], alerts=alerts, control=control,
                                   history=hist, history_n=3)
    ctx = incidents[0]["history"]
    assert [r["t"] for r in ctx] == [7.0, 8.0, 9.0]
    lines = format_incidents(incidents)
    assert any("walked in from:" in ln for ln in lines)


# --- perf sentinel ----------------------------------------------------------

def test_perf_sentinel_self_check():
    from plenum_tpu_torch.tools import perf_sentinel
    assert perf_sentinel.self_check() == []
    assert perf_sentinel.main(["--check"]) == 0


def test_perf_sentinel_repo_trajectory_no_false_regressions():
    """Over the repo's own BENCH_r01..r05 history the sentinel must
    emit ZERO regression verdicts: the r01->r02 headline drop is an
    honesty switch (in-process -> TCP, different headline_config ->
    not_comparable) and the r04->r05 reads drop has no spread baseline
    (-> warn at most)."""
    from plenum_tpu_torch.tools import perf_sentinel
    rep = perf_sentinel.report(bench_dir=REPO_ROOT)
    assert len(rep["rows"]) >= 5
    assert rep["regressions"] == [], rep["regressions"]
    assert any(v["verdict"] == "not_comparable"
               for v in rep["verdicts"] if v["config"] == "headline")
    # legacy rounds predate provenance tagging: the lint must say so
    assert any("jax_source" in p for p in rep["lint"])
    # the reference tool's report over the same files, field for field
    from plenum_tpu.tools import perf_sentinel as ref_sentinel
    assert rep == ref_sentinel.report(bench_dir=REPO_ROOT)


def test_perf_sentinel_flags_synthetic_regression_and_gates_single_pass():
    from plenum_tpu_torch.tools.perf_sentinel import verdicts
    base = {"label": "r1", "configs": {"tcp": {
        "value": 1000.0, "spread_frac": 0.1}}}
    cliff = {"label": "r2", "configs": {"tcp": {"value": 500.0}}}
    vs = verdicts([base, cliff])
    assert [v["verdict"] for v in vs] == ["regression"]
    # the same cliff off a single-pass (no spread) baseline caps at warn
    vs = verdicts([{"label": "r1", "configs": {"tcp": {"value": 1000.0}}},
                   cliff])
    assert [v["verdict"] for v in vs] == ["warn"]
    from plenum_tpu.tools.perf_sentinel import verdicts as ref_verdicts
    assert verdicts([base, cliff]) == ref_verdicts([base, cliff])


def test_perf_sentinel_trajectory_append_roundtrip(tmp_path):
    from plenum_tpu_torch.tools.perf_sentinel import append_trajectory, load_rows
    path = str(tmp_path / "BENCH_trajectory.jsonl")
    parsed = {"tcp_tps": 1234.0, "headline": 1234.0,
              "headline_config": "tcp", "jax_source": "none",
              "host_cores": 8}
    row = append_trajectory(parsed, path, label="run-x")
    assert row["configs"]["tcp"]["value"] == 1234.0
    rows = load_rows(bench_dir=str(tmp_path), trajectory=path)
    assert rows[-1]["label"] == "run-x"
    assert rows[-1]["jax_source"] == "none"
    from plenum_tpu_torch.tools.perf_sentinel import lint_provenance
    assert lint_provenance([rows[-1]]) == []
    from plenum_tpu.tools.perf_sentinel import load_rows as ref_load_rows
    assert rows == ref_load_rows(bench_dir=str(tmp_path), trajectory=path)


@pytest.mark.parametrize("name", [
    "test_node_footprint_gauges_and_metrics_flush",
    "test_aggregator_fleet_footprint_and_growth_in_summary",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_history as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
