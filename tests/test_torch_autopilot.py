"""The port's copy of tests/test_autopilot.py, run on plenum_tpu_torch (nodes on
the CPU).

Autopilot control plane (docs/robustness.md "Autopilot"): sustained
judgment streaks on the aggregator, the reshard manager's idempotent
entry guard, the control ledger + its audit lint, the degradation
ladder's actuation, and the AUTOPILOT=False identity pin.

The live closed-loop scenarios (split under zipfian flood, lane re-pin
around a sick chip, observer scale-out, the composed stress run) live
in test_sim_fuzz.py as the `autopilot` fuzz kind.
"""
from __future__ import annotations

import pytest

from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.control import (CONTROL_LEDGER_ID, ControlLedger, LADDER,
                                REVERT_OF, make_autopilot)
from plenum_tpu_torch.observability import FleetAggregator
from plenum_tpu_torch.shards import ShardedSimFabric
from plenum_tpu_torch.tools.control_audit import audit_records, replay


def _snap(node, seq, t, shard=None, ordered=0, slo=None, devices=None):
    state = {"node": {"ordered_total": ordered, "view_no": 0,
                      "vc_in_progress": False, "catchup_running": False,
                      "read_only_degraded": False, "validators": 4,
                      "anchor_age": 1.0}}
    if slo is not None:
        state["ingress"] = {"queue_depth": 0, "shedding": False,
                            "slo": slo}
    if devices is not None:
        state["pipeline"] = {
            "devices": devices,
            "breakers_open": sum(1 for d in devices
                                 if d.get("breaker") != "closed")}
    return {"v": 1, "node": node, "seq": seq, "t": t,
            **({"tags": {"shard": shard}} if shard is not None else {}),
            "counters": {}, "sampled": {}, "state": state}


def _agg(**over):
    cfg = dict(SLO_BURN_FAST_WINDOW=5.0, SLO_BURN_SLOW_WINDOW=20.0,
               TELEMETRY_INTERVAL=1.0)
    cfg.update(over)
    return FleetAggregator(config=Config(**cfg))


# --- sustained judgment streaks ----------------------------------------------

def test_sustained_counts_consecutive_burn_intervals():
    """`sustained(kind, N)` = N consecutive pool-interval judgments
    over threshold; one clean interval resets the streak, and recovery
    builds the `sustained_clear` streak the undo policies gate on."""
    agg = _agg()
    for i in range(30):
        agg.ingest(_snap("N1", i, float(i), slo=[4, 5]))
    assert agg.sustained("slo_burn.ingress", 3, subject="N1")
    assert agg.sustained("slo_burn.ingress", 3)           # any-subject
    assert agg.sustained_subjects("slo_burn.ingress", 3) == ["N1"]
    assert not agg.sustained("slo_burn.batch", 1)
    assert not agg.sustained_clear("slo_burn.ingress", 1, subject="N1")
    # recovery: clean intervals age the burn out of both windows, the
    # active streak zeroes, and the clear streak accumulates
    for i in range(30, 70):
        agg.ingest(_snap("N1", i, float(i), slo=[0, 5]))
    assert not agg.sustained("slo_burn.ingress", 1, subject="N1")
    assert agg.sustained_clear("slo_burn.ingress", 5, subject="N1")
    assert agg.sustained_clear("slo_burn.ingress", 5)     # every subject
    # a kind never noted is vacuously clear — the recover path must not
    # deadlock on signals that never existed
    assert agg.sustained_clear("slo_burn.reads", 99)


def test_sustained_streak_resets_on_a_single_clean_interval():
    agg = _agg()
    for i in range(12):
        agg.ingest(_snap("N1", i, float(i), slo=[5, 5]))
    assert agg.sustained("slo_burn.ingress", 3, subject="N1")
    streak = agg._streaks[("slo_burn.ingress", "N1")]
    # one interval under threshold: consecutive means CONSECUTIVE
    for i in range(12, 40):
        agg.ingest(_snap("N1", i, float(i), slo=[0, 5]))
        if not agg.sustained("slo_burn.ingress", 1, subject="N1"):
            break
    assert agg._streaks[("slo_burn.ingress", "N1")] == 0
    assert streak >= 3


def test_lane_breaker_judgments_feed_pipeline_streaks():
    agg = _agg()
    sick = [{"lane": 0, "breaker": "closed", "occupancy": 0},
            {"lane": 2, "breaker": "open", "occupancy": 3}]
    for i in range(4):
        agg.ingest(_snap("N1", i, float(i), devices=sick))
    assert agg.lane_breakers() == {0: False, 2: True}
    assert agg.sustained("pipeline.lane", 3, subject="2")
    assert not agg.sustained("pipeline.lane", 1, subject="0")
    healed = [{"lane": 0, "breaker": "closed", "occupancy": 0},
              {"lane": 2, "breaker": "closed", "occupancy": 0}]
    for i in range(4, 10):
        agg.ingest(_snap("N1", i, float(i), devices=healed))
    assert agg.sustained_clear("pipeline.lane", 4, subject="2")


def test_cold_shard_names_the_underloaded_merge_candidate():
    agg = _agg()
    for i in range(30):
        agg.ingest(_snap("A", i, float(i), shard=0, ordered=i * 40))
        agg.ingest(_snap("B", i, float(i), shard=1, ordered=i))
    rates = agg.ordered_rates()
    assert agg.cold_shard(rates) == 1
    # balanced rates: nobody is cold; an idle pool is balanced, not
    # under-loaded (mean 0 -> None)
    assert agg.cold_shard({0: 10.0, 1: 9.0}) is None
    assert agg.cold_shard({0: 0.0, 1: 0.0}) is None
    assert agg.cold_shard({0: 5.0}) is None
    # under-load is never judged while a shard is HOT (merge must not
    # fight split): the skew above flags shard 0 hot, so the underload
    # streak stayed zero all along
    assert agg.sustained("shard.imbalance", 3)
    assert not agg.sustained("shard.underload", 1)


# --- the reshard manager's idempotent entry guard ----------------------------

def test_maybe_split_is_idempotent_while_busy_and_cooling():
    fab = ShardedSimFabric(
        n_shards=2, nodes_per_shard=3, seed=7,
        config=Config(Max3PCBatchWait=0.05, RESHARD_COOLDOWN=5.0))
    rm = fab.reshard
    assert rm.can_start() and not rm.busy
    m = rm.split(0)
    # second caller during the in-flight migration: clean no-op, not
    # the double-entry assert
    assert rm.busy and not rm.can_start()
    assert rm.maybe_split() is None
    elapsed = 0.0
    while elapsed < 90.0 and m.phase not in ("done", "aborted"):
        fab.run(0.5)
        elapsed += 0.5
    assert m.phase == "done", m.to_dict()
    # done stamps the cooldown: still a no-op until it expires
    now = fab.timer.get_current_time()
    assert rm.cooldown_until > now
    assert not rm.can_start() and rm.maybe_split() is None
    fab.run(rm.cooldown_until - now + 1.0)
    assert rm.can_start()
    assert rm.summary()["cooldown_until"] == round(rm.cooldown_until, 3)


# --- control ledger + audit --------------------------------------------------

def test_control_ledger_orders_records_and_audits_clean():
    clock = [5.0]
    ledger = ControlLedger(now=lambda: clock[0])
    a = ledger.append(policy="lane", action="repin", subject="shard0",
                      evidence={"sick_lane": 1}, pre={"lane": 1},
                      post={"lane": 0}, cooldown_until=15.0)
    clock[0] = 20.0
    b = ledger.append(policy="lane", action="unpin", subject="shard0",
                      evidence={"healed_lane": 1}, pre={"lane": 0},
                      post={"lane": 1}, cooldown_until=30.0, cites=a.seq)
    assert (a.seq, b.seq) == (1, 2) and len(ledger) == 2
    dicts = ledger.to_dicts()
    assert all(d["ledger_id"] == CONTROL_LEDGER_ID for d in dicts)
    assert audit_records(dicts) == []
    assert replay(dicts)["pins"] == {}      # the unpin undid the repin


def test_audit_catches_uncited_undo_and_cooldown_flap():
    clock = [5.0]
    ledger = ControlLedger(now=lambda: clock[0])
    ledger.append(policy="lane", action="repin", subject="shard0",
                  evidence={"sick_lane": 1}, pre={"lane": 1},
                  post={"lane": 0}, cooldown_until=15.0)
    clock[0] = 8.0                           # INSIDE the cooldown window
    ledger.append(policy="lane", action="unpin", subject="shard0",
                  evidence={"healed_lane": 1}, pre={}, post={},
                  cooldown_until=18.0)       # and citing nothing
    problems = audit_records(ledger.to_dicts())
    assert any("cites no earlier record" in p for p in problems)
    assert any("fired inside cooldown" in p for p in problems)
    # every undo action has a forward action to cite
    assert set(REVERT_OF.values()) == {"repin", "observer_spawn",
                                       "degrade"}


def test_control_audit_self_check_is_green():
    """`control_audit --check` is the tier-1 self-test gate (the
    fleet_console --check pattern): a synthetic good ledger lints
    clean and one corrupted variant per lint rule is caught."""
    from plenum_tpu_torch.tools import control_audit
    assert control_audit.main(["--check"]) == 0


# --- the degradation ladder actuates and steps back up -----------------------

def _enabled_fabric(**over):
    cfg = dict(Max3PCBatchWait=0.05, AUTOPILOT=True,
               AUTOPILOT_INTERVAL=0.5, AUTOPILOT_SUSTAIN=2,
               AUTOPILOT_RECOVER_SUSTAIN=2, AUTOPILOT_COOLDOWN=3.0,
               RESHARD_COOLDOWN=3.0, TELEMETRY_INTERVAL=0.5)
    cfg.update(over)
    return ShardedSimFabric(n_shards=2, nodes_per_shard=3, seed=11,
                            config=Config(**cfg))


def test_ladder_degrades_and_recovers_with_cited_undos():
    """Force the sustained-burn judgment directly and watch the ladder
    walk down (shed-harder, then read-only) and back up one level at a
    time — every step a ledger record, every recover citing its
    degrade, never two steps inside one cooldown window."""
    fab = _enabled_fabric()
    ap = fab.autopilot
    agg = fab.aggregator
    entry = fab.shards[0].names[0]
    plane = fab.ingress_plane(entry, tick=False)
    base_wm = plane.shed_watermark

    def tick(burning: bool):
        agg.now += ap._interval
        key = ("slo_burn.ingress", "front")
        if burning:
            agg._streaks[key] = agg._streaks.get(key, 0) + 1
            agg._clear_streaks[key] = 0
        else:
            agg._clear_streaks[key] = agg._clear_streaks.get(key, 0) + 1
            agg._streaks[key] = 0
        ap.service()

    def drive(burning, until, limit=40):
        for _ in range(limit):
            if until():
                return
            tick(burning)
        raise AssertionError(f"ladder stuck at {ap.summary()}")

    drive(True, lambda: ap.level == 1)
    assert plane.shed_watermark == max(
        1, fab.config.INGRESS_HIGH_WATERMARK // ap._shed_factor)
    assert plane.shed_watermark < base_wm
    drive(True, lambda: ap.level == 2)
    assert all(n.read_only_degraded for n in fab.nodes.values())
    # held at the ladder's floor: more burn adds holds, never actions
    floor_actions = ap.counts["actions"]
    for _ in range(6):
        tick(True)
    assert ap.level == 2 and ap.counts["actions"] == floor_actions
    # recovery: one level at a time, each recover citing its degrade
    drive(False, lambda: ap.level == 1)
    assert not any(n.read_only_degraded for n in fab.nodes.values())
    drive(False, lambda: ap.level == 0)
    assert plane.shed_watermark == base_wm
    recs = ap.ledger.to_dicts()
    degrades = [r for r in recs if r["action"] == "degrade"]
    recovers = [r for r in recs if r["action"] == "recover"]
    assert [r["subject"] for r in degrades] == ["shed_harder",
                                                "read_only"]
    assert [r["subject"] for r in recovers] == ["read_only",
                                                "shed_harder"]
    assert [r["cites"] for r in recovers] == \
        [degrades[1]["seq"], degrades[0]["seq"]]          # LIFO undo
    assert audit_records(recs) == []
    assert replay(recs)["level"] == 0
    assert ap.summary()["state"] == LADDER[0]


def test_ladder_never_undegrades_a_catchup_diverged_node():
    fab = _enabled_fabric()
    node = next(iter(fab.nodes.values()))
    node._degrade_read_only()                # catchup divergence, not us
    assert node.read_only_degraded
    assert not node.set_read_only(True, reason="autopilot")
    assert not node.set_read_only(False, reason="autopilot")
    assert node.read_only_degraded           # autopilot never clears it


# --- AUTOPILOT=False is identity ---------------------------------------------

def test_autopilot_off_is_todays_behavior_exactly():
    fab = ShardedSimFabric(n_shards=2, nodes_per_shard=3, seed=3,
                           config=Config(Max3PCBatchWait=0.05))
    assert fab.autopilot is None
    assert make_autopilot(fab) is None
    fab.run(3.0)
    assert fab.aggregator.autopilot is None
    assert not any(name.startswith("autopilot.")
                   for name in fab.metrics.accumulators)
    assert "autopilot" not in fab.summary()


def test_autopilot_on_decides_on_aggregator_intervals():
    fab = _enabled_fabric()
    ap = fab.autopilot
    assert ap is not None
    fab.run(3.0)
    assert ap.counts["decisions"] >= 2
    assert ap.counts["actions"] == 0         # healthy pool: no actuation
    assert fab.aggregator.autopilot == ap.summary()
    assert "autopilot.decisions" in fab.metrics.accumulators
    # the cadence rides the FLEET clock: with no snapshot arrivals the
    # autopilot does not keep ticking (deterministic replay) — at most
    # one boundary fire when the clock sits exactly on the next mark
    ap.service()
    before = ap.counts["decisions"]
    for _ in range(10):
        ap.service()
    assert ap.counts["decisions"] == before


# --- the port's observer fleet ------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "torch"])
def test_observer_fleet_spawns_on_the_fabrics_backend(backend):
    """ObserverFleet.spawn builds every observer on the fabric's
    config.crypto_backend, as the fabric's own nodes are built (the
    reference's fabric reads it too, plenum_tpu/shards/fabric.py:72).
    Without it an observer took the port's default, the card: it raised
    here, and on a card machine put a CPU fabric's observers on the
    GPU."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    fab = ShardedSimFabric(n_shards=2, nodes_per_shard=3, seed=3,
                           config=Config(Max3PCBatchWait=0.05,
                                         crypto_backend=backend))
    fleet = fab.attach_observer_fleet(regions=("r0",))
    fleet.spawn("r0")
    assert fleet.count("r0") == 2

    def backend_of(c):
        tree = c.db.get_ledger(DOMAIN_LEDGER_ID).tree
        verifier = c.authenticator.core_authenticator.verifier
        return type(tree.hasher).__name__, type(verifier).__name__

    node = fab.shards[0].nodes[fab.shards[0].names[0]]
    for obs in fleet.regions["r0"]:
        assert backend_of(obs.c) == backend_of(node.c)
    fab.run(1.0)
