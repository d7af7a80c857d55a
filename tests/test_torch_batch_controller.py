"""The port's copy of tests/test_batch_controller.py, run on plenum_tpu_torch.

Closed-loop batch controller + deep-pipeline ordering tests.

Controller determinism: every sample the controller sees is stamped on the
injectable timer and every decision is a pure function of those samples —
these tests drive MockTimer and assert exact knob movements (no wall-clock
reads anywhere in the control path). The pipeline tests use the PoolSim
service harness from test_consensus.
"""
import pytest

from plenum_tpu_torch.common.internal_messages import ViewChangeStarted
from plenum_tpu_torch.common.node_messages import Checkpoint, Commit
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.consensus.batch_controller import (BatchController,
                                                   make_controller)
from plenum_tpu_torch.network import Discard, Stash, match_type

from test_torch_consensus import NODES, PoolSim, make_request


def make_ctl(timer=None, **overrides) -> BatchController:
    cfg = Config(**overrides)
    return BatchController(cfg, timer or MockTimer())


# --- controller policy (pure, deterministic) -------------------------------


def test_idle_tick_holds_every_knob():
    ctl = make_ctl()
    before = (ctl.batch_size, ctl.batch_wait, ctl.depth,
              ctl.group_commit_max)
    ctl.tick()
    assert (ctl.batch_size, ctl.batch_wait, ctl.depth,
            ctl.group_commit_max) == before
    assert ctl.decisions == 0


def test_queueing_dominated_shrinks_wait_and_full_batches():
    """SLO violated with queue wait the largest stage: requests spend
    their latency WAITING — the wait shrinks multiplicatively, and the
    batch size too when batches are being cut full."""
    ctl = make_ctl(Max3PCBatchWait=0.1, BATCH_SLO_P95=0.2)
    for _ in range(20):
        ctl.note_batch_cut(queue_wait=0.5, n_reqs=ctl.batch_size)  # full
        ctl.note_ordered(0.01)
    size0, wait0 = ctl.batch_size, ctl.batch_wait
    ctl.tick()
    assert ctl.last_decision["verdict"] == "shrink:queueing"
    assert ctl.batch_wait == pytest.approx(wait0 * 0.5)
    assert ctl.batch_size < size0
    # repeated pressure floors at the configured bounds, never below
    for _ in range(40):
        for _ in range(4):
            ctl.note_batch_cut(0.5, ctl.batch_size)
            ctl.note_ordered(0.01)
        ctl.tick()
    assert ctl.batch_wait == pytest.approx(Config().BATCH_WAIT_MIN)
    assert ctl.batch_size == Config().BATCH_SIZE_MIN


def test_fixed_cost_dominated_grows_wait_and_coalescing():
    """SLO violated, batches underfull, 3PC span dominant: per-batch fixed
    costs are being paid on near-empty batches — the wait GROWS so more
    requests coalesce per batch (sim25's shape: tiny batches, n-squared
    vote flood per batch)."""
    ctl = make_ctl(Max3PCBatchWait=0.05, BATCH_SLO_P95=0.2,
                   GROUP_COMMIT_MAX_BATCHES=32)
    assert ctl.group_commit_max == 8      # starts below the cap (room to act)
    for _ in range(20):
        ctl.note_batch_cut(queue_wait=0.01, n_reqs=30)   # 3% full
        ctl.note_ordered(0.5)                            # costly 3PC
    wait0, coal0 = ctl.batch_wait, ctl.group_commit_max
    ctl.tick()
    assert ctl.last_decision["verdict"] == "grow:fixed-cost"
    assert ctl.batch_wait == pytest.approx(wait0 * 1.5)
    assert ctl.group_commit_max == coal0 + 4
    # and it caps at BATCH_WAIT_MAX under sustained pressure
    for _ in range(40):
        for _ in range(4):
            ctl.note_batch_cut(0.01, 30)
            ctl.note_ordered(0.5)
        ctl.tick()
    assert ctl.batch_wait == pytest.approx(Config().BATCH_WAIT_MAX)


def test_saturated_full_batches_shrink_depth():
    """SLO violated with FULL batches and service-side spans dominant:
    genuinely too much in flight — the speculative window backs off."""
    ctl = make_ctl(BATCH_SLO_P95=0.2)
    depth0 = ctl.depth
    for _ in range(20):
        ctl.note_batch_cut(queue_wait=0.01, n_reqs=ctl.batch_size)
        ctl.note_ordered(0.5)
    ctl.tick()
    assert ctl.last_decision["verdict"] == "shrink:depth"
    assert ctl.depth == int(depth0 * 0.7)
    # floors at the legacy window of 4, never a dead pipeline
    for _ in range(40):
        for _ in range(4):
            ctl.note_batch_cut(0.01, ctl.batch_size)
            ctl.note_ordered(0.5)
        ctl.tick()
    assert ctl.depth == 4


def test_headroom_deepens_and_decays_grown_wait():
    ctl = make_ctl(Max3PCBatchWait=0.05, BATCH_SLO_P95=0.5,
                   Max3PCBatchesInFlight=64)
    ctl.depth = 10
    ctl.batch_wait = 0.4                   # left high by a past episode
    ctl.group_commit_max = 20              # ditto
    for _ in range(10):
        ctl.note_batch_cut(queue_wait=0.001, n_reqs=ctl.batch_size)
        ctl.note_ordered(0.005)
    size0 = ctl.batch_size
    ctl.tick()
    assert ctl.last_decision["verdict"] == "grow:headroom"
    assert ctl.depth == 11                 # additive increase
    assert ctl.batch_size == size0         # already at the config cap
    assert ctl.batch_wait == pytest.approx(0.4 * 0.9)
    assert ctl.group_commit_max == 19      # decays toward its start value


def test_load_shift_moves_knobs_in_expected_direction():
    """The acceptance shape: a deterministic load shift on the injectable
    timer moves the chosen knobs the expected way — light load grows the
    window, a queue-wait storm shrinks wait/size, and recovery grows the
    window again."""
    timer = MockTimer()
    cfg = Config(Max3PCBatchWait=0.05, BATCH_SLO_P95=0.2,
                 BATCH_CONTROL_INTERVAL=0.5)
    ctl = BatchController(cfg, timer)
    ctl.depth = 8

    def feed(n, wait, fill, span):
        for _ in range(n):
            ctl.note_batch_cut(wait, fill)
            ctl.note_ordered(span)
        timer.advance(0.5)
        ctl.note_ordered(span)    # first sample past the deadline decides

    feed(10, wait=0.001, fill=ctl.batch_size, span=0.01)   # light
    assert ctl.depth == 9
    depth_light = ctl.depth
    size_light = ctl.batch_size
    for _ in range(3):                                     # overload
        feed(10, wait=0.6, fill=ctl.batch_size, span=0.01)
    assert ctl.batch_wait < 0.05 and ctl.batch_size < size_light
    feed(10, wait=0.001, fill=ctl.batch_size, span=0.01)   # recovery
    assert ctl.depth == depth_light + 1
    assert ctl.decisions == 5


def test_decisions_ride_the_tracer():
    timer = MockTimer()
    tracer = tracing.Tracer("N", timer.get_current_time)
    ctl = BatchController(Config(BATCH_SLO_P95=0.2), timer, tracer=tracer)
    ctl.note_batch_cut(0.5, ctl.batch_size)
    ctl.note_ordered(0.01)
    ctl.tick()
    events = [e for e in tracer.ring if e[1] == tracing.CONTROLLER]
    assert len(events) == 1
    assert events[0][3]["verdict"] == "shrink:queueing"
    assert events[0][3]["slo_ms"] == 200.0


def test_make_controller_config_gate():
    assert make_controller(Config(BATCH_CONTROLLER=False), MockTimer()) is None
    assert make_controller(Config(), MockTimer()) is not None


# --- satellite regression: the leftover-queue wait clock -------------------


def test_partial_batch_wait_clock_survives_inflight_backpressure():
    """Regression: send_3pc_batch used to re-arm the per-ledger wait clock
    on every prod tick that left a leftover queue — so while the in-flight
    gate held fresh cuts back, a queued partial batch's Max3PCBatchWait
    restarted every tick, and after the gate opened it still waited one
    FULL extra period. The enqueue stamp now rides the queue entry itself:
    once capacity frees, a request that has already waited out the bound
    is cut on the next service pass."""
    pool = PoolSim(config=Config(Max3PCBatchWait=1.0,
                                 Max3PCBatchesInFlight=1,
                                 BATCH_CONTROLLER=False))
    pool.net.set_latency(0.001, 0.01)     # keep delivery ≪ the batch wait
    primary = pool.primary_name()
    ordering = pool.replicas[primary].ordering
    # batch 1 occupies the whole in-flight window (commits stashed)
    rule = pool.net.add_rule(Stash(), match_type(Commit))
    pool.finalize_request(make_request(0))
    pool.run(1.5)
    assert pool.replicas[primary].data.pp_seq_no == 1
    assert not pool.ordered[primary]
    # a second request arrives and waits OUT its full bound behind the gate
    pool.finalize_request(make_request(1))
    pool.run(2.0)
    assert pool.replicas[primary].data.pp_seq_no == 1   # gate held
    # heal: stashed commits deliver, batch 1 orders, the gate opens —
    # the overdue partial batch must cut on the next service pass, NOT
    # after another full Max3PCBatchWait
    pool.net.remove_rule(rule)
    pool.run(0.5, step=0.25)
    assert pool.replicas[primary].data.pp_seq_no == 2, \
        "overdue partial batch waited a fresh full period after the " \
        "in-flight gate opened (wait clock was re-armed)"


# --- deep pipeline ---------------------------------------------------------


def test_deep_window_pins_at_high_watermark_and_resumes():
    """Speculative cuts run to the high watermark and STOP (the protocol
    bound); once checkpoints stabilize and the window slides, the backlog
    drains. LOG_SIZE=4 with CHK_FREQ=2 so the boundary is cheap to hit."""
    pool = PoolSim(config=Config(Max3PCBatchSize=1, Max3PCBatchWait=0.0,
                                 CHK_FREQ=2, LOG_SIZE=4,
                                 BATCH_CONTROLLER=False,
                                 Max3PCBatchesInFlight=300))
    primary = pool.primary_name()
    # hold checkpoint traffic: the watermark window cannot slide
    rule = pool.net.add_rule(Stash(), match_type(Checkpoint))
    for i in range(10):
        pool.finalize_request(make_request(i))
    pool.run(5.0)
    data = pool.replicas[primary].data
    assert data.pp_seq_no == data.high_watermark == 4, \
        f"primary ran past the watermark window: {data.pp_seq_no}"
    assert sum(len(q) for q in
               pool.replicas[primary].ordering.request_queues.values()) == 6
    # heal: checkpoints stabilize, the window slides, the backlog drains
    pool.net.remove_rule(rule)
    pool.run(8.0)
    for name in NODES:
        assert [o.pp_seq_no for o in pool.ordered[name]] == list(range(1, 11))


def _slow_commit_cut_depth(depth: int) -> tuple[int, int]:
    """-> (pp_seq_no cut, batches ordered) at a fixed sim time, with every
    COMMIT delayed 1.0 s and a steady request trickle."""
    pool = PoolSim(config=Config(Max3PCBatchSize=1, Max3PCBatchWait=0.0,
                                 BATCH_CONTROLLER=False,
                                 Max3PCBatchesInFlight=depth))
    pool.net.set_latency(0.001, 0.002)
    from plenum_tpu_torch.network import Deliver
    pool.net.add_rule(Deliver(1.0, 1.0), match_type(Commit))
    primary = pool.primary_name()
    for i in range(30):
        pool.finalize_request(make_request(i))
        pool.run(0.05, step=0.05)
    pool.run(0.5, step=0.05)
    return (pool.replicas[primary].data.pp_seq_no,
            len(pool.ordered[primary]))


def test_deep_window_decouples_cuts_from_slow_commits():
    """The tentpole's core claim, deterministically: with COMMITs slowed to
    1 s, the legacy 4-deep window stalls every fresh cut behind the oldest
    uncommitted batch, while the deep window keeps cutting speculative
    batches — same pool, same trickle, same sim clock."""
    deep_cut, deep_ordered = _slow_commit_cut_depth(64)
    legacy_cut, legacy_ordered = _slow_commit_cut_depth(4)
    assert legacy_cut <= legacy_ordered + 4     # the old hard ceiling
    assert deep_cut >= legacy_cut * 2, \
        f"deep window cut only {deep_cut} vs legacy {legacy_cut}"
    assert deep_ordered >= legacy_ordered


def test_view_change_reverts_deep_speculative_stack_in_reverse():
    """N>4 speculative uncommitted applies revert in EXACT reverse apply
    order on a view change (the deep-pipeline extension of the reference's
    _revert contract)."""
    n_batches = 7
    pool = PoolSim(config=Config(Max3PCBatchSize=1, Max3PCBatchWait=0.0,
                                 Max3PCBatchesInFlight=300))
    primary = pool.primary_name()
    executor = pool.executors[primary]
    rule = pool.net.add_rule(Discard(), match_type(Commit))
    for i in range(n_batches):
        pool.finalize_request(make_request(i))
    pool.run(3.0)
    applied = list(executor.applied)
    assert len(applied) == n_batches > 4
    reverted = []
    original = executor.revert_last_batch

    def spying_revert(ledger_id):
        reverted.append(executor.applied[-1])
        original(ledger_id)

    executor.revert_last_batch = spying_revert
    pool.replicas[primary].ordering.process_view_change_started(
        ViewChangeStarted(view_no=1))
    assert reverted == list(reversed(applied))
    assert executor.applied == []
    pool.net.remove_rule(rule)
