"""Closed-loop AIMD steering of the 3PC batching knobs.

The reference runs `Max3PCBatchSize` / `Max3PCBatchWait` / the in-flight
window as static config: right for exactly one pool shape and wrong for
every other. This controller closes the loop the tracing plane opened
(ROADMAP item 2): the ordering hot path stamps each batch's lifecycle on
the node's INJECTABLE timer — queue wait at cut, cut → commit-quorum span,
group-commit flush span — and every `BATCH_CONTROL_INTERVAL` the
controller folds those samples into rolling per-stage p50/p95 attribution
and moves the knobs toward the latency SLO:

  * **queueing dominates** (queue-wait p95 is the largest stage and the
    SLO is violated): requests sit waiting to be batched — shrink the
    partial-batch wait multiplicatively, and the batch size too when
    batches are being cut full (latency is spent FILLING them).
  * **fixed per-batch costs dominate** (SLO violated, batches underfull,
    3PC/durable spans dominate): per-batch overhead — n² vote floods, BLS
    sign/verify, the flush — is being paid on batches that carry few
    requests. Grow the wait so more requests coalesce per batch, and
    raise group-commit coalescing so flushes amortize.
  * **saturated** (SLO violated, batches full, service spans dominate):
    genuinely too much work in flight — multiplicatively shrink the
    speculative in-flight depth.
  * **headroom** (p95 under SLO): additive increase — deepen the
    pipeline, grow batch size when batches are cut full, and decay an
    episode-grown wait back toward its configured default.

Determinism: every timestamp the controller sees comes from the node's
TimerService and every decision is a pure function of those samples, so a
MockTimer-driven pool adapts identically on every run — there is NO
wall-clock read anywhere in the control path. Decisions are recorded as
tracer span events (`tracing.CONTROLLER`) so `tools/trace_report.py` can
render the control trajectory next to the latency waterfalls it steered.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import MetricsName, percentile
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.config import Config

# rolling-window length per stage: long enough that p95 is meaningful,
# short enough that the loop tracks a load shift within a few intervals
_WINDOW = 256


class BatchController:
    """One per node (wired into the MASTER ordering service and the node's
    group-commit drain). Only the node currently acting as master primary
    produces cut/ordered samples, so only its controller actually steers;
    the others idle at their defaults until a view change hands them the
    batching decisions."""

    def __init__(self, config: Config, timer: TimerService,
                 tracer=None, metrics=None):
        self._config = config
        self._timer = timer
        self._tracer = tracer if tracer is not None else tracing.NULL_TRACER
        self._metrics = metrics

        # steered knobs (read by OrderingService / Node every cycle).
        # Coalescing starts WELL BELOW its cap so the grow actions have
        # room to act (starting at the cap made both '+4' paths no-ops);
        # headroom decays it back toward this start value.
        self._coalesce_start = max(1, min(8, config.GROUP_COMMIT_MAX_BATCHES))
        self.batch_size = config.Max3PCBatchSize
        self.batch_wait = config.Max3PCBatchWait
        self.depth = config.Max3PCBatchesInFlight
        self.group_commit_max = self._coalesce_start

        # bounds
        self._size_min = min(config.BATCH_SIZE_MIN, config.Max3PCBatchSize)
        self._size_max = config.Max3PCBatchSize
        self._wait_min = config.BATCH_WAIT_MIN
        self._wait_max = max(config.BATCH_WAIT_MAX, config.Max3PCBatchWait)
        self._depth_min = min(4, config.Max3PCBatchesInFlight)
        self._depth_max = config.Max3PCBatchesInFlight
        self._size_step = max(16, config.Max3PCBatchSize // 16)

        # per-stage samples since the LAST decision, all stamped on the
        # injectable timer (bounded; drained at each tick so a load shift
        # is judged on the current interval's samples, not last epoch's)
        self._queue: deque = deque(maxlen=_WINDOW)    # enqueue -> batch cut
        self._ordering: deque = deque(maxlen=_WINDOW)  # cut -> commit quorum
        self._durable: deque = deque(maxlen=_WINDOW)  # drain -> flush closed
        self._fills: deque = deque(maxlen=_WINDOW)    # reqs per cut batch
        self._fresh = 0          # samples since the last decision

        self.decisions = 0
        self.last_decision: dict = {}
        # batch-SLO ledger for the telemetry plane's burn-rate tracking:
        # one check per decision, a violation when the attributed e2e p95
        # exceeded BATCH_SLO_P95 at that decision (cumulative; snapshot
        # sources take deltas)
        self.slo_checks = 0
        self.slo_violations = 0
        # Decisions are driven by SAMPLE ARRIVALS past the interval
        # deadline, NOT by a free-running RepeatingTimer: a repeating
        # timer fires at clock-STEPPING-dependent instants (a live pool
        # services it mid-prod, the replayer at recorded-event jumps), so
        # timer-driven decisions would break the record/replay
        # byte-identical span guarantee AND could change which batch cut
        # sees a new knob value. A sample arrival happens at a
        # message-processing point whose frozen timestamp is identical in
        # live and replay — decisions keyed to it replay exactly. An idle
        # pool therefore makes no decisions, which is also correct: there
        # is nothing to steer.
        self._next_decision = (timer.get_current_time()
                               + config.BATCH_CONTROL_INTERVAL)

    # --- observations (hot path: append-only, no allocation beyond it) ---

    def note_batch_cut(self, queue_wait: float, n_reqs: int) -> None:
        """A batch was cut: how long its oldest request waited in the
        queue, and how many requests it carries."""
        self._queue.append(max(0.0, queue_wait))
        self._fills.append(n_reqs)
        self._fresh += 1
        self._maybe_tick()

    def note_ordered(self, span: float) -> None:
        """Cut -> commit quorum for one batch (the 3PC span)."""
        self._ordering.append(max(0.0, span))
        self._fresh += 1
        self._maybe_tick()

    def note_durable(self, span: float, n_batches: int) -> None:
        """One group-commit scope closed: flush span over n_batches.
        Timer-stamped — and the QueueTimer latches one timestamp per prod
        cycle, so a scope that opens and closes within one cycle reads 0.
        The durable stage therefore only registers when a flush spills
        across cycles (a genuinely slow flush); the routine flush cost
        rides inside the cut->quorum ordering span of the NEXT batches,
        which is the span the controller steers against."""
        self._durable.append(max(0.0, span))
        self._fresh += 1
        self._maybe_tick()

    def _maybe_tick(self) -> None:
        now = self._timer.get_current_time()
        if now >= self._next_decision:
            self._next_decision = now + self._config.BATCH_CONTROL_INTERVAL
            self.tick()

    # --- the control loop -------------------------------------------------

    def stage_p95(self) -> dict:
        return {
            "queue": percentile(self._queue, 0.95) if self._queue else 0.0,
            "ordering": (percentile(self._ordering, 0.95)
                         if self._ordering else 0.0),
            "durable": (percentile(self._durable, 0.95)
                        if self._durable else 0.0),
        }

    def stage_p50(self) -> dict:
        return {
            "queue": percentile(self._queue, 0.5) if self._queue else 0.0,
            "ordering": (percentile(self._ordering, 0.5)
                         if self._ordering else 0.0),
            "durable": (percentile(self._durable, 0.5)
                        if self._durable else 0.0),
        }

    def tick(self) -> None:
        """One AIMD decision from the rolling attribution. Pure function
        of timer-stamped samples — no wall-clock reads."""
        if not self._fresh:
            return                      # idle pool: hold every knob
        self._fresh = 0
        st = self.stage_p95()
        # decision-time attribution snapshot: trajectory() reports THESE
        # (the windows are drained below, so reading them later would show
        # only the post-decision tail)
        self._decided_p50 = self.stage_p50()
        self._decided_p95 = st
        q, o, d = st["queue"], st["ordering"], st["durable"]
        e2e = q + o + d
        slo = self._config.BATCH_SLO_P95
        fill = (sum(self._fills) / len(self._fills) / max(1, self.batch_size)
                if self._fills else 0.0)
        self.slo_checks += 1
        if e2e > slo:
            self.slo_violations += 1
            if q >= max(o, d):
                # requests spend their latency WAITING to be batched
                verdict = "shrink:queueing"
                self.batch_wait = max(self._wait_min, self.batch_wait * 0.5)
                if fill >= 0.9:
                    self.batch_size = max(self._size_min,
                                          int(self.batch_size * 0.7))
            elif fill < 0.5:
                # per-batch overhead paid on underfull batches: coalesce
                verdict = "grow:fixed-cost"
                self.batch_wait = min(self._wait_max, self.batch_wait * 1.5)
                self.group_commit_max = min(
                    self._config.GROUP_COMMIT_MAX_BATCHES,
                    self.group_commit_max + 4)
            else:
                # full batches, service-side spans over SLO: back off depth
                verdict = "shrink:depth"
                self.depth = max(self._depth_min, int(self.depth * 0.7))
                self.group_commit_max = min(
                    self._config.GROUP_COMMIT_MAX_BATCHES,
                    self.group_commit_max + 4)
        else:
            verdict = "grow:headroom"
            self.depth = min(self._depth_max, self.depth + 1)
            if fill >= 0.9:
                self.batch_size = min(self._size_max,
                                      self.batch_size + self._size_step)
            # decay episode-grown knobs back toward their starting values
            if self.batch_wait > self._config.Max3PCBatchWait:
                self.batch_wait = max(self._config.Max3PCBatchWait,
                                      self.batch_wait * 0.9)
            if self.group_commit_max > self._coalesce_start:
                self.group_commit_max -= 1
        self.decisions += 1
        # judged: the next interval starts from its own samples, so a
        # load SHIFT moves the knobs within one control interval instead
        # of waiting for stale samples to age out of a rolling window
        self._queue.clear()
        self._ordering.clear()
        self._durable.clear()
        self._fills.clear()
        self.last_decision = {
            "verdict": verdict,
            "batch_size": self.batch_size,
            "wait_ms": round(self.batch_wait * 1000, 3),
            "depth": self.depth,
            "coalesce": self.group_commit_max,
            "p95_ms": {k: round(v * 1000, 3) for k, v in st.items()},
            "e2e_p95_ms": round(e2e * 1000, 3),
            "slo_ms": round(slo * 1000, 3),
            "fill": round(fill, 3),
        }
        if self._tracer.enabled:
            self._tracer.emit(tracing.CONTROLLER, "", self.last_decision)
        if self._metrics is not None:
            self._metrics.add_event(MetricsName.BATCH_CTL_SIZE,
                                    self.batch_size)
            self._metrics.add_event(MetricsName.BATCH_CTL_WAIT,
                                    self.batch_wait)
            self._metrics.add_event(MetricsName.BATCH_CTL_DEPTH, self.depth)
            self._metrics.add_event(MetricsName.BATCH_CTL_COALESCE,
                                    self.group_commit_max)
            # cumulative gauge (read back via max, like breaker_opens)
            self._metrics.add_event(MetricsName.BATCH_CTL_DECISIONS,
                                    self.decisions)

    # --- reporting (bench line / validator info) --------------------------

    def trajectory(self) -> dict:
        """Compact summary for the bench line: where the knobs ENDED and
        the rolling attribution that put them there — the LAST DECISION's
        snapshot (the live windows are drained at each decision, so they
        only hold the post-decision tail; before any decision they are
        the whole story and are used directly)."""
        p50 = getattr(self, "_decided_p50", None) or self.stage_p50()
        p95 = getattr(self, "_decided_p95", None) or self.stage_p95()
        return {
            "decisions": self.decisions,
            "batch_size": self.batch_size,
            "wait_ms": round(self.batch_wait * 1000, 3),
            "depth": self.depth,
            "coalesce": self.group_commit_max,
            "slo_ms": round(self._config.BATCH_SLO_P95 * 1000, 3),
            "stage_p50_ms": {k: round(v * 1000, 3) for k, v in p50.items()},
            "stage_p95_ms": {k: round(v * 1000, 3) for k, v in p95.items()},
            **({"last": self.last_decision} if self.last_decision else {}),
        }


def make_controller(config: Config, timer: TimerService, tracer=None,
                    metrics=None) -> Optional[BatchController]:
    """Config-gated construction seam: BATCH_CONTROLLER=False -> None, and
    every consumer falls back to the static config knobs."""
    if not getattr(config, "BATCH_CONTROLLER", True):
        return None
    return BatchController(config, timer, tracer=tracer, metrics=metrics)
