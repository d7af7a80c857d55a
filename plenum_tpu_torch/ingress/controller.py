"""AIMD admission controller for the ingress plane.

Same control pattern as the ordering loop's batch controller
(consensus/batch_controller.py): timer-stamped samples fold into a
rolling queue-wait p95, and decisions fire on SAMPLE ARRIVALS past the
interval deadline — never on a free-running repeating timer — so a
MockTimer-driven pool adapts identically on every replay.

Two knobs, steered toward ``INGRESS_SLO_P95`` (queue-wait p95):

  * **admit_max** — the per-tick weighted-fair dequeue budget into the
    batched verifier. Queue wait over the SLO means requests sit queued
    longer than the target: grow the budget multiplicatively (bigger
    auth batches also amortize BETTER on the device — draining harder is
    free twice). Under the SLO it decays additively back toward the
    configured default so a burst-grown budget does not pin the device
    shape large forever.
  * **shed_watermark** — the effective global queue bound. Sustained SLO
    violation even at full drain budget means arrivals genuinely exceed
    service capacity: cut the watermark multiplicatively so the plane
    sheds EARLIER (clients get an explicit LoadShed now instead of a
    timeout later — shed-before-wedge). Headroom recovers it additively
    toward the configured high watermark.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import MetricsName, percentile
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.config import Config

_WINDOW = 512


class IngressController:
    def __init__(self, config: Config, timer: TimerService,
                 tracer=None, metrics=None):
        self._config = config
        self._timer = timer
        self._tracer = tracer if tracer is not None else tracing.NULL_TRACER
        self._metrics = metrics

        self._admit_default = max(config.INGRESS_ADMIT_MIN,
                                  min(128, config.INGRESS_ADMIT_MAX))
        self.admit_max = self._admit_default
        self.shed_watermark = config.INGRESS_HIGH_WATERMARK
        # floor strictly ABOVE the latch-release mark: a fully-shrunk
        # watermark that equals INGRESS_LOW_WATERMARK would collapse the
        # hysteresis band to zero width and flap admit/shed per arrival
        self._watermark_floor = min(
            config.INGRESS_HIGH_WATERMARK,
            max(2 * config.INGRESS_LOW_WATERMARK,
                config.INGRESS_HIGH_WATERMARK // 8))
        self._watermark_step = max(
            1, config.INGRESS_HIGH_WATERMARK // 16)

        self._waits: deque = deque(maxlen=_WINDOW)
        self._fresh = 0
        self.decisions = 0
        self.last_decision: dict = {}
        self._next_decision = (timer.get_current_time()
                               + config.INGRESS_CONTROL_INTERVAL)

    # --- observations ----------------------------------------------------

    def note_admitted(self, queue_wait: float) -> None:
        """One request left its client queue for the auth batch; how long
        it waited (timer-stamped)."""
        self._waits.append(max(0.0, queue_wait))
        self._fresh += 1
        now = self._timer.get_current_time()
        if now >= self._next_decision:
            self._next_decision = now + self._config.INGRESS_CONTROL_INTERVAL
            self.tick()

    # --- the control loop ------------------------------------------------

    def wait_p95(self) -> float:
        return percentile(self._waits, 0.95) if self._waits else 0.0

    def tick(self) -> None:
        if not self._fresh:
            return                      # idle front door: hold the knobs
        self._fresh = 0
        p95 = self.wait_p95()
        p50 = percentile(self._waits, 0.5) if self._waits else 0.0
        slo = self._config.INGRESS_SLO_P95
        cfg = self._config
        if p95 > slo:
            if self.admit_max < cfg.INGRESS_ADMIT_MAX:
                # drain harder first: a larger fair-dequeue budget both
                # cuts the wait and grows the amortized auth batch
                verdict = "grow:drain"
                self.admit_max = min(cfg.INGRESS_ADMIT_MAX,
                                     self.admit_max * 2)
            else:
                # already draining at the cap and still over SLO:
                # arrivals exceed capacity — shed earlier
                verdict = "shrink:watermark"
                self.shed_watermark = max(self._watermark_floor,
                                          int(self.shed_watermark * 0.7))
        else:
            verdict = "recover:headroom"
            if self.shed_watermark < cfg.INGRESS_HIGH_WATERMARK:
                self.shed_watermark = min(cfg.INGRESS_HIGH_WATERMARK,
                                          self.shed_watermark
                                          + self._watermark_step)
            if p95 < 0.5 * slo and self.admit_max > self._admit_default:
                self.admit_max = max(self._admit_default,
                                     self.admit_max // 2)
        self.decisions += 1
        self._waits.clear()             # judge each interval on its own
        self.last_decision = {
            "verdict": verdict,
            "admit_max": self.admit_max,
            "watermark": self.shed_watermark,
            "wait_p50_ms": round(p50 * 1000, 3),
            "wait_p95_ms": round(p95 * 1000, 3),
            "slo_ms": round(slo * 1000, 3),
        }
        if self._tracer.enabled:
            self._tracer.emit(tracing.ING_CONTROLLER, "", self.last_decision)
        if self._metrics is not None:
            self._metrics.add_event(MetricsName.INGRESS_CTL_ADMIT,
                                    self.admit_max)
            self._metrics.add_event(MetricsName.INGRESS_CTL_WATERMARK,
                                    self.shed_watermark)
            self._metrics.add_event(MetricsName.INGRESS_CTL_DECISIONS,
                                    self.decisions)

    def trajectory(self) -> dict:
        return {
            "decisions": self.decisions,
            "admit_max": self.admit_max,
            "watermark": self.shed_watermark,
            "slo_ms": round(self._config.INGRESS_SLO_P95 * 1000, 3),
            **({"last": self.last_decision} if self.last_decision else {}),
        }


def make_ingress_controller(config: Config, timer: TimerService,
                            tracer=None, metrics=None
                            ) -> Optional[IngressController]:
    """Config-gated seam: INGRESS_CONTROLLER=False -> None, and the plane
    runs the static INGRESS_ADMIT_MAX / INGRESS_HIGH_WATERMARK knobs."""
    if not getattr(config, "INGRESS_CONTROLLER", True):
        return None
    return IngressController(config, timer, tracer=tracer, metrics=metrics)
