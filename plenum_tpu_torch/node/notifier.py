"""Notifier events: push operational anomalies to registered handlers.

Reference behavior: plenum/server/notifier_plugin_manager.py — a plugin
manager that detects suspicious throughput spikes against historical bounds
(sendMessageUponSuspiciousSpike:54, spike math :92-117, thresholds
config.py:165-184 notifierEventTriggeringConfig) and fans topic'd messages
out to whatever notifier plugins are installed; the monitor triggers the
cluster-throughput check on a freq interval (monitor.py:227).

Redesign: one `NotifierEventManager` with register/send, plus the two
event sources the reference wires in production — a cluster-throughput
spike detector fed by the monitor's master EMA, and view-change
notifications from the node. Handlers are plain callables
(topic, message-dict), so the plugins.py seam (or tests, or an ops
process tailing these into alerting) can subscribe without a package
discovery mechanism.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

TOPIC_SPIKE = "clusterThroughputSpike"
TOPIC_VIEW_CHANGE = "viewChange"
TOPIC_NODE_EVENT = "nodeEvent"


class NotifierEventManager:
    def __init__(self,
                 bounds_coeff: float = 10.0,
                 min_cnt: int = 15,
                 min_activity_threshold: float = 10.0,
                 enabled: bool = True):
        self._handlers: list[Callable[[str, dict], Any]] = []
        self.enabled = enabled
        # spike detection state (ref notifier_plugin_manager.py:92-117):
        # a spike = current value outside bounds_coeff x the historical
        # average, once at least min_cnt samples of history exist and the
        # traffic is above the noise floor
        self._bounds_coeff = bounds_coeff
        self._min_cnt = min_cnt
        self._min_activity = min_activity_threshold
        self._hist_avg: Optional[float] = None
        self._hist_cnt = 0

    def register_handler(self, handler: Callable[[str, dict], Any]) -> None:
        self._handlers.append(handler)

    def send(self, topic: str, message: dict) -> int:
        """Fan out to every handler; a failing handler must never take the
        node down (same contract as the reference's plugin sends)."""
        if not self.enabled:
            return 0
        sent = 0
        for handler in self._handlers:
            try:
                handler(topic, dict(message))
                sent += 1
            except Exception:
                pass
        return sent

    # --- spike detection ------------------------------------------------

    def check_throughput(self, value: Optional[float], node_name: str,
                         now: float) -> bool:
        """Feed one throughput sample; emits TOPIC_SPIKE when it falls
        outside the historical bounds. -> spike emitted?

        A detected spike is NOT folded into the history: one extreme
        outlier must flag once and leave the baseline intact, not poison
        the average into alerting on every subsequent normal sample."""
        if not self.enabled or value is None:
            return False
        prev_avg, prev_cnt = self._hist_avg, self._hist_cnt
        is_spike = (prev_avg is not None
                    and prev_cnt >= self._min_cnt
                    and max(value, prev_avg) >= self._min_activity
                    and not (prev_avg / self._bounds_coeff <= value
                             <= prev_avg * self._bounds_coeff))
        if is_spike:
            self.send(TOPIC_SPIKE, {
                "node": node_name, "time": now, "value": value,
                "historical_avg": prev_avg,
                "bounds": (prev_avg / self._bounds_coeff,
                           prev_avg * self._bounds_coeff)})
            return True
        self._hist_cnt += 1
        self._hist_avg = (value if prev_avg is None
                          else prev_avg + (value - prev_avg) / self._hist_cnt)
        return False
