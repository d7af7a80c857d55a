"""ShardRouter: the thin layer that sends each admitted write to the
sub-pool that owns its key.

The router sits BEHIND the ingress seam (ingress/plane.py `sink=`): the
entry node's IngressPlane does admission control, static validation, and
ONE batched signature dispatch, and hands the verified request here
instead of to its own node — the router resolves the owning shard from
the mapping ledger and fans the request into that shard's ordering
instance through the same `submit_preverified` seam the plane would
have used locally. Auth cost is paid once at the front door regardless
of which shard orders the write.

Raw (un-ingressed) submission is also supported for benches and sims
that drive `handle_client_message` directly; both paths share the one
routing decision and its accounting.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.request import Request

from .mapping import MappingLedger, routing_key


class ShardRouter:
    """mapping + per-shard sinks -> one routing decision per write.

    sinks: {shard_id: fn(request: Request, frm: str)} — the owning
    shard's intake (fan to every shard node's `submit_preverified` for
    the behind-ingress path, or `handle_client_message` for raw sims).
    """

    def __init__(self, mapping: MappingLedger,
                 sinks: Mapping[int, Callable[[Request, str], None]],
                 metrics: Optional[MetricsCollector] = None,
                 tracer=None,
                 on_unroutable: Optional[Callable[[Request, str, str],
                                                  None]] = None,
                 health_provider: Optional[Callable[[], Mapping[int, float]]]
                 = None,
                 degraded_floor: float = 0.5,
                 on_shard_down: Optional[Callable[[Request, str, int],
                                                  None]] = None):
        from plenum_tpu_torch.common.tracing import NULL_TRACER
        self.mapping = mapping
        self.sinks = dict(sinks)
        self.metrics = metrics or MetricsCollector()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.on_unroutable = on_unroutable
        # fast-NACK seam: when the fleet aggregator scores the owning
        # shard 0.0 (DOWN — every member silent past the staleness
        # bound), a wired front door refuses the write immediately with
        # a RETRYABLE hint instead of letting the client time out
        # against a dead sub-pool. None (the default) keeps routing
        # un-gated: health stays signal-only, exactly as before.
        self.on_shard_down = on_shard_down
        # live per-shard health from the fleet aggregator
        # (observability/aggregator.py), surfaced through summary() so a
        # degraded shard is visible at the routing layer — SIGNAL ONLY:
        # routing decisions ignore it (live re-routing is PR 12's job).
        # `degraded_floor` matches the aggregator's HEALTH_ALERT_FLOOR:
        # transient expected churn (a view change at 0.8) must not read
        # as "degraded" in summaries when it would not alert either
        self.health_provider = health_provider
        self.degraded_floor = degraded_floor
        self.stats = {"routed": 0, "unroutable": 0, "fast_nacked": 0,
                      "per_shard": {sid: 0 for sid in self.sinks}}

    def add_sink(self, sid: int,
                 sink: Callable[[Request, str], None]) -> None:
        """Register a freshly split-off shard's intake (live reshard)."""
        self.sinks[sid] = sink
        self.stats["per_shard"].setdefault(sid, 0)

    def remove_sink(self, sid: int) -> None:
        """Retire a merged-away shard's intake; its traffic history
        stays in per_shard for the report."""
        self.sinks.pop(sid, None)

    def shard_of(self, request: Request) -> Optional[int]:
        try:
            key = routing_key(request.operation, request.identifier)
            return self.mapping.shard_of(key).shard_id
        except Exception:
            return None

    def route(self, request: Request, frm: str,
              on_shard_down: Optional[Callable[[Request, str, int],
                                               None]] = None
              ) -> Optional[int]:
        """-> the shard id the write went to, or None (unroutable: no
        owning shard in the map, or no sink for it — surfaced through
        on_unroutable so the front door can NACK instead of black-hole).
        `on_shard_down` may be passed PER CALL so each front door's
        fast-NACK replies through its own client channel (a router
        shared by several ingress planes must not clobber one global
        callback); falls back to the instance-level one."""
        sid = self.shard_of(request)
        sink = self.sinks.get(sid) if sid is not None else None
        if sink is None:
            self.stats["unroutable"] += 1
            self.metrics.add_event(MetricsName.SHARD_UNROUTABLE)
            if self.on_unroutable is not None:
                self.on_unroutable(request, frm, "no shard owns this key")
            return None
        if on_shard_down is None:
            on_shard_down = self.on_shard_down
        if on_shard_down is not None and \
                self.health_provider is not None and \
                self.health_provider().get(sid) == 0.0:
            # the owning shard is DOWN by the aggregator's staleness
            # rule (every member silent) — refuse fast and retryable
            # rather than black-hole into a dead sub-pool. 0.0 exactly:
            # merely-degraded shards (breaker open, view change) still
            # take writes and must keep taking them.
            self.stats["fast_nacked"] += 1
            self.metrics.add_event(MetricsName.SHARD_FAST_NACKS)
            on_shard_down(request, frm, sid)
            return None
        self.stats["routed"] += 1
        self.stats["per_shard"][sid] = \
            self.stats["per_shard"].get(sid, 0) + 1
        self.metrics.add_event(MetricsName.SHARD_ROUTED)
        if self.tracer.enabled:
            self.tracer.emit(tracing.SHARD_ROUTE, request.digest,
                             {"shard": sid, "frm": frm})
        sink(request, frm)
        return sid

    def summary(self) -> dict:
        out = {"routed": self.stats["routed"],
               "unroutable": self.stats["unroutable"],
               "fast_nacked": self.stats["fast_nacked"],
               "per_shard": dict(self.stats["per_shard"])}
        if self.health_provider is not None:
            health = self.health_provider()
            if health:
                out["shard_health"] = {sid: round(h, 3)
                                       for sid, h in sorted(health.items())}
                out["degraded_shards"] = sorted(
                    sid for sid, h in health.items()
                    if h < self.degraded_floor)
        return out
