"""Live fleet telemetry plane.

Everything the earlier observability planes record is *post-hoc* —
`metrics_report` and `trace_report` read dumps after the run ends. This
package turns the node-local counters into a LIVE, pool-wide signal:

- ``snapshot.py``  — a per-node :class:`TelemetryEmitter` producing
  compact, replay-deterministic periodic snapshots (counter deltas,
  sampled p50/p95s, breaker/catchup/view-change/degraded state, ingress
  queue depth + shed rate, crypto-pipeline wave occupancy + bucket hit
  rate, per-node ordered totals) stamped on the injectable timer,
  shipped to in-process sinks, over the wire as a best-effort
  ``TELEMETRY`` message, and into a bounded on-disk spool;
- ``aggregator.py`` — :class:`FleetAggregator` composing snapshots into
  the pool/shard-wide view: per-node and per-shard health scores, the
  shard load-imbalance index elastic resharding will consume,
  per-node/per-region anchor staleness, and multi-window SLO burn-rate
  tracking with structured alerts that also land in the flight-recorder
  ring;
- ``correlate.py`` — cross-node anomaly correlation: flight-recorder
  anomalies from every node stitched onto one aligned clock (reusing
  trace_report's alignment) into pool-wide incident timelines, with
  autopilot control-ledger decisions and history-ring context merged in;
- ``history.py``   — the fleet history plane: a bounded on-disk
  :class:`HistoryRecorder` ring of per-interval fleet rows and the
  :class:`GrowthWatch` resource-footprint trend fit behind the
  ``unbounded_growth`` alert.

Disabled (``TELEMETRY: false``) the whole plane collapses to the shared
:data:`NULL_TELEMETRY` — one attribute check per call site, no timer
registered — pinned by a microbenchmark assertion like ``NullTracer``.
"""
from .snapshot import (NULL_TELEMETRY, CumulativeDelta, NullTelemetry,
                       SNAPSHOT_SCHEMA, TelemetryEmitter, make_telemetry,
                       snapshot_bytes)
from .history import (GROWTH_EXEMPT_GAUGES, GrowthWatch, HistoryRecorder,
                      linear_slope)
from .aggregator import Alert, BurnRateTracker, FleetAggregator
from .correlate import incident_timelines

__all__ = ["NULL_TELEMETRY", "CumulativeDelta", "NullTelemetry",
           "SNAPSHOT_SCHEMA", "TelemetryEmitter", "make_telemetry",
           "snapshot_bytes", "Alert", "BurnRateTracker", "FleetAggregator",
           "incident_timelines", "GROWTH_EXEMPT_GAUGES", "GrowthWatch",
           "HistoryRecorder", "linear_slope"]
