"""Autopilot control plane: fleet telemetry closed-loop to actuation.

``Autopilot`` (autopilot.py) rides the FleetAggregator's once-per-
interval cadence and actuates — live shard split/merge, pipeline lane
re-placement, observer fan-out, orchestrated degradation — with every
decision an ordered transaction on the reserved ``CONTROL_LEDGER_ID``.
``tools/control_audit.py`` replays and lints that ledger.
"""
from .autopilot import (Autopilot, CONTROL_LEDGER_ID, ControlLedger,
                        ControlRecord, LADDER, REVERT_OF, make_autopilot)

__all__ = ["Autopilot", "ControlLedger", "ControlRecord",
           "CONTROL_LEDGER_ID", "LADDER", "REVERT_OF", "make_autopilot"]
