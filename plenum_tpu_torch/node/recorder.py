"""Recorder: capture a node's complete input stream for deterministic
single-node replay.

Reference behavior: plenum/recorder/recorder.py:13 — every incoming node
message and client request is appended to a KV store with a time offset;
a replayer later feeds the stream back into a freshly-bootstrapped node,
reproducing its exact state evolution (the debugging story for "what did
this node see before it broke").

Design: the recorder wraps the two ingress points (ExternalBus
process_incoming + Node.handle_client_message) rather than the socket layer,
so records are wire-decoded messages — replay does not need a network stack
at all, only a MockTimer. Connection events are recorded too (they drive
primary-health and view-change logic).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.message_base import MessageBase, message_from_dict
from plenum_tpu_torch.common.serialization import pack, unpack

INCOMING = "R"       # node protocol message
CLIENT = "C"         # client request dict
CONNECTED = "+"      # peer connection event
DISCONNECTED = "-"
TICK = "T"           # a prod cycle ran at this timer time
RUN_START = "B"      # a process (re)started recording

IDLE_HEARTBEAT = 1.0     # max silence between recorded ticks


class Recorder:
    """Appends timestamped ingress + prod-tick records to a KV store.

    Ticks matter for determinism: the primary's batch flush happens INSIDE
    prod (Replica.service), so pp_time — which enters the 3PC digest the
    peers' recorded COMMITs certify — is the timer time of the prod cycle
    that cut the batch. Replay must therefore re-run prods at the recorded
    cycle times, not at input-arrival times. Consecutive idle ticks at the
    same timestamp are deduplicated.
    """

    def __init__(self, store, now: Callable[[], float]):
        self._store = store
        self._now = now
        self._seq = store.size if hasattr(store, "size") else 0
        self._last_tick_ts: Optional[float] = None
        self._input_since_tick = True
        self._sends_since_tick = 0

    def record(self, kind: str, frm: str, data: Any) -> None:
        if kind != TICK:
            self._input_since_tick = True
        key = self._seq.to_bytes(8, "big")
        self._seq += 1
        self._store.put(key, pack([self._now(), kind, frm, data]))

    def note_send(self) -> None:
        self._sends_since_tick += 1

    def record_tick(self, work: int = 0) -> None:
        """Record a tick only when the cycle DID something (ingress, node
        work, or outbound sends — outbound catches time-driven actions like
        freshness batches) or at a coarse idle heartbeat. A real-time node
        prods ~500x/s; recording every idle cycle would write gigabytes a
        day for nothing and make replay re-run them all."""
        ts = self._now()
        busy = (self._input_since_tick or work > 0
                or self._sends_since_tick > 0)
        if not busy and self._last_tick_ts is not None and \
                ts - self._last_tick_ts < IDLE_HEARTBEAT:
            return
        if ts == self._last_tick_ts and not busy:
            return
        self._last_tick_ts = ts
        self._input_since_tick = False
        self._sends_since_tick = 0
        self.record(TICK, "", None)

    def iter_records(self):
        """-> (ts, kind, frm, data) in ingress order."""
        for key, value in self._store.iterator():
            ts, kind, frm, data = unpack(value)
            yield ts, kind, frm, data


def attach_recorder(node, recorder: Recorder) -> None:
    """Instrument a node's ingress + prod + egress seams. Must run before
    traffic. Appends a RUN_START boundary: replay stops at a second boundary
    (a restarted process starts a fresh perf_counter epoch, and one replayed
    node cannot cross it — replay the FIRST run; later runs start from the
    restart's durable state, not genesis)."""
    recorder.record(RUN_START, node.name, None)
    bus = node.node_bus
    orig_incoming = bus.process_incoming
    orig_client = node.handle_client_message
    orig_prod = node.prod
    orig_send = bus.send

    def counting_send(message, dst=None):
        recorder.note_send()
        orig_send(message, dst)

    bus.send = counting_send

    def recording_incoming(message, frm):
        if isinstance(message, ExternalBus.Connected):
            recorder.record(CONNECTED, frm, None)
        elif isinstance(message, ExternalBus.Disconnected):
            recorder.record(DISCONNECTED, frm, None)
        elif isinstance(message, MessageBase):
            recorder.record(INCOMING, frm, message.to_dict())
        orig_incoming(message, frm)

    def recording_client(msg, frm):
        recorder.record(CLIENT, frm, msg)
        orig_client(msg, frm)

    def recording_prod():
        work = orig_prod()
        # ts is the cycle's FROZEN clock value, unchanged since the cycle
        # began, so appending the tick after the fact keeps log order
        recorder.record_tick(work)
        return work

    bus.process_incoming = recording_incoming
    node.handle_client_message = recording_client
    node.prod = recording_prod


def replay(records, node, timer) -> int:
    """Feed a recorded stream into a fresh node under a MockTimer.

    The timer is advanced to each record's timestamp before delivery, and
    prod cycles re-run exactly at TICK records, so every time-driven
    behavior (batch cuts and their pp_time, view-change timeouts, freshness
    probes) fires in replay exactly where it fired live. Returns the number
    of records replayed. The node must be bootstrapped from the same genesis
    as the recorded run; its sends go wherever its bus points (typically a
    sink) — replay only reproduces STATE, not traffic.
    """
    n = 0
    runs_seen = 0
    connected: set[str] = set(node.node_bus.connecteds)
    for ts, kind, frm, data in records:
        if kind == RUN_START:
            runs_seen += 1
            if runs_seen > 1:
                break     # next process epoch: fresh clock, fresh node state
            continue
        # jump WITHOUT stepping through intermediate deadlines, then service
        # once: live QueueTimer fires due callbacks in a batch at the frozen
        # cycle time, never at their exact deadlines — replay must match
        timer.set_time_no_service(ts)
        timer.service()
        if kind == TICK:
            node.prod()
        elif kind == CONNECTED:
            connected.add(frm)
            node.node_bus.update_connecteds(connected)
        elif kind == DISCONNECTED:
            connected.discard(frm)
            node.node_bus.update_connecteds(connected)
        elif kind == INCOMING:
            node.node_bus.process_incoming(message_from_dict(data), frm)
        elif kind == CLIENT:
            node.handle_client_message(data, frm)
        n += 1
    # drain whatever the last inputs queued
    node.prod()
    return n
