"""Host self time by layer, on the profiler's clock.

The wall-clock half of the tracing plane. `common/tracing.Tracer` keeps
the replay-deterministic point events of requests and batches on the
node's timer; this module keeps how long each layer of the host held a
thread, and writes nothing the Tracer writes.

A span has a layer (one of LAYERS), a start and an end on
`time.perf_counter`, its parent span and the node it ran for (None for
shared work such as the ring). A layer's self time is its spans' time
less the part their child spans cover, so every second of a top-level
span belongs to exactly one layer, and the layers' self times add up to
the top-level spans' time.

On and off. The recorder is on while a torch profiler session records,
and between `enable()` and `disable()`. The top-level spans of a pool
(layer `loop`: each `Node.prod` and the timer's `service`, installed by
`instrument_pool`) look at the profiler once a call and open or close a
session; every other site checks `RECORDER.on` and nothing else. A
session opens with one `torch.profiler.record_function` range, ANCHOR,
around a `perf_counter` stamp, so that `export_chrome_trace` can lay the
spans over the profiler's own trace. A new session resets the totals and
the buffer; the last session's figures stay readable after it ends, and
a profiler session ends for the recorder at the first top-level span
after the profiler stopped. A validator in its own process
(`tools/start_node`) serves sessions on signals instead
(`serve_sessions`), and the crypto service's own spans (layer `svc`) record
between `enable()` and `disable()` in its process.

Totals (self seconds and span count by layer, the ring's wave counter)
are kept for every span while the recorder is on. Raw spans go to a
columnar buffer of `capacity` rows per thread; spans past it are counted
in `dropped` and never change the totals.

    from plenum_tpu_torch.common.host_spans import RECORDER
    RECORDER.enable()             # or run under torch.profiler.profile()
    ...                           # the pool's prod loop
    RECORDER.disable()
    RECORDER.session()            # self seconds by layer, counts, waves
    RECORDER.export_chrome_trace("host.json", profiler_trace="dev.json")
"""
from __future__ import annotations

import functools
import json
import os
import signal
import sys
import threading
import time
from array import array
from typing import Callable, Optional

LAYERS = ("loop", "node", "threepc", "bls", "execution", "durable", "auth",
          "serde", "ring", "transport", "svc")
(LOOP, NODE, THREEPC, BLS, EXECUTION, DURABLE, AUTH, SERDE, RING, TRANSPORT,
 SVC) = range(len(LAYERS))
# the layers only a node or crypto host in its own process runs: no
# co-hosted pool (instrument_pool) opens them
PROCESS_LAYERS = ("transport", "svc")

# a span's node: NONE for shared work, INHERIT for its parent's
NONE, INHERIT = -1, -2

# the record_function range a session opens with
ANCHOR = "host_spans.anchor"

# rows of raw spans kept per thread and session (23 bytes a row): the
# co-hosted 4-node pool opened 21-25 k spans a second on an H100's host
# while the profiler recorded, 1.07-1.30 M in a 51 s window
DEFAULT_CAPACITY = 1 << 22

# the BlsBftReplica methods the ordering service calls (layer bls)
BLS_METHODS = ("update_pre_prepare", "validate_pre_prepare", "update_commit",
               "validate_commit", "process_commit", "process_order")


def profiler_recording() -> bool:
    """True while a torch profiler session records in this process. Reads
    torch's own flag and imports nothing: without torch loaded, nothing
    can be profiling."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod is not None and mod._is_profiler_enabled


class _Thread:
    """One thread's stack, totals and raw spans in one session."""

    __slots__ = ("tid", "stack", "self_s", "count", "top_s", "top_n",
                 "waves", "wave_s", "dropped", "layer", "node", "parent",
                 "start", "end")

    def __init__(self, tid: int):
        self.tid = tid
        # open spans: [thread, row, layer, node, t0, child seconds]
        self.stack: list = []
        self.self_s = [0.0] * len(LAYERS)
        self.count = [0] * len(LAYERS)
        self.top_s = 0.0
        self.top_n = 0
        self.waves = 0
        self.wave_s = 0.0
        self.dropped = 0
        self.layer = array("B")
        self.node = array("h")
        self.parent = array("i")        # row of the parent, -1 top-level
        self.start = array("d")
        self.end = array("d")


class _Block:
    """A span over a `with` block (HostSpans.span)."""

    __slots__ = ("rec", "layer", "node", "entry")

    def __init__(self, rec, layer: int, node: int):
        self.rec, self.layer, self.node = rec, layer, node

    def __enter__(self):
        self.entry = self.rec.begin(self.layer, self.node)

    def __exit__(self, *exc):
        self.rec.end(self.entry)


class _NoBlock:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        pass


_NO_SPAN = _NoBlock()


class HostSpans:
    """The recorder. One per process (RECORDER), as the profiler is; the
    tests make their own with a fake clock."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.perf_counter,
                 recording: Callable[[], bool] = profiler_recording):
        self.on = False
        self.capacity = capacity
        self._clock = clock
        self._recording = recording
        self._explicit = False          # enable() opened the session
        self._profiled = False          # a profiler session opened it
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads: list[_Thread] = []
        self._nodes: dict[str, int] = {}
        self._node_names: list[str] = []
        self.anchor: Optional[float] = None       # the session's stamp

    # --- sessions ---------------------------------------------------------

    def enable(self) -> None:
        """Open a session that lasts until disable(), profiler or not."""
        self._open()
        self._explicit = True

    def disable(self) -> None:
        self._explicit = False
        self._profiled = False
        self._close()

    def poll(self) -> bool:
        """The top-level spans' check: open a session when a profiler
        session has started, close it once the profiler has stopped.
        -> whether the recorder is on."""
        if self._explicit:
            return True
        recording = self._recording()
        if recording != self._profiled:
            self._profiled = recording
            if recording:
                self._open()
            else:
                self._close()
        return self.on

    def _open(self) -> None:
        self._local = threading.local()
        with self._lock:
            self._threads = []
        self.anchor = self._stamp_anchor()
        self.on = True

    def _close(self) -> None:
        self.on = False

    def _stamp_anchor(self) -> float:
        torch = sys.modules.get("torch")
        if torch is None:
            return self._clock()
        with torch.profiler.record_function(ANCHOR):
            return self._clock()

    def _thread(self) -> _Thread:
        st = getattr(self._local, "st", None)
        if st is None:
            st = self._local.st = _Thread(threading.get_ident())
            with self._lock:
                self._threads.append(st)
        return st

    def node_id(self, name: Optional[str]) -> int:
        """The small integer a span stores for a node's name."""
        if name is None:
            return NONE
        got = self._nodes.get(name)
        if got is None:
            got = self._nodes[name] = len(self._node_names)
            self._node_names.append(name)
        return got

    # --- spans ------------------------------------------------------------

    def begin(self, layer: int, node: int = INHERIT) -> list:
        """Open a span on this thread; the caller checked `on` and closes
        it with end() in a `finally`."""
        st = getattr(self._local, "st", None) or self._thread()
        stack = st.stack
        if stack:
            parent = stack[-1]
            prow = parent[1]
            if node == INHERIT:
                node = parent[3]
        else:
            prow = -1
            if node == INHERIT:
                node = NONE
        row = len(st.start)
        if row < self.capacity:
            st.layer.append(layer)
            st.node.append(node)
            st.parent.append(prow)
            st.end.append(0.0)
        else:
            row = -1
            st.dropped += 1
        entry = [st, row, layer, node, 0.0, 0.0]
        stack.append(entry)
        entry[4] = t0 = self._clock()
        if row >= 0:
            st.start.append(t0)
        return entry

    def end(self, entry: list) -> float:
        """Close the span begin() returned -> its duration (seconds)."""
        t1 = self._clock()
        st, row, layer = entry[0], entry[1], entry[2]
        stack = st.stack
        stack.pop()
        dur = t1 - entry[4]
        st.self_s[layer] += dur - entry[5]
        st.count[layer] += 1
        if stack:
            stack[-1][5] += dur
        else:
            st.top_s += dur
            st.top_n += 1
        if row >= 0:
            st.end[row] = t1
        return dur

    def note_wave(self, wait_s: float) -> None:
        """One ring wave resolved, wait_s after its first item staged."""
        st = getattr(self._local, "st", None) or self._thread()
        st.waves += 1
        st.wave_s += wait_s

    # --- wrappers --------------------------------------------------------

    def spanning(self, layer: int, node: int = INHERIT) -> Callable:
        """Decorator: the function is a host span of `layer`."""
        return lambda fn: self.wrap(fn, layer, node)

    def wrap(self, fn: Callable, layer: int, node: int = INHERIT) -> Callable:
        """fn as a host span of `layer` while the recorder is on; off, one
        call and one attribute check."""
        rec = self

        def spanned(*a, **kw):
            if not rec.on:
                return fn(*a, **kw)
            s = rec.begin(layer, node)
            try:
                return fn(*a, **kw)
            finally:
                rec.end(s)
        return functools.update_wrapper(spanned, fn)

    def wrap_top(self, fn: Callable, node: int = NONE,
                 on_end: Optional[Callable[[float], None]] = None) -> Callable:
        """A top-level (`loop`) span: polls the profiler once a call.
        on_end(seconds) runs after each recorded span."""
        rec = self

        def spanned(*a, **kw):
            if not rec.poll():
                return fn(*a, **kw)
            s = rec.begin(LOOP, node)
            try:
                return fn(*a, **kw)
            finally:
                dur = rec.end(s)
                if on_end is not None:
                    on_end(dur)
        return functools.update_wrapper(spanned, fn)

    def span(self, layer: int, node: int = INHERIT):
        """`with rec.span(layer):` a span of the block while the recorder
        is on; off, a shared object whose enter and exit do nothing."""
        if not self.on:
            return _NO_SPAN
        return _Block(self, layer, node)

    def wrap_delivery(self, fn: Callable) -> Callable:
        """A `node` span for fn(msg, frm, dst), run for the node dst."""
        rec = self

        def spanned(msg, frm, dst):
            if not rec.on:
                return fn(msg, frm, dst)
            s = rec.begin(NODE, rec.node_id(dst))
            try:
                return fn(msg, frm, dst)
            finally:
                rec.end(s)
        return functools.update_wrapper(spanned, fn)

    # --- reading ----------------------------------------------------------

    def session(self) -> Optional[dict]:
        """The current or last session's figures; None before the first.
        self_s/spans by layer name, top-level seconds and count, raw spans
        recorded and dropped, and the ring's resolved waves with their
        summed wait (seconds)."""
        if self.anchor is None:
            return None
        threads = list(self._threads)
        out = {"open": self.on, "anchor": self.anchor,
               "threads": len(threads),
               "self_s": {n: 0.0 for n in LAYERS},
               "spans": {n: 0 for n in LAYERS},
               "top_s": 0.0, "top_spans": 0, "recorded": 0, "dropped": 0,
               "waves": 0, "wave_wait_s": 0.0}
        for st in threads:
            for i, name in enumerate(LAYERS):
                out["self_s"][name] += st.self_s[i]
                out["spans"][name] += st.count[i]
            out["top_s"] += st.top_s
            out["top_spans"] += st.top_n
            out["recorded"] += len(st.start)
            out["dropped"] += st.dropped
            out["waves"] += st.waves
            out["wave_wait_s"] += st.wave_s
        return out

    def spans(self) -> list[tuple]:
        """Raw spans of the session: (thread, row, layer, node, parent
        row, start, end), each thread's in the order they opened; a span
        still open has end 0.0."""
        out = []
        for st in list(self._threads):
            n = len(st.start)
            for i in range(n):
                node = st.node[i]
                out.append((st.tid, i, LAYERS[st.layer[i]],
                            None if node < 0 else self._node_names[node],
                            st.parent[i], st.start[i], st.end[i]))
        return out

    def export_chrome_trace(self, path: str,
                            profiler_trace: Optional[str] = None) -> int:
        """Write the session's raw spans as Chrome trace `ph: "X"` events
        -> how many. With profiler_trace (a file torch.profiler's
        export_chrome_trace wrote in the same session) the output holds
        that trace's events too, and the spans sit on its clock through
        the ANCHOR range; without it, times count from the anchor."""
        events, base = [], 0.0
        if profiler_trace is not None:
            with open(profiler_trace) as fh:
                trace = json.load(fh)
            events = trace["traceEvents"] if isinstance(trace, dict) \
                else trace
            base = anchor_us(events)
        n = 0
        for tid, row, layer, node, parent, t0, t1 in self.spans():
            if t1 <= 0.0:
                continue
            events.append({
                "name": layer, "ph": "X", "cat": "host_spans",
                "pid": "host spans", "tid": tid,
                "ts": base + (t0 - self.anchor) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "args": {"node": node, "row": row, "parent": parent}})
            n += 1
        with open(path, "w") as fh:
            json.dump({"traceEvents": events}, fh)
        return n


def anchor_us(events: list) -> float:
    """The time of a session's anchor stamp on a profiler trace's clock:
    the middle of the ANCHOR range (the stamp lies inside it)."""
    for ev in events:
        if ev.get("name") == ANCHOR and ev.get("ph") == "X":
            return ev["ts"] + ev.get("dur", 0.0) / 2
    raise ValueError(f"the profiler trace holds no {ANCHOR} range")


def _consensus_handler(handler) -> bool:
    """A bus handler whose work is 3PC: a method of a consensus service
    or of a stashing router (only the consensus services keep one)."""
    from plenum_tpu_torch.common.stashing import StashingRouter
    owner = getattr(handler, "__self__", None)
    return owner is not None and (
        type(owner).__module__.startswith("plenum_tpu_torch.consensus.")
        or isinstance(owner, StashingRouter))


def _span_bus(rec: HostSpans, bus) -> None:
    """The bus's consensus handlers run as `threepc` spans."""
    orig = bus.handlers_for
    if getattr(orig, "__wrapped__", None) is not None:
        return
    wrapped: dict[int, tuple] = {}          # id(handler) -> (it, spanned)

    def handlers_for(message):
        hs = orig(message)
        if not rec.on:
            return hs
        out = []
        for h in hs:
            got = wrapped.get(id(h))
            if got is None or got[0] is not h:
                got = wrapped[id(h)] = (h, rec.wrap(h, THREEPC)
                                        if _consensus_handler(h) else h)
            out.append(got[1])
        return out
    handlers_for.__wrapped__ = orig
    bus.handlers_for = handlers_for


def _span_replica(rec: HostSpans, replica):
    replica.ordering._timed_apply = rec.wrap(replica.ordering._timed_apply,
                                             EXECUTION)
    if replica.bls is not None:
        for name in BLS_METHODS:
            setattr(replica.bls, name, rec.wrap(getattr(replica.bls, name),
                                                BLS))
    _span_bus(rec, replica.internal_bus)
    return replica


def instrument_pool(nodes: dict, timer, net,
                    rec: Optional[HostSpans] = None) -> None:
    """Spans for a co-hosted pool (names -> Nodes on one timer and one
    SimNetwork), by wrapping the boundary methods of each instance:

    loop       the timer's service(); each Node.prod, which also emits
               PROD_TIME into the node's metrics while the recorder is on
    node       client intake (_service_client_msgs), propagates
               (_service_propagates), the propagator's flush_outbox,
               _reply_batch, and the network's delivery into a peer
    threepc    Replicas.service_all and every bus handler of a consensus
               service (ordering, checkpoint, view change)
    bls        BlsBftReplica's BLS_METHODS
    execution  OrderingService._timed_apply (every uncommitted apply of
               a batch: minted, pre-prepared by a peer, or re-applied)
    durable    Node._service_ordered (the group commit)

    Replicas made later (a view change) get theirs as they are made."""
    from plenum_tpu_torch.common.metrics import MetricsName
    rec = RECORDER if rec is None else rec
    timer.service = rec.wrap_top(timer.service)
    net._deliver = rec.wrap_delivery(net._deliver)
    net._deliver_wire = rec.wrap_delivery(net._deliver_wire)
    for name, node in nodes.items():
        node.prod = rec.wrap_top(
            node.prod, rec.node_id(name),
            lambda s, n=node: n.metrics.add_event(MetricsName.PROD_TIME, s))
        _span_node(rec, node)


def _span_node(rec: HostSpans, node) -> None:
    """A Node's spans below its prod (instrument_pool's list)."""
    for attr in ("_service_client_msgs", "_service_propagates",
                 "_reply_batch"):
        setattr(node, attr, rec.wrap(getattr(node, attr), NODE))
    node.propagator.flush_outbox = rec.wrap(node.propagator.flush_outbox,
                                            NODE)
    node._service_ordered = rec.wrap(node._service_ordered, DURABLE)
    node.replicas.service_all = rec.wrap(node.replicas.service_all, THREEPC)
    _span_bus(rec, node.node_bus)
    for replica in node.replicas:
        _span_replica(rec, replica)
    make = node.replicas._make
    node.replicas._make = lambda inst_id, make=make: _span_replica(
        rec, make(inst_id))


def _span_transport(rec: HostSpans, node_stack, client_stack,
                    node: int) -> None:
    """The `transport` layer of a node's TCP stacks (network/tcp_stack.py,
    network/sealed_client.py): the node stack's send handler (each message
    packed once and queued per peer), its flush (each peer's queue packed
    into one frame, sealed with ChaCha20-Poly1305 and written), the opening
    of every received frame, the client stack's frame writes (sealed on a
    sealed connection) and the opening of each sealed client frame. The
    packing inside is `serde`."""
    bus = node_stack.bus
    bus._send_handler = rec.wrap(bus._send_handler, TRANSPORT, node)
    node_stack._flush = rec.wrap(node_stack._flush, TRANSPORT, node)
    install = node_stack._install_session

    def install_session(peer, sess, reader):
        sess.decrypt = rec.wrap(sess.decrypt, TRANSPORT, node)
        return install(peer, sess, reader)
    node_stack._install_session = install_session
    client_stack._send_packed = rec.wrap(client_stack._send_packed,
                                         TRANSPORT, node)
    if hasattr(client_stack, "_open"):
        client_stack._open = rec.wrap(client_stack._open, TRANSPORT, node)


def instrument_node_process(prodable, rec: Optional[HostSpans] = None):
    """Spans for a validator in its own process (tools/start_node.py): a
    Prodable holding one Node, its TcpStack and its ClientStack.

    loop       the Prodable's prod (timer, both stacks' drains, Node.prod)
    node       each stack's drain (delivery into the node) and the spans
               instrument_pool gives a Node below its prod
    transport  _span_transport's list
    the rest   as instrument_pool: threepc, bls, execution, durable

    -> the wrapped prod."""
    rec = RECORDER if rec is None else rec
    node = prodable.node
    nid = rec.node_id(node.name)
    prodable.prod = rec.wrap_top(prodable.prod, nid)
    for stack in (prodable.node_stack, prodable.client_stack):
        stack.drain = rec.wrap(stack.drain, NODE, nid)
    _span_node(rec, node)
    _span_transport(rec, prodable.node_stack, prodable.client_stack, nid)
    return prodable.prod


def serve_sessions(prodable, path: str, rec: Optional[HostSpans] = None,
                   signals=(signal.SIGUSR1, signal.SIGUSR2)):
    """Span sessions on request in a node process: instrument it, then
    open a session at the first prod after signals[0] and close it at the
    first prod after signals[1], writing the session's figures to `path`
    (JSON, replaced whole): session() plus the node's name, the 3PC
    batches it ordered in the session (its audit ledger's growth, one txn
    a batch), its domain ledger's growth and the session's length in
    seconds. Off, each prod pays one list check. signals=None installs no
    handler. -> request(open: bool), what a signal calls."""
    from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                       DOMAIN_LEDGER_ID)
    rec = RECORDER if rec is None else rec
    top = instrument_node_process(prodable, rec)
    node = prodable.node
    wanted: list = []
    start: dict = {}

    def sizes() -> tuple:
        db = node.c.db
        return (db.get_ledger(AUDIT_LEDGER_ID).size,
                db.get_ledger(DOMAIN_LEDGER_ID).size, time.perf_counter())

    def apply(open_: bool) -> None:
        if open_:
            rec.enable()
            start["at"] = sizes()
            return
        rec.disable()
        if "at" not in start:
            return
        (a0, d0, t0), (a1, d1, t1) = start.pop("at"), sizes()
        out = dict(rec.session(), node=node.name, batches=a1 - a0,
                   txns=d1 - d0, seconds=t1 - t0)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(out, fh)
        os.replace(tmp, path)

    def prod():
        if wanted:
            apply(wanted.pop(0))
        return top()
    prodable.prod = prod

    def request(open_: bool) -> None:
        wanted.append(open_)
    if signals is not None:
        signal.signal(signals[0], lambda s, f: request(True))
        signal.signal(signals[1], lambda s, f: request(False))
    return request


RECORDER = HostSpans()
