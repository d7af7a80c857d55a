"""The port's host-span recorder (plenum_tpu_torch/common/host_spans.py):
self time by layer on a fake clock, the on/off rule under a CPU torch
profiler session, the co-hosted pool's spans, the benchmark's readers of
them, and the cost of the sites while the recorder is off."""
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plenum_tpu_torch.common import host_spans as hs
from plenum_tpu_torch.common.host_spans import (AUTH, BLS, DURABLE,
                                                EXECUTION, LAYERS, LOOP, NODE,
                                                RING, SERDE, THREEPC,
                                                HostSpans)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _recorder(capacity=1000, recording=lambda: False):
    clock = FakeClock()
    return HostSpans(capacity=capacity, clock=clock,
                     recording=recording), clock


def _span(rec, clock, layer, work, node=hs.INHERIT, inside=()):
    """A span of `work` seconds of its own, children run inside it."""
    s = rec.begin(layer, node)
    clock.advance(work)
    for child in inside:
        child()
    rec.end(s)


def test_self_time_is_the_span_less_its_children():
    rec, clock = _recorder()
    rec.enable()
    n1 = rec.node_id("Node1")
    _span(rec, clock, LOOP, 0.001, n1, inside=[
        lambda: _span(rec, clock, NODE, 0.002, inside=[
            lambda: _span(rec, clock, SERDE, 0.0005),
            lambda: _span(rec, clock, AUTH, 0.003, inside=[
                lambda: _span(rec, clock, SERDE, 0.0001)])]),
        lambda: _span(rec, clock, DURABLE, 0.004, inside=[
            lambda: _span(rec, clock, NODE, 0.0002)]),
        lambda: _span(rec, clock, RING, 0.0007, hs.NONE)])
    _span(rec, clock, RING, 0.0011, hs.NONE)       # a top-level ring span
    s = rec.session()
    assert s["self_s"]["loop"] == pytest.approx(0.001)
    assert s["self_s"]["node"] == pytest.approx(0.0022)
    assert s["self_s"]["serde"] == pytest.approx(0.0006)
    assert s["self_s"]["auth"] == pytest.approx(0.003)
    assert s["self_s"]["durable"] == pytest.approx(0.004)
    assert s["self_s"]["ring"] == pytest.approx(0.0018)
    assert s["spans"] == {"loop": 1, "node": 2, "threepc": 0, "bls": 0,
                          "execution": 0, "durable": 1, "auth": 1,
                          "serde": 2, "ring": 2, "transport": 0, "svc": 0}
    assert s["top_spans"] == 2
    assert s["top_s"] == pytest.approx(0.0115 + 0.0011)
    # every self second belongs to exactly one layer
    assert sum(s["self_s"].values()) == pytest.approx(s["top_s"], rel=1e-12)
    # raw rows: opening order, parent rows, the node inherited
    rows = rec.spans()
    assert [(r[2], r[3], r[4]) for r in rows] == [
        ("loop", "Node1", -1), ("node", "Node1", 0), ("serde", "Node1", 1),
        ("auth", "Node1", 1), ("serde", "Node1", 3), ("durable", "Node1", 0),
        ("node", "Node1", 5), ("ring", None, 0), ("ring", None, -1)]
    assert rows[0][5] == 100.0
    assert rows[0][6] - rows[0][5] == pytest.approx(0.0115)


def test_the_nine_layers_close_over_deep_random_nesting():
    import random
    rng = random.Random(7)
    rec, clock = _recorder()
    rec.enable()

    def tree(depth):
        s = rec.begin(rng.randrange(len(LAYERS)))
        for _ in range(rng.randrange(3) if depth < 6 else 0):
            clock.advance(rng.random() * 1e-3)
            tree(depth + 1)
        clock.advance(rng.random() * 1e-3)
        rec.end(s)
    for _ in range(50):
        tree(0)
    s = rec.session()
    assert sum(s["self_s"].values()) == pytest.approx(s["top_s"], rel=1e-9)
    assert all(v >= 0 for v in s["self_s"].values())
    assert sum(s["spans"].values()) == s["recorded"]


def test_each_thread_keeps_its_own_stack():
    rec = HostSpans(capacity=1000)
    rec.enable()
    barrier = threading.Barrier(2)

    def worker():
        s = rec.begin(RING, hs.NONE)
        barrier.wait(timeout=10)    # both threads hold an open span
        inner = rec.begin(AUTH)
        rec.end(inner)
        barrier.wait(timeout=10)
        rec.end(s)

    main = rec.begin(LOOP, rec.node_id("Node1"))
    t = threading.Thread(target=worker)
    t.start()
    barrier.wait(timeout=10)
    child = rec.begin(SERDE)
    rec.end(child)
    barrier.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    rec.end(main)
    s = rec.session()
    assert s["threads"] == 2 and s["top_spans"] == 2
    rows = rec.spans()
    by_layer = {r[2]: r for r in rows}
    assert by_layer["serde"][4] == 0 and by_layer["serde"][3] == "Node1"
    assert by_layer["auth"][4] == 0 and by_layer["auth"][3] is None
    assert by_layer["ring"][0] != by_layer["loop"][0]
    assert sum(s["self_s"].values()) == pytest.approx(s["top_s"])


def test_an_overflowing_buffer_counts_its_drops_and_keeps_the_totals():
    full, clock_a = _recorder(capacity=10_000)
    small, clock_b = _recorder(capacity=5)
    for rec, clock in ((full, clock_a), (small, clock_b)):
        rec.enable()
        for i in range(8):
            _span(rec, clock, LOOP, 0.001, inside=[
                lambda: _span(rec, clock, EXECUTION, 0.002),
                lambda: _span(rec, clock, BLS, 0.0005)])
    a, b = full.session(), small.session()
    assert a["recorded"] == 24 and a["dropped"] == 0
    assert b["recorded"] == 5 and b["dropped"] == 19
    assert a["self_s"] == b["self_s"] and a["spans"] == b["spans"]
    assert a["top_s"] == b["top_s"]
    assert len(small.spans()) == 5


def test_a_session_is_on_only_while_the_profiler_records():
    assert hs.profiler_recording() is False
    rec = HostSpans(capacity=1000)
    assert rec.poll() is False and rec.session() is None
    with profile(activities=[ProfilerActivity.CPU]):
        # torch's own flag: a torch upgrade that moves it fails here
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert hs.profiler_recording() is True
        assert rec.poll() is True and rec.on
        s = rec.begin(LOOP)
        rec.end(s)
    assert hs.profiler_recording() is False
    assert rec.on                       # until the next top-level poll
    assert rec.poll() is False and not rec.on
    first = rec.session()
    assert first["spans"]["loop"] == 1 and first["open"] is False
    assert rec.session() == first       # the last session stays readable
    with profile(activities=[ProfilerActivity.CPU]):
        assert rec.poll() is True       # a new session: totals reset
        assert rec.session()["spans"]["loop"] == 0
        assert rec.session()["anchor"] > first["anchor"]
    rec.poll()
    assert not rec.on


def test_enable_and_disable_without_the_profiler():
    rec, clock = _recorder()
    assert rec.poll() is False
    rec.enable()
    assert rec.poll() is True and rec.on
    _span(rec, clock, THREEPC, 0.25)
    rec.disable()
    assert not rec.on and rec.poll() is False
    assert rec.session()["self_s"]["threepc"] == 0.25
    rec.enable()                        # a new session resets
    assert rec.session()["spans"]["threepc"] == 0
    rec.disable()


def test_wrappers_span_only_while_on_and_top_spans_poll():
    state = {"profiling": False}
    rec, clock = _recorder(recording=lambda: state["profiling"])
    calls = []

    def work(x):
        clock.advance(0.01)
        calls.append(x)
        return x * 2
    inner = rec.wrap(work, EXECUTION)
    ended = []
    top = rec.wrap_top(lambda x: inner(x) + 1, rec.node_id("Node2"),
                       on_end=ended.append)
    assert top(1) == 3 and rec.session() is None and not ended
    state["profiling"] = True
    assert top(2) == 5
    s = rec.session()
    assert s["spans"]["loop"] == 1 and s["spans"]["execution"] == 1
    assert s["self_s"]["execution"] == pytest.approx(0.01)
    assert ended == [pytest.approx(0.01)]
    assert [r[3] for r in rec.spans()] == ["Node2", "Node2"]
    state["profiling"] = False
    assert top(3) == 7                  # the poll closes the session
    assert rec.session()["spans"]["loop"] == 1 and calls == [1, 2, 3]
    delivered = []
    deliver = rec.wrap_delivery(lambda m, f, d: delivered.append((m, f, d)))
    rec.enable()
    deliver("msg", "Node1", "Node3")
    assert delivered == [("msg", "Node1", "Node3")]
    assert rec.spans()[-1][2:4] == ("node", "Node3")


def test_export_lays_the_spans_over_the_profilers_trace(tmp_path):
    rec = HostSpans(capacity=1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.poll()
        s = rec.begin(LOOP, rec.node_id("Node1"))
        c = rec.begin(SERDE)
        time.sleep(0.002)
        rec.end(c)
        rec.end(s)
    rec.poll()
    dev = tmp_path / "dev.json"
    prof.export_chrome_trace(str(dev))
    events = json.loads(dev.read_text())["traceEvents"]
    anchor = hs.anchor_us(events)
    assert rec.export_chrome_trace(str(tmp_path / "alone.json")) == 2
    alone = json.loads((tmp_path / "alone.json").read_text())["traceEvents"]
    assert [e["name"] for e in alone] == ["loop", "serde"]
    assert alone[0]["ts"] >= 0 and alone[1]["dur"] >= 2000
    out = tmp_path / "merged.json"
    assert rec.export_chrome_trace(str(out), profiler_trace=str(dev)) == 2
    merged = json.loads(out.read_text())["traceEvents"]
    assert len(merged) == len(events) + 2
    mine = [e for e in merged if e.get("cat") == "host_spans"]
    assert mine[0]["args"] == {"node": "Node1", "row": 0, "parent": -1}
    assert mine[1]["args"]["parent"] == 0
    for e, a in zip(mine, alone):
        assert e["ts"] == pytest.approx(anchor + a["ts"])
    # the spans start after the anchor, and lie inside the profiled range
    last = max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e)
    assert anchor <= mine[0]["ts"] <= last


# --- the co-hosted pool ------------------------------------------------


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signed_nyms(trustee, n):
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    out = []
    for i in range(n):
        user = Ed25519Signer(seed=(b"hs%d" % i).ljust(32, b"\0"))
        req = Request(trustee.identifier, i + 1,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        req.signature = trustee.sign_b58(req.signing_bytes())
        out.append(req)
    return out


@pytest.mark.usefixtures("one_torch_thread")
def test_a_profiled_pool_spans_every_layer_and_emits_prod_time():
    from plenum_tpu_torch.common.host_spans import RECORDER
    from plenum_tpu_torch.common.metrics import MetricsName
    from plenum_tpu_torch.tools.local_pool import build_pool
    (names, nodes, timer, trustee, replies, Reply, _domain, plane,
     _net) = build_pool(4, "torch",
                        config_overrides=dict(PIPELINE_MIN_BUCKET=8))
    reqs = _signed_nyms(trustee, 6)

    def prod_all():
        timer.service()
        for node in nodes.values():
            node.prod()
        plane.flush()

    def order(batch):
        for req in batch:
            for name in names:
                nodes[name].handle_client_message(req.to_dict(), "client")
        want = sum(isinstance(m, Reply) for _, m, _ in replies[names[0]]) \
            + len(batch)
        deadline = time.perf_counter() + 240
        while time.perf_counter() < deadline:
            prod_all()
            if sum(isinstance(m, Reply)
                   for _, m, _ in replies[names[0]]) >= want:
                return True
        return False

    assert order(reqs[:1])                  # untraced: nothing recorded
    prod_time = nodes[names[0]].metrics.accumulators.get(
        MetricsName.PROD_TIME)
    assert prod_time is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert order(reqs[1:4])
        assert order(reqs[4:6])
    prod_all()                              # the first poll after: closed
    s = RECORDER.session()
    assert not s["open"] and s["dropped"] == 0
    for layer in LAYERS:
        # a co-hosted pool has no TCP stacks and no crypto host
        if layer in hs.PROCESS_LAYERS:
            assert s["self_s"][layer] == 0, layer
        else:
            assert s["self_s"][layer] > 0, layer
    assert sum(s["self_s"].values()) == pytest.approx(s["top_s"], rel=1e-9)
    assert s["spans"]["execution"] >= 8     # >= 2 batches on 4 nodes
    assert s["waves"] >= 1 and s["wave_wait_s"] >= 0
    nodes_seen = {r[3] for r in RECORDER.spans()}
    assert set(names) <= nodes_seen and None in nodes_seen
    prod_time = nodes[names[0]].metrics.accumulators[MetricsName.PROD_TIME]
    assert prod_time.count == sum(
        1 for r in RECORDER.spans() if r[2] == "loop" and r[3] == names[0])
    assert prod_time.total > 0


# --- the benchmark's readers --------------------------------------------


def _reader(name):
    from port_bench import spec
    return spec.reader(name)


READERS = {"node_ms.pool": "node", "threepc_ms.pool": "threepc",
           "bls_ms.pool": "bls", "execution_ms.pool": "execution",
           "durable_ms.pool": "durable", "auth_ms.pool": "auth",
           "serde_ms.pool": "serde", "ring_ms.pool": "ring"}


@pytest.mark.parametrize("name", sorted(READERS) + ["ring_wait_ms.pool"])
def test_each_reader_on_a_synthetic_run(name, monkeypatch):
    rec, clock = _recorder()
    monkeypatch.setattr(hs, "RECORDER", rec)
    run = {"collected": {"ordered_batches": 4}}
    read = _reader(name)
    assert read(run) is None                # no session
    rec.enable()
    for i, layer in enumerate(LAYERS):
        _span(rec, clock, i, 0.001 * (i + 1))
    rec.note_wave(0.004)
    rec.note_wave(0.006)
    rec.disable()
    if name == "ring_wait_ms.pool":
        assert read(run) == pytest.approx(5.0)
        rec.enable()
        assert read(run) is None            # a session with no wave
    else:
        layer = READERS[name]
        want = 0.001 * (LAYERS.index(layer) + 1) / 4 * 1e3
        assert read(run) == pytest.approx(want)
        assert read({"collected": {"ordered_batches": 0}}) is None


def test_the_readers_read_none_without_the_recorder(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "plenum_tpu_torch.common.host_spans",
                        None)
    run = {"collected": {"ordered_batches": 4}}
    for name in sorted(READERS) + ["ring_wait_ms.pool"]:
        assert _reader(name)(run) is None


# --- the cost while off ---------------------------------------------------


def test_the_off_path_costs_under_two_percent_of_a_ms_per_txn():
    """Off, a serializer costs one attribute check, a wrapped function
    one call and one check, and a top-level span one profiler check. An
    H100's traced 51 s window of the co-hosted pool opened, per ordered
    txn, ~34 serde spans, ~15 other spans and ~0.2 top-level ones (1.07 M
    spans over 22,059 txns); the test charges 40, 25 and 6 of each, and
    holds them under 2 % of a 1 ms/txn budget."""
    rec = HostSpans()
    assert not rec.on
    n = 100_000

    def per_call(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    def bare():
        return None

    def direct():
        if rec.on:
            raise AssertionError
        return None
    wrapped = rec.wrap(bare, NODE)
    top = rec.wrap_top(bare)
    base = per_call(bare)
    cost_direct = max(0.0, per_call(direct) - base)
    cost_wrapped = max(0.0, per_call(wrapped) - base)
    cost_top = max(0.0, per_call(top) - base)
    per_txn = 40 * cost_direct + 25 * cost_wrapped + 6 * cost_top
    budget = 0.02 * 0.001
    assert per_txn < budget, (
        f"{cost_direct * 1e9:.0f} / {cost_wrapped * 1e9:.0f} / "
        f"{cost_top * 1e9:.0f} ns a site: {per_txn * 1e6:.2f} us/txn")
