"""The port's tracing plane (plenum_tpu_torch/common/tracing.py), held to
the cases of the reference's tests/test_tracing.py that touch no module
the port lacks (the sim-pool waterfalls wait for the pool, ROADMAP A5),
and to the reference's tracer itself on the same seeded event stream."""
from __future__ import annotations

import json
import random
import time

import pytest

from plenum_tpu.common import tracing as ref_tracing
from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import (SAMPLE_CAP, Accumulator,
                                             percentile)
from plenum_tpu_torch.common.tracing import NULL_TRACER, Tracer, span_sequence


def test_percentile_nearest_rank_pins():
    assert percentile([1, 2, 3, 4], 0.5) == 2
    assert percentile([1, 2, 3, 4], 0.25) == 1
    assert percentile([1, 2, 3, 4], 0.75) == 3
    assert percentile([1, 2, 3, 4], 1.0) == 4
    assert percentile([1, 2, 3, 4], 0.0) == 1
    assert percentile([7], 0.95) == 7
    assert percentile(list(range(1, 101)), 0.5) == 50
    assert percentile(list(range(1, 101)), 0.95) == 95
    assert percentile(list(range(1, 101)), 1.0) == 100
    assert percentile([3, 1, 2], 0.5) == 2          # unsorted input
    assert percentile([], 0.5) is None


def test_accumulator_reservoir_is_deterministic_and_unbiased():
    stream = [float(v) for v in range(SAMPLE_CAP * 4)]
    a1 = Accumulator(keep_samples=True, seed=7)
    a2 = Accumulator(keep_samples=True, seed=7)
    for v in stream:
        a1.add(v)
        a2.add(v)
    assert a1.samples == a2.samples
    assert len(a1.samples) == SAMPLE_CAP
    tail = sum(1 for v in a1.samples if v >= SAMPLE_CAP)
    assert tail > SAMPLE_CAP // 2, tail
    a3 = Accumulator(keep_samples=True, seed=8)
    for v in stream:
        a3.add(v)
    assert a3.samples != a1.samples                 # seeds decorrelate
    assert a1.count == len(stream) and a1.max == stream[-1]


def test_null_tracer_disabled_cost_microbench():
    """Tracing disabled costs one attribute check per guarded site: under
    2% of a 1 ms/txn budget at ~12 sites per ordered txn."""
    tracer = NULL_TRACER
    assert tracer.enabled is False
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        if tracer.enabled:
            tracer.emit("stage", "key", None)
    per_site = (time.perf_counter() - t0) / n
    sites_per_txn = 12
    budget = 0.02 * 0.001       # 2% of 1 ms
    assert per_site * sites_per_txn < budget, \
        f"{per_site * 1e9:.0f} ns/site x {sites_per_txn} sites " \
        f"exceeds {budget * 1e6:.0f} us/txn"


def test_flight_recorder_ring_bounds_and_auto_dump(tmp_path):
    clock = {"t": 0.0}
    tr = Tracer("N1", lambda: clock["t"], ring_size=8,
                dump_dir=str(tmp_path), min_dump_interval=5.0)
    for i in range(20):
        tr.emit("stage", f"k{i}")
    assert len(tr.ring) == 8                        # bounded
    tr.anomaly("suspicion", {"code": 1})            # auto-dump fires
    tr.anomaly("suspicion", {"code": 2})            # debounced away
    dumps = sorted(tmp_path.glob("N1-flight-*.json"))
    assert len(dumps) == 1
    clock["t"] = 10.0
    tr.anomaly("suspicion", {"code": 3})            # past the debounce
    assert len(sorted(tmp_path.glob("N1-flight-*.json"))) == 2
    snap = json.loads(dumps[0].read_text())
    assert snap["node"] == "N1"
    assert len(snap["events"]) == 8
    assert snap["events"][-1][1] == "anomaly.suspicion"
    assert snap["anomalies"] == 1                   # at dump time


def test_breaker_transitions_reach_flight_recorder():
    from plenum_tpu_torch.parallel.supervisor import CircuitBreaker
    tr = Tracer("N", lambda: 0.0)
    br = CircuitBreaker(fail_threshold=2, cooldown=1.0, now=lambda: 0.0)
    br.on_transition = lambda old, new: tr.anomaly(
        "breaker", {"from": old, "to": new})
    br.record_failure()
    br.record_failure()                             # -> open
    br.to_half_open()
    br.close()
    hops = [(e[3]["from"], e[3]["to"]) for e in tr.ring
            if e[1] == "anomaly.breaker"]
    assert hops == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


def test_span_sequence_canonical():
    tr = Tracer("N", lambda: 1.5)
    tr.emit("ingress", "d1", {"frm": "cli"})
    a = span_sequence(tr.snapshot())
    b = span_sequence(tr.snapshot())
    assert a == b and b"ingress" in a
    assert span_sequence(None) == b""


@pytest.mark.parametrize("seed", [1, 2])
def test_tracer_matches_reference_on_one_event_stream(seed, tmp_path):
    """One seeded stream of spans, anomalies and clock steps through both
    packages' tracers: the same snapshots, canonical span bytes and
    dumped files; the stage names are the reference's."""
    rng = random.Random(seed)
    clocks = [{"t": 0.0}, {"t": 0.0}]
    made = []
    for mod, clock, sub in ((ref_tracing, clocks[0], "ref"),
                            (tracing, clocks[1], "port")):
        made.append(mod.make_tracer("N", lambda c=clock: c["t"],
                                    dump_dir=str(tmp_path / sub)))
    stages = [tracing.INGRESS, tracing.AUTH, tracing.DEVICE,
              tracing.DEVICE_CONTROLLER, tracing.ORDERED]
    for _ in range(300):
        step = rng.random() * 2
        stage = rng.choice(stages)
        key = "k%d" % rng.randrange(50)
        data = {"n": rng.randrange(1000)} if rng.random() < 0.5 else None
        anomaly = rng.random() < 0.05
        for tr, clock in zip(made, clocks):
            clock["t"] += step
            if anomaly:
                tr.anomaly("breaker", data)
            else:
                tr.emit(stage, key, data)
    ref_tr, port_tr = made
    assert port_tr.snapshot() == ref_tr.snapshot()
    assert span_sequence(port_tr.snapshot()) == \
        ref_tracing.span_sequence(ref_tr.snapshot())
    assert port_tr.dumps_written == ref_tr.dumps_written > 0
    for i in range(port_tr.dumps_written):
        name = f"N-flight-{i}.json"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    names = {k: v for k, v in vars(tracing).items()
             if k.isupper() and isinstance(v, (str, int))}
    assert names == {k: v for k, v in vars(ref_tracing).items()
                     if k.isupper() and isinstance(v, (str, int))}
