"""The port's copy of the device-flap rungs of tests/test_sim_fuzz.py,
run on plenum_tpu_torch (the multidevice rung waits for the multi-device
ring, ROADMAP A7).

Seeded randomized fault scenarios over the deterministic SimNetwork: the
crypto device wedges, drops or corrupts mid-consensus (per node, through
the shared ring, or on the ring's commit-wave lane) and the pool must
keep ordering on the CPU fallback, re-admit the device after the heal,
and never fork (SAFETY: no two nodes commit different txns at the same
seq_no).

Every scenario is a pure function of its seed: SimNetwork randomness, fault
choice, fault timing and traffic all derive from SimRandom(seed), so any
failing seed replays exactly.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.network import SimRandom

from test_torch_pool import Pool, signed_nym

FAST = dict(Max3PCBatchWait=0.05,
            crypto_backend="cpu",
            PRIMARY_HEALTH_CHECK_FREQ=0.5,
            ORDERING_PROGRESS_TIMEOUT=2.0,
            STATE_FRESHNESS_UPDATE_INTERVAL=3.0,
            VIEW_CHANGE_TIMEOUT=8.0,
            NEW_VIEW_TIMEOUT=4.0)

# --- flight-recorder failure artifacts --------------------------------------
# Every scenario tracks its pool here; a failing rung dumps ALL nodes'
# flight-recorder rings (span events + anomalies: the pool's last-seconds
# story) to a temp dir and names it in the assertion, so a fuzz failure
# arrives debuggable instead of as a bare seed number.
_SCENARIO_POOLS: list = []


def _track(pool):
    _SCENARIO_POOLS.clear()
    _SCENARIO_POOLS.append(pool)
    return pool


def _dump_flight_artifacts(label: str):
    import os
    import tempfile
    if not _SCENARIO_POOLS:
        return None
    pool = _SCENARIO_POOLS[0]
    out = tempfile.mkdtemp(prefix=f"plenum_flight_{label}_")
    dumped = 0
    for name, node in sorted(pool.nodes.items()):
        tracer = getattr(node, "tracer", None)
        if tracer is not None and getattr(tracer, "enabled", False):
            tracer.dump(os.path.join(out, f"{name}-flight.json"))
            dumped += 1
    return out if dumped else None


def _run_with_artifacts(scenario, seed: int) -> None:
    try:
        scenario(seed)
    except AssertionError as e:
        artifacts = _dump_flight_artifacts(f"seed{seed}")
        if artifacts is not None:
            raise AssertionError(
                f"{e} [flight-recorder rings of all nodes: "
                f"{artifacts}]") from e
        raise
    except BaseException:
        # crash bugs (and Ctrl-C) still get their artifacts, but the
        # original exception TYPE re-raises untouched — wrapping a
        # KeyboardInterrupt as AssertionError would turn an abort into a
        # recorded failure and keep the sweep running
        import sys
        artifacts = _dump_flight_artifacts(f"seed{seed}")
        if artifacts is not None:
            print(f"[flight-recorder rings of all nodes: {artifacts}]",
                  file=sys.stderr)
        raise
    finally:
        _SCENARIO_POOLS.clear()


def _domain_txns(node) -> list[str]:
    ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
    return [txn_lib.txn_digest(ledger.get_by_seq_no(i)) or str(i)
            for i in range(1, ledger.size + 1)]


def assert_safety(pool) -> None:
    """No fork: every pair of domain ledgers agrees on their common prefix."""
    chains = {n: _domain_txns(node) for n, node in pool.nodes.items()}
    names = list(chains)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            common = min(len(chains[a]), len(chains[b]))
            assert chains[a][:common] == chains[b][:common], \
                f"FORK between {a} and {b}: {chains[a]} vs {chains[b]}"


def _order_and_time(pool, req, expect_size: float, timeout: float = 25.0):
    """Submit and run until every node's domain ledger reaches
    expect_size; -> sim seconds it took, or None on timeout."""
    t0 = pool.timer.get_current_time()
    pool.submit(req)
    elapsed = 0.0
    while elapsed < timeout:
        pool.run(0.5)
        elapsed += 0.5
        if all(len(_domain_txns(pool.nodes[n])) >= expect_size
               for n in pool.names):
            return pool.timer.get_current_time() - t0
    return None


def run_device_flap_scenario(seed: int) -> None:
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CLOSED, CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 104729 + 71)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2,
                               cooldown=rng.float(0.5, 1.5)),
        budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                              warm_max=1.0, cold_max=1.0))
    pool = _track(Pool(seed=seed, config=Config(**FAST), verifier=sup))
    # the supervisor's whole state machine runs on SIM time: any failing
    # seed replays exactly
    sup.set_clock(pool.timer.get_current_time)
    faulty.set_clock(pool.timer.get_current_time)

    users = [Ed25519Signer(seed=(b"flap%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    # pre-fault: device-backed ordering, timed
    pre = _order_and_time(pool, reqs[0], 2)
    assert pre is not None, f"seed {seed}: healthy pool failed to order"
    assert sup.stats["device_batches"] >= 1, "traffic never hit the device"

    # fault the plane MID-consensus: request in flight, then the relay
    # wedges (replies lost) / drops (refuses) / corrupts (dies mid-read)
    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    pool.submit(reqs[1])
    pool.run(rng.float(0.0, 0.3))
    getattr(faulty, kind)()
    during = _order_and_time(pool, reqs[2], 4)
    assert during is not None, \
        f"seed {seed}: pool stopped ordering under device {kind}"
    st = sup.supervisor_stats()
    assert st["fallback_batches"] >= 1, \
        f"seed {seed}: no CPU fallback recorded under {kind}"
    # MEASURED stall bound: no dispatch waited past its deadline budget
    # (+2 prod ticks of poll granularity)
    assert st["max_stall_s"] <= st["max_budget_s"] + 0.3, \
        f"seed {seed}: stall {st['max_stall_s']:.2f}s past budget " \
        f"{st['max_budget_s']:.2f}s"

    # heal: traffic drives the cooldown -> probe -> re-warm -> re-admit
    faulty.heal()
    waited = 0.0
    while sup.breaker.state != CLOSED and waited < 30.0:
        pool.run(1.0)
        waited += 1.0
        # probes only advance on plane calls; idle pools still heal
        # because periodic node traffic (freshness checks) may be sparse,
        # so nudge with a tiny verify
        sup.verify_batch([(b"heal-nudge-%d-%f" % (seed, waited),
                           b"\0" * 64, b"\0" * 32)])
    assert sup.breaker.state == CLOSED, \
        f"seed {seed}: breaker never re-closed after heal ({kind})"
    assert st["verdict_forks"] == 0 and \
        sup.stats["verdict_forks"] == 0, "hedge forked backend verdicts"
    assert faulty.rewarms >= 1, "re-admission skipped the re-warm"

    # recovery: post-heal ordering latency back at the pre-fault level
    post = _order_and_time(pool, reqs[3], 5)
    assert post is not None, f"seed {seed}: pool dead after heal"
    assert post <= pre + 1.5, \
        f"seed {seed}: post-heal ordering {post:.1f}s vs pre {pre:.1f}s"
    tok = sup.submit_batch([(b"readmit-%d" % seed, b"\0" * 64, b"\0" * 32)])
    assert tok.kind == "dev", "device not re-admitted after close"
    sup.collect_batch(tok)
    assert_safety(pool)


def run_device_flap_with_pipeline(seed: int) -> None:
    """device_flap with the FUSED CRYPTO PIPELINE enabled: the pool's
    client-auth, BLS batch checks, and Merkle hashing all ride one shared
    ring (parallel/pipeline.py) whose ed25519 waves dispatch through the
    supervised faulty device. The fault must compose exactly as without
    the pipeline: breaker opens -> hedged CPU fallback keeps ordering ->
    re-warm re-admits the device and fresh waves hit it again — and the
    pool's verdicts/ledgers stay identical-safe throughout."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import (CLOSED, CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 92821 + 37)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2,
                               cooldown=rng.float(0.5, 1.5)),
        budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                              warm_max=1.0, cold_max=1.0))
    pipeline = CryptoPipeline(ed_inner=sup, config=Config(**FAST))
    pool = _track(Pool(seed=seed, config=Config(**FAST),
                       pipeline=pipeline))
    # node construction re-pins the pipeline clock to the pool timer; the
    # fault plane needs the same sim clock so failing seeds replay
    sup.set_clock(pool.timer.get_current_time)
    faulty.set_clock(pool.timer.get_current_time)

    users = [Ed25519Signer(seed=(b"pflap%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    pre = _order_and_time(pool, reqs[0], 2)
    assert pre is not None, f"seed {seed}: healthy pipelined pool stalled"
    assert pipeline.stats["dispatches"] >= 1, "no wave ever dispatched"
    assert sup.stats["device_batches"] >= 1, \
        "waves bypassed the supervised device"

    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    pool.submit(reqs[1])
    pool.run(rng.float(0.0, 0.3))
    getattr(faulty, kind)()
    # the ring coalesces so aggressively that pool traffic alone may not
    # produce fail_threshold device waves quickly — drive fresh waves
    # through the ring until the breaker trips (bounded)
    nudges = 0
    while sup.breaker.state == CLOSED and nudges < 20:
        nudges += 1
        pool.run(0.2)
        pipeline.verifier().verify_batch(
            [(b"pipe-fault-%d-%d" % (seed, nudges), b"\0" * 64,
              b"\0" * 32)])
    assert sup.breaker.state != CLOSED, \
        f"seed {seed}: breaker never opened under {kind} with pipeline"
    during = _order_and_time(pool, reqs[2], 4)
    assert during is not None, \
        f"seed {seed}: pipelined pool stopped ordering under {kind}"
    st = sup.supervisor_stats()
    assert st["fallback_batches"] >= 1, \
        f"seed {seed}: no CPU fallback under {kind} with pipeline"
    assert st["max_stall_s"] <= st["max_budget_s"] + 0.3, \
        f"seed {seed}: stall {st['max_stall_s']:.2f}s past budget"

    faulty.heal()
    waited = 0.0
    while sup.breaker.state != CLOSED and waited < 30.0:
        pool.run(1.0)
        waited += 1.0
        # nudge THROUGH the ring: probes advance on plane calls
        pipeline.verifier().verify_batch(
            [(b"pipe-heal-%d-%f" % (seed, waited), b"\0" * 64,
              b"\0" * 32)])
    assert sup.breaker.state == CLOSED, \
        f"seed {seed}: breaker never re-closed after heal ({kind})"
    assert sup.stats["verdict_forks"] == 0, "hedge forked verdicts"
    assert faulty.rewarms >= 1, "re-admission skipped the re-warm"

    # re-admission THROUGH the pipeline: a fresh wave must hit the device
    dev_before = sup.stats["device_batches"]
    pipeline.verifier().verify_batch(
        [(b"pipe-readmit-%d" % seed, b"\0" * 64, b"\0" * 32)])
    assert sup.stats["device_batches"] > dev_before, \
        "post-heal wave did not reach the re-admitted device"
    post = _order_and_time(pool, reqs[3], 5)
    assert post is not None, f"seed {seed}: pipelined pool dead after heal"
    assert post <= pre + 1.5, \
        f"seed {seed}: post-heal ordering {post:.1f}s vs pre {pre:.1f}s"
    assert_safety(pool)


def run_device_flap_with_commit_wave(seed: int) -> None:
    """device_flap with the fault aimed at the COMMIT-WAVE lane: the
    pool's triple-root recommit (verkle state + ledger + audit) rides a
    wedgeable device MSM engine behind the shared ring's cmt lane.
    Mid-run the engine wedges; the wave degrades exactly that traffic to
    host recommit (breaker-style, inside `_cmt_dispatch`) so roots keep
    advancing and ordering continues, the ed lane stays isolated (its
    waves keep dispatching — a cmt wedge is never ring-wide), and after
    the heal fresh cmt waves hit the engine again."""
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
    from plenum_tpu_torch.state.commitment import kzg

    class WedgeableCmtEngine:
        """Answers like the host KZG engine until wedged, then raises —
        the device-MSM failure mode `_cmt_dispatch` must absorb."""

        def __init__(self):
            self.wedged = False
            self.waves = 0

        def run_jobs(self, jobs):
            if self.wedged:
                raise RuntimeError("cmt device wedged")
            self.waves += 1
            out = []
            for job in jobs:
                if job[0] == "commit":
                    out.append(kzg.engine_for(job[1]).commit(dict(job[2])))
                elif job[0] == "multiproof":
                    out.append(kzg.prove_multi(list(job[1])))
                else:
                    out.append(None)
            return out

    rng = SimRandom(seed * 75503 + 29)
    eng = WedgeableCmtEngine()
    cfg = dict(FAST, STATE_COMMITMENT="verkle")
    # the port's ring takes its Ed25519 inner explicitly; the reference's
    # default is this CPU verifier
    pipeline = CryptoPipeline(ed_inner=CpuEd25519Verifier(), cmt_inner=eng,
                              config=Config(**cfg))
    pool = _track(Pool(seed=seed, config=Config(**cfg),
                       pipeline=pipeline))
    users = [Ed25519Signer(seed=(b"cwflap%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    # pre-fault: the fused ordered path engages and rides the engine
    pre = _order_and_time(pool, reqs[0], 2)
    assert pre is not None, f"seed {seed}: healthy commit-wave pool stalled"
    assert pipeline.stats["cmt_waves"] >= 1, \
        f"seed {seed}: ordered batches never built a commit wave"
    assert eng.waves >= 1, \
        f"seed {seed}: recommit jobs never reached the cmt engine"
    node = pool.nodes[pool.names[0]]
    root_pre = node.c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash

    # wedge the engine MID-consensus: a request is in flight when every
    # subsequent cmt wave starts dying on the device
    pool.submit(reqs[1])
    pool.run(rng.float(0.0, 0.3))
    eng.wedged = True
    ed_before = pipeline.stats["dispatches"]
    during = _order_and_time(pool, reqs[2], 4)
    assert during is not None, \
        f"seed {seed}: pool stopped ordering under cmt engine wedge"
    assert pipeline.stats["cmt_host_fallbacks"] >= 1, \
        f"seed {seed}: wedged cmt wave never degraded to host recommit"
    # roots ADVANCE through the degrade: the batch lands on host-resolved
    # roots, never wedges the commit drain
    root_during = node.c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash
    assert root_during != root_pre, \
        f"seed {seed}: state root froze under cmt engine wedge"
    # lane isolation: the ed lane kept dispatching (no ring-wide failure)
    assert pipeline.stats["dispatches"] > ed_before, \
        f"seed {seed}: ed lane starved by the cmt wedge"

    # heal: fresh cmt waves must hit the engine again (re-admission is
    # per-wave — the degrade never blacklists the engine)
    eng.wedged = False
    waves_before = eng.waves
    post = _order_and_time(pool, reqs[3], 5)
    assert post is not None, f"seed {seed}: pool dead after cmt heal"
    assert eng.waves > waves_before, \
        f"seed {seed}: healed cmt engine never re-admitted waves"
    assert_safety(pool)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_device_flap_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_device_flap_scenario, seed)


def test_sim_device_flap_smoke():
    """One device_flap scenario always runs in the default suite."""
    _run_with_artifacts(run_device_flap_scenario, 3)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_device_flap_pipeline_fuzz(bucket):
    for seed in range(bucket * 3, bucket * 3 + 3):
        _run_with_artifacts(run_device_flap_with_pipeline, seed)


def test_sim_device_flap_pipeline_smoke():
    """One pipelined device_flap scenario always runs in the default
    suite: breaker -> CPU fallback -> re-warm re-admits the pipeline."""
    _run_with_artifacts(run_device_flap_with_pipeline, 1)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_device_flap_commit_wave_fuzz(bucket):
    for seed in range(bucket * 3, bucket * 3 + 3):
        _run_with_artifacts(run_device_flap_with_commit_wave, seed)


def test_sim_device_flap_commit_wave_smoke():
    """One commit-wave device_flap scenario always runs in the default
    suite: the wedged cmt engine degrades that batch to host recommit,
    roots keep advancing, the ed lane stays isolated, and the healed
    engine re-admits fresh waves."""
    _run_with_artifacts(run_device_flap_with_commit_wave, 1)
