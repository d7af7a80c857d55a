"""The port's copy of tests/test_sim_fuzz.py, run on plenum_tpu_torch
with every node's crypto on the CPU: the base view-change scenario, the
device-flap rungs (per node, through the shared ring, per lane of the
multi-device ring, on the commit-wave lane), the crypto-host-down rung of
the federated ring, the lying reader (MPT and Verkle), the client flood,
the lying edge, membership churn, and over the shard fabric the
cross-shard, reshard (with its 2PC, device-flap and client-flood
variants), directory-rotation and autopilot rungs. tools/fuzz_lint.py
reads this file.

Seeded randomized view-change fuzzing over the deterministic SimNetwork.

Reference test model: plenum/test/consensus/view_change/test_sim_view_change.py
+ test/simulation/sim_network.py:98 — many seeds, random latencies, drops and
primary failures injected mid-protocol; every run must preserve SAFETY (no
two nodes commit different txns at the same seq_no) and, once the fault
heals, LIVENESS (pending requests get ordered under some primary).

Every scenario is a pure function of its seed: SimNetwork randomness, fault
choice, fault timing and traffic all derive from SimRandom(seed), so any
failing seed replays exactly.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.network import Discard, Deliver, SimRandom, match_dst, match_frm
from plenum_tpu_torch.network.sim_network import match_type

from test_torch_pool import Pool, signed_nym

FAST = dict(Max3PCBatchWait=0.05,
            crypto_backend="cpu",
            PRIMARY_HEALTH_CHECK_FREQ=0.5,
            ORDERING_PROGRESS_TIMEOUT=2.0,
            STATE_FRESHNESS_UPDATE_INTERVAL=3.0,
            VIEW_CHANGE_TIMEOUT=8.0,
            NEW_VIEW_TIMEOUT=4.0)

N_SEEDS = 100

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


def run_scenario(seed: int) -> None:
    rng = SimRandom(seed * 7919 + 17)
    # draw the scenario FIRST: scenario 3 needs a durable pool (crash-
    # recovery with stable storage), the rest an in-memory one — building
    # both would double every seed's setup cost
    scenario = rng.integer(0, 5)
    durable = None
    if scenario == 3:
        import tempfile
        durable = tempfile.mkdtemp(prefix="plenum_fuzz_s3_")
        pool = _track(Pool(seed=seed,
                           config=Config(**FAST, kv_backend="native"),
                           data_dir=durable))
    else:
        pool = _track(Pool(seed=seed, config=Config(**FAST)))
    primary = pool.nodes["Alpha"].master_replica.data.primary_name

    users = [Ed25519Signer(seed=(b"fuzz%d-%d" % (seed, i)).ljust(32, b"\0")[:32])
             for i in range(3)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    if scenario == 0:
        # primary blackout at a random moment while traffic flows
        pool.submit(reqs[0])
        pool.run(rng.float(0.0, 1.5))
        rules = [pool.net.add_rule(Discard(), match_dst(primary)),
                 pool.net.add_rule(Discard(), match_frm(primary))]
        pool.submit(reqs[1], to=[n for n in pool.names if n != primary])
        pool.run(25.0)
        survivors = [n for n in pool.names if n != primary]
        for n in survivors:
            assert pool.nodes[n].master_replica.view_no >= 1, \
                f"seed {seed}: {n} stuck in view 0"
            assert len(_domain_txns(pool.nodes[n])) >= 3, \
                f"seed {seed}: {n} lost requests across the view change"
    elif scenario == 1:
        # lossy network: drop a random slice of consensus traffic for a
        # while, then heal; MessageReq/catchup must recover — a view change
        # may or may not happen, both are legal
        p_drop = rng.float(0.1, 0.4)
        victim = pool.names[rng.integer(0, 3)]
        rule = pool.net.add_rule(Discard(probability=p_drop),
                                 match_dst(victim))
        pool.submit(reqs[0])
        pool.run(rng.float(2.0, 5.0))
        pool.net.remove_rule(rule)
        pool.submit(reqs[1])
        pool.run(20.0)
        sizes = {len(_domain_txns(pool.nodes[n])) for n in pool.names
                 if n != victim}
        assert sizes == {3}, f"seed {seed}: healed pool did not order: {sizes}"
    elif scenario == 2:
        # slow new-primary: the view change itself runs under heavy random
        # delay on the next primary's traffic (concurrent VC pressure — the
        # first VC can time out and escalate to view+2; any view >= 1 with
        # all traffic ordered is a pass)
        next_primary = pool.nodes["Alpha"].replicas.master.data.validators[1]
        pool.net.add_rule(Deliver(rng.float(0.5, 1.0), rng.float(1.5, 4.0)),
                          match_frm(next_primary))
        rules = [pool.net.add_rule(Discard(), match_dst(primary)),
                 pool.net.add_rule(Discard(), match_frm(primary))]
        pool.submit(reqs[0], to=[n for n in pool.names if n != primary])
        pool.run(40.0)
        survivors = [n for n in pool.names if n != primary]
        views = {pool.nodes[n].master_replica.view_no for n in survivors}
        assert all(v >= 1 for v in views), f"seed {seed}: views {views}"
        for n in survivors:
            assert len(_domain_txns(pool.nodes[n])) >= 2, \
                f"seed {seed}: {n} did not order after delayed VC"
    elif scenario == 3:
        # quorum loss then heal: TWO nodes crash at a random moment (the
        # survivors drop below weak-quorum connectivity -> the
        # NetworkInconsistencyWatcher fires and marks a resync); the
        # crashed pair returns FROM ITS DURABLE STATE (crash-recovery
        # with stable storage — restarting 2 of 4 from genesis would be
        # amnesia x2 > f, outside the BFT fault model, and genuinely
        # forks the audit ledger), catches up, and the survivors must
        # ALSO resync — then everyone orders new traffic.
        import shutil
        pool.submit(reqs[0])
        pool.run(rng.float(1.0, 4.0))
        dead = [n for n in pool.names if n != primary][:2] \
            if rng.integer(0, 2) else [primary,
                                       [n for n in pool.names
                                        if n != primary][0]]
        for n in dead:
            pool.crash_node(n)
        pool.run(rng.float(0.5, 2.0))
        for n in pool.names:
            if n not in dead:
                assert pool.nodes[n]._needs_resync, \
                    f"seed {seed}: {n} never noticed losing quorum"
        for n in dead:
            pool.start_node(n)
        pool.net.connect_all()
        for n in dead:
            pool.nodes[n].start_catchup()
        pool.run(20.0)
        pool.submit(reqs[1])
        pool.run(20.0)
        try:
            sizes = {len(_domain_txns(node))
                     for node in pool.nodes.values()}
            assert sizes == {3}, f"seed {seed}: healed pool diverged: {sizes}"
            for n in pool.names:
                if n not in dead:
                    assert not pool.nodes[n]._needs_resync, \
                        f"seed {seed}: {n} still marked inconsistent"
        finally:
            shutil.rmtree(durable, ignore_errors=True)
            import gc
            gc.collect()    # crash_node leaks handles by design (real
            #                 crashes do); a multi-thousand-seed sweep in
            #                 one interpreter needs them reaped promptly
    elif scenario == 4:
        # BYZANTINE LIES: one non-primary node's outbound 3PC messages are
        # randomly mutated in flight (type-preserving field corruption —
        # digests, seq/view numbers, roots — exactly what a malicious
        # peer's process could emit). f=1 tolerates one liar: SAFETY must
        # hold unconditionally and the pool must keep ordering.
        from plenum_tpu_torch.common.node_messages import (Commit, PrePrepare,
                                                     Prepare)
        from plenum_tpu_torch.network import Mutate
        import dataclasses
        liar = [n for n in pool.names if n != primary][rng.integer(0, 2)]

        def corrupt(msg, rng=rng):
            kind = rng.integer(0, 3)
            try:
                if kind == 0 and hasattr(msg, "digest") and msg.digest:
                    return dataclasses.replace(
                        msg, digest="f" * len(msg.digest))
                if kind == 1 and hasattr(msg, "pp_seq_no"):
                    return dataclasses.replace(
                        msg, pp_seq_no=msg.pp_seq_no + rng.integer(1, 3))
                if kind == 2 and hasattr(msg, "state_root") and \
                        getattr(msg, "state_root", ""):
                    return dataclasses.replace(msg, state_root="0" * 64)
                if hasattr(msg, "view_no"):
                    return dataclasses.replace(
                        msg, view_no=msg.view_no + rng.integer(1, 2))
            except Exception:
                return None     # unmutable shape: drop it (also byzantine)
            return msg

        pool.net.add_rule(Mutate(corrupt, probability=rng.float(0.3, 0.9)),
                          match_frm(liar),
                          match_type((PrePrepare, Prepare, Commit)))
        pool.submit(reqs[0])
        pool.run(10.0)
        pool.submit(reqs[1])
        pool.run(20.0)
        honest = [n for n in pool.names if n != liar]
        sizes = {len(_domain_txns(pool.nodes[n])) for n in honest}
        assert sizes == {3}, \
            f"seed {seed}: honest nodes failed to order under lies: {sizes}"
    else:
        # lagging node crawls through the whole view change (multi-second
        # random delays both ways — it cannot block the VC quorum, only
        # trail it), then heals and must converge into the new view.
        # NOTE a third cut-off node would break the n-f=3 quorum at n=4;
        # lag, not partition, is the strongest fault that keeps VC live.
        # lag must stay under NEW_VIEW_TIMEOUT: with only 3 live votes at
        # n=4, a laggard slower than the VC timers means NO view can ever
        # stabilize (cascading view changes) — correct BFT behavior, but
        # then there is no liveness to assert until the network heals
        laggard = [n for n in pool.names if n != primary][rng.integer(0, 2)]
        lag_rules = [
            pool.net.add_rule(Deliver(1.0, rng.float(1.5, 3.0)),
                              match_dst(laggard)),
            pool.net.add_rule(Deliver(1.0, rng.float(1.5, 3.0)),
                              match_frm(laggard))]
        pool.net.add_rule(Discard(), match_dst(primary))
        pool.net.add_rule(Discard(), match_frm(primary))
        active = [n for n in pool.names if n not in (primary, laggard)]
        pool.submit(reqs[0], to=active)
        pool.run(30.0)
        for rule in lag_rules:
            pool.net.remove_rule(rule)
        pool.run(15.0)
        node = pool.nodes[laggard]
        if node.master_replica.view_no == 0 or \
                len(_domain_txns(node)) < 2:
            node.start_catchup()          # trailing node syncs explicitly
            pool.run(15.0)
        assert node.master_replica.view_no >= 1, \
            f"seed {seed}: laggard never adopted the new view"
        assert len(_domain_txns(node)) >= 2, \
            f"seed {seed}: laggard did not catch up the VC-era txns"
    assert_safety(pool)


# --- scenario kind `device_flap`: the crypto plane is the fault -------------
# A seed-driven relay wedge/drop/corrupt hits the pool's SHARED device
# verifier mid-consensus. The plane supervisor must degrade every node to
# hedged CPU verdicts (no request stalls past its per-batch deadline
# budget — measured from the supervisor's stall accounting, not asserted
# by sleeping), keep ordering throughout, and after the seeded heal the
# breaker must re-warm + re-admit the device with ordering latency back
# at the pre-fault level. Runs as its OWN seed sweep rather than widening
# run_scenario's rng.integer(0, 5) draw, which would silently remap every
# historical seed of the six existing kinds.


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


def run_device_flap_multidevice(seed: int) -> None:
    """device_flap with a PER-DEVICE fault target: the pool's crypto
    pipeline is sharded into 4 chip lanes (one supervised verifier +
    breaker each), and the seed-derived FaultPlan names ONE device index
    — every lane carries the same plan, but only the lane whose
    `device_index` matches reads the fault windows. Mid-consensus the
    targeted chip wedges; EXACTLY that lane's breaker may open (no
    ring-wide breaker), every other lane's dispatch count keeps
    advancing, aggregate ordering continues, and after the window ends
    the lane re-warms and rejoins (fresh pinned waves hit its device
    again)."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultPlan, FaultyVerifier
    from plenum_tpu_torch.parallel.pipeline import MultiDeviceCryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import (CLOSED, CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 48271 + 11)
    n_lanes = 4
    # ONE plan, device-targeted by the seed; a fixed window keeps the
    # scenario's phases (healthy / faulted / healed) deterministic while
    # the targeted chip and fault mode stay seed-driven
    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    plan = FaultPlan.from_seed(seed, n_devices=n_lanes, n_faults=0)
    target = plan.device
    assert target is not None and 0 <= target < n_lanes
    # the window opens mid-consensus below (windows set then; an open
    # end means the fault holds until the explicit heal)

    faulties, sups = [], []
    for k in range(n_lanes):
        faulty = FaultyVerifier(CpuEd25519Verifier(), plan=plan,
                                device_index=k)
        sup = SupervisedVerifier(
            faulty, fallback=CpuEd25519Verifier(),
            breaker=CircuitBreaker(fail_threshold=2,
                                   cooldown=rng.float(0.5, 1.5)),
            budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                                  warm_max=1.0, cold_max=1.0),
            label=f"lane{k}")
        faulties.append(faulty)
        sups.append(sup)
    pipeline = MultiDeviceCryptoPipeline(
        ed_inners=sups, config=Config(**FAST), threaded=False)
    pool = _track(Pool(seed=seed, config=Config(**FAST),
                       pipeline=pipeline))
    for obj in (*sups, *faulties):
        obj.set_clock(pool.timer.get_current_time)

    users = [Ed25519Signer(seed=(b"mdflap%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    def junk(tag: bytes, n: int = 3):
        return [(b"%s-%d-%d" % (tag, seed, i), b"\x01" * 63 + b"\x00",
                 bytes([i + 1]) * 32) for i in range(n)]

    # pre-fault: every lane dispatches
    pre = _order_and_time(pool, reqs[0], 2)
    assert pre is not None, f"seed {seed}: healthy multi-lane pool stalled"
    for k in range(n_lanes):
        pipeline.verifier(lane=k).verify_batch(junk(b"pre%d" % k))
    disp_pre = [l.stats["dispatches"] for l in pipeline.lanes]
    assert all(d >= 1 for d in disp_pre), \
        f"seed {seed}: lane never dispatched pre-fault: {disp_pre}"
    assert all(s.breaker.state == CLOSED for s in sups)

    # open the fault window MID-consensus: a request is in flight when
    # the targeted chip starts failing (every lane carries this plan;
    # only device_index == target reads the window)
    pool.submit(reqs[1])
    pool.run(rng.float(0.0, 0.3))
    plan.windows = [(pool.timer.get_current_time(), 1e9, kind)]
    pool.run(0.2)
    # pinned traffic drives the targeted lane until ITS breaker opens
    nudges = 0
    while sups[target].breaker.state == CLOSED and nudges < 30:
        nudges += 1
        pool.run(0.2)
        pipeline.verifier(lane=target).verify_batch(
            junk(b"fault%d" % nudges))
    assert sups[target].breaker.state != CLOSED, \
        f"seed {seed}: targeted lane {target} breaker never opened " \
        f"under {kind}"
    # EXACTLY one lane degrades: no ring-wide breaker open
    others = [k for k in range(n_lanes) if k != target]
    for k in others:
        assert sups[k].breaker.state == CLOSED, \
            f"seed {seed}: lane {k} breaker opened for lane " \
            f"{target}'s fault ({kind})"
    # other lanes' dispatch counts keep advancing while lane k is down
    before = [pipeline.lanes[k].stats["dispatches"] for k in others]
    for k in others:
        pipeline.verifier(lane=k).verify_batch(junk(b"during%d" % k))
    after = [pipeline.lanes[k].stats["dispatches"] for k in others]
    assert all(b > a for a, b in zip(before, after)), \
        f"seed {seed}: healthy lanes stopped dispatching: " \
        f"{before} -> {after}"
    for k in others:
        assert sups[k].stats["device_batches"] >= 1

    # aggregate ordering continues above the single-lane floor: the
    # pool keeps ordering within the healthy-ordering deadline even
    # with one chip dark (its pinned waves ride host fallback)
    during = _order_and_time(pool, reqs[2], 4)
    assert during is not None, \
        f"seed {seed}: pool stopped ordering with lane {target} dark"
    st = sups[target].supervisor_stats()
    assert st["fallback_batches"] >= 1, \
        f"seed {seed}: no host fallback on the dark lane"
    assert st["max_stall_s"] <= st["max_budget_s"] + 0.3

    # heal: the targeted verifier recovers, traffic drives the probe ->
    # re-warm -> re-admission of that ONE lane
    faulties[target].heal()
    waited = 0.0
    while sups[target].breaker.state != CLOSED and waited < 30.0:
        pool.run(1.0)
        waited += 1.0
        pipeline.verifier(lane=target).verify_batch(
            junk(b"heal%f" % waited))
    assert sups[target].breaker.state == CLOSED, \
        f"seed {seed}: lane {target} never re-closed after heal ({kind})"
    assert faulties[target].rewarms >= 1, \
        "lane re-admission skipped the re-warm"
    assert all(s.stats["verdict_forks"] == 0 for s in sups)

    # the healed lane REJOINS: a fresh pinned wave hits its device
    dev_before = sups[target].stats["device_batches"]
    pipeline.verifier(lane=target).verify_batch(junk(b"rejoin"))
    assert sups[target].stats["device_batches"] > dev_before, \
        f"seed {seed}: healed lane {target} never re-admitted traffic"
    post = _order_and_time(pool, reqs[3], 5)
    assert post is not None, f"seed {seed}: pool dead after lane heal"
    assert_safety(pool)


def _move_to_lane(pipeline, tok, lane) -> None:
    """Re-stage an unhinted token onto a specific lane (scenario
    plumbing: the federated ring only routes unhinted work to a remote
    by occupancy, which a quiet sim pool rarely exercises)."""
    src = next(l for l in pipeline.lanes if tok in l.staged)
    if src is lane:
        return
    src.staged.remove(tok)
    if not src.staged:
        src.first_staged = None
    if not lane.staged:
        lane.first_staged = pipeline._now()
    lane.staged.append(tok)


def run_crypto_host_down_scenario(seed: int) -> None:
    """crypto_host_down: a rostered REMOTE crypto host dies/wedges
    mid-consensus under the federated pipeline (parallel/federation.py).
    The pool's ring runs 2 local chip lanes plus one remote-host lane
    (in-proc stand-in for the service client: the same supervised
    submit/collect + breaker + re-warm surface, on the sim clock so
    failing seeds replay). The seeded fault window targets ONLY the
    remote: exactly its breaker opens, its queued waves steal BACK to
    the local lanes (and are never double-verified), ordering never
    stalls past the deadline budget, and after the heal the host
    re-warms and REJOINS — fresh waves hit it again."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultPlan, FaultyVerifier
    from plenum_tpu_torch.parallel.federation import FederatedCryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import (CLOSED, CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 62233 + 29)
    n_local = 2
    remote_idx = n_local
    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    plan = FaultPlan.from_seed(seed, n_devices=n_local + 1, n_faults=0)
    # the victim IS the scenario kind: force the plan onto the remote
    # host's lane (seed still drives fault mode, timings, cooldowns)
    plan.device = remote_idx

    faulties, sups = [], []
    for k in range(n_local + 1):
        faulty = FaultyVerifier(CpuEd25519Verifier(), plan=plan,
                                device_index=k)
        sup = SupervisedVerifier(
            faulty, fallback=CpuEd25519Verifier(),
            breaker=CircuitBreaker(fail_threshold=2,
                                   cooldown=rng.float(0.5, 1.5)),
            budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                                  warm_max=1.0, cold_max=1.0),
            label=f"lane{k}" if k < n_local else "remote0")
        faulties.append(faulty)
        sups.append(sup)
    pipeline = FederatedCryptoPipeline(
        ed_inners=sups[:n_local], remote_inners=[sups[remote_idx]],
        hosts=["sim://crypto-host-0"],
        config=Config(**FAST, PIPELINE_STEAL_THRESHOLD=4,
                      PIPELINE_STEAL_COOLDOWN=0.1),
        threaded=False)
    remote_lane = pipeline.lanes[remote_idx]
    pool = _track(Pool(seed=seed, config=Config(**FAST),
                       pipeline=pipeline))
    for obj in (*sups, *faulties):
        obj.set_clock(pool.timer.get_current_time)

    users = [Ed25519Signer(seed=(b"hdown%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]

    def junk(tag: bytes, n: int = 3):
        return [(b"%s-%d-%d" % (tag, seed, i), b"\x01" * 63 + b"\x00",
                 bytes([i + 1]) * 32) for i in range(n)]

    # pre-fault: ordering healthy, every lane (including the rented
    # remote) carries at least one wave
    pre = _order_and_time(pool, reqs[0], 2)
    assert pre is not None, f"seed {seed}: healthy federated pool stalled"
    for k in range(n_local):
        pipeline.verifier(lane=k).verify_batch(junk(b"pre%d" % k))
    rtok = pipeline.submit_verify(junk(b"pre-remote"))
    rtok.lane_hint = None
    _move_to_lane(pipeline, rtok, remote_lane)
    assert pipeline.collect_verify(rtok, wait=True) is not None
    assert remote_lane.stats["dispatches"] >= 1, \
        f"seed {seed}: the remote lane never carried a wave pre-fault"
    assert all(s.breaker.state == CLOSED for s in sups)

    # the host dies MID-consensus: a request is in flight when the
    # remote's fault window opens (local lanes carry the same plan but
    # only device_index == remote reads it)
    pool.submit(reqs[1])
    pool.run(rng.float(0.0, 0.3))
    plan.windows = [(pool.timer.get_current_time(), 1e9, kind)]
    pool.run(0.2)
    nudges = 0
    while sups[remote_idx].breaker.state == CLOSED and nudges < 30:
        nudges += 1
        pool.run(0.2)
        sups[remote_idx].verify_batch(junk(b"fault%d" % nudges))
    assert sups[remote_idx].breaker.state != CLOSED, \
        f"seed {seed}: remote host breaker never opened under {kind}"
    # ONLY the remote lane degrades
    for k in range(n_local):
        assert sups[k].breaker.state == CLOSED, \
            f"seed {seed}: local lane {k} breaker opened for the " \
            f"remote host's {kind}"

    # steal-back: waves queued on the dead host's lane evacuate to the
    # LOCAL lanes (unconditionally — no threshold, no cooldown) and
    # settle there exactly once
    stok = pipeline.submit_verify(junk(b"stranded", n=4))
    stok.lane_hint = None
    _move_to_lane(pipeline, stok, remote_lane)
    steals_before = pipeline.stats["steals"]
    items_before = pipeline.stats["dispatched_items"]
    pipeline.service()
    assert pipeline.stats["steals"] > steals_before, \
        f"seed {seed}: dead host's queue never stole back"
    assert pipeline._lane_backlog(remote_lane) == 0, \
        f"seed {seed}: the open lane kept queued waves"
    out = pipeline.collect_verify(stok, wait=True)
    assert out is not None and len(out) == 4
    assert pipeline.stats["dispatched_items"] - items_before == 4, \
        f"seed {seed}: a stolen wave was double-verified"

    # local lanes keep dispatching; aggregate ordering continues within
    # the deadline budget while the host is dark
    before = [pipeline.lanes[k].stats["dispatches"]
              for k in range(n_local)]
    for k in range(n_local):
        pipeline.verifier(lane=k).verify_batch(junk(b"during%d" % k))
    after = [pipeline.lanes[k].stats["dispatches"] for k in range(n_local)]
    assert all(b > a for a, b in zip(before, after)), \
        f"seed {seed}: local lanes stalled: {before} -> {after}"
    during = _order_and_time(pool, reqs[2], 4)
    assert during is not None, \
        f"seed {seed}: pool stopped ordering with the host down"
    st = sups[remote_idx].supervisor_stats()
    assert st["fallback_batches"] >= 1, \
        f"seed {seed}: no fallback recorded on the dead host's lane"
    assert st["max_stall_s"] <= st["max_budget_s"] + 0.3, \
        f"seed {seed}: stall {st['max_stall_s']:.2f}s past budget " \
        f"{st['max_budget_s']:.2f}s"
    assert pipeline.federation_state()["remote_breakers_open"] == 1

    # heal: the host returns, the probe re-warms (for a real service
    # client this is the reconnect), the breaker re-closes
    faulties[remote_idx].heal()
    waited = 0.0
    while sups[remote_idx].breaker.state != CLOSED and waited < 30.0:
        pool.run(1.0)
        waited += 1.0
        sups[remote_idx].verify_batch(junk(b"heal%f" % waited))
    assert sups[remote_idx].breaker.state == CLOSED, \
        f"seed {seed}: host breaker never re-closed after heal ({kind})"
    assert faulties[remote_idx].rewarms >= 1, \
        "host re-admission skipped the re-warm"
    assert all(s.stats["verdict_forks"] == 0 for s in sups)

    # rejoin: a fresh wave through the ring reaches the host again
    dev_before = sups[remote_idx].stats["device_batches"]
    jtok = pipeline.submit_verify(junk(b"rejoin"))
    jtok.lane_hint = None
    _move_to_lane(pipeline, jtok, remote_lane)
    assert pipeline.collect_verify(jtok, wait=True) is not None
    assert sups[remote_idx].stats["device_batches"] > dev_before, \
        f"seed {seed}: healed host never re-admitted ring traffic"
    assert pipeline.federation_state()["remote_breakers_open"] == 0
    post = _order_and_time(pool, reqs[3], 5)
    assert post is not None, f"seed {seed}: pool dead after host heal"
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
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
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


def run_lying_reader_scenario(seed: int) -> None:
    """A Byzantine node forges read replies; the verifying read client
    must reject every forgery kind and fail over to an honest node
    within its per-rung deadline — or, when the liar strips the proof
    entirely, escalate to the f+1 broadcast (which the diverging-reader
    vote-key fix keeps sound)."""
    import copy

    from plenum_tpu_torch.common.node_messages import Reply
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF, result_digest
    from test_torch_reads import FOREVER, LyingPlane, make_driver

    rng = SimRandom(seed * 6151 + 13)
    pool = _track(Pool(seed=seed, config=Config(**FAST)))
    user = Ed25519Signer(seed=(b"liar%d" % seed).ljust(32, b"\0")[:32])
    assert _order_and_time(pool, signed_nym(pool.trustee, user, 1), 2) \
        is not None

    def forge_value(result):
        env = result.get(READ_PROOF)
        if env and env.get("entries"):
            e = env["entries"][0]
            if e.get("value"):
                e["value"] = bytes(
                    reversed(bytes.fromhex(e["value"]))).hex()
        return result

    def forge_root(result):
        env = result.get(READ_PROOF)
        if env and env.get("root_hash"):
            env["root_hash"] = "ab" * 32
            env["result_digest"] = result_digest(result).hex()
        return result

    def mismatch_ms(result):
        env = result.get(READ_PROOF)
        if env:
            ms = env["multi_signature"]
            ms[1] = list(ms[1])[:-1]     # claim a smaller participant set
            env["result_digest"] = result_digest(result).hex()
        return result

    def tamper_data(result):
        if isinstance(result.get("data"), dict):
            result["data"] = dict(result["data"], verkey="EvilVerkey1111")
            env = result.get(READ_PROOF)
            if env:                      # smart liar: re-binds the digest
                env["result_digest"] = result_digest(result).hex()
        return result

    def strip(result):
        result.pop(READ_PROOF, None)
        return result

    kind, mutate = [("forge_value", forge_value),
                    ("forge_root", forge_root),
                    ("mismatch_ms", mismatch_ms),
                    ("tamper_data", tamper_data),
                    ("strip", strip)][rng.integer(0, 4)]
    liar = pool.names[rng.integer(0, len(pool.names) - 1)]
    node = pool.nodes[liar]
    node.read_plane = LyingPlane(node.read_plane, mutate)

    driver = make_driver(pool, client="fuzz", freshness_s=FOREVER)
    q = Request("fuzz", 50, {"type": GET_NYM, "dest": user.identifier})
    order = [liar] + [n for n in pool.names if n != liar]
    t0 = pool.timer.get_current_time()
    res = driver.read(q, per_node_s=2.0, order=order)
    took = pool.timer.get_current_time() - t0
    deadline = 2.0 * len(pool.names) + 1.0
    assert took <= deadline, \
        f"seed {seed}: {kind} read took {took:.1f}s > {deadline:.1f}s"
    s = driver.stats
    if kind == "strip":
        # no proof at all -> escalate to the legacy f+1 broadcast; the
        # content vote key keeps the liar's divergent data sub-quorum
        assert res is None and s.fallbacks == 1, f"seed {seed}"
        from plenum_tpu_torch.client.client import PoolClient
        pool.submit(q, client="fuzz-bc")
        pool.run(2.0)
        votes: dict = {}
        for name in pool.names:
            for m, c in pool.client_msgs[name]:
                if c == "fuzz-bc" and isinstance(m, Reply):
                    key = PoolClient._vote_key(
                        {"op": "REPLY", "result": copy.deepcopy(m.result)})
                    votes[key] = votes.get(key, 0) + 1
        agreed = [k for k, v in votes.items()
                  if v >= pool.nodes[liar].f + 1]
        assert len(agreed) == 1, f"seed {seed}: votes {votes}"
    else:
        assert res is not None, f"seed {seed}: {kind} never failed over"
        assert res["data"]["verkey"] == user.verkey_b58, f"seed {seed}"
        assert s.verify_failures >= 1 and s.failovers >= 1, \
            f"seed {seed}: {kind} accepted a forged reply " \
            f"({s.summary()})"
        assert s.single_reply_ok == 1 and s.fallbacks == 0, f"seed {seed}"
    assert_safety(pool)


def run_lying_reader_verkle_scenario(seed: int) -> None:
    """The lying_reader family on a VERKLE-backed pool (STATE_COMMITMENT
    config seam): a Byzantine node forges wide-commitment read replies
    and every rung must fail CLOSED and fail over to an honest node —

    * ``forge_opening``: the aggregated opening proof (pi) is tampered;
    * ``wrong_root``: the envelope cites a commitment root the pool
      never signed;
    * ``splice_multi``: one key's value is swapped INSIDE an aggregated
      multi-key answer (the 2-key TAA chain), with the result data and
      result_digest rebound by a smart liar — only the single pairing
      check can catch it;
    * ``strip``: the proof is removed entirely -> the ladder escalates
      to the f+1 broadcast, which must still agree on honest content.
    """
    import copy

    from plenum_tpu_torch.common.node_messages import (CONFIG_LEDGER_ID, Reply)
    from plenum_tpu_torch.common.serialization import pack as _pack
    from plenum_tpu_torch.execution.txn import (GET_NYM,
                                          GET_TXN_AUTHOR_AGREEMENT,
                                          TXN_AUTHOR_AGREEMENT)
    from plenum_tpu_torch.reads import READ_PROOF, result_digest
    from test_torch_reads import FOREVER, LyingPlane, make_driver

    rng = SimRandom(seed * 7177 + 29)
    pool = _track(Pool(seed=seed,
                       config=Config(**FAST, STATE_COMMITMENT="verkle")))
    user = Ed25519Signer(seed=(b"vliar%d" % seed).ljust(32, b"\0")[:32])
    assert _order_and_time(pool, signed_nym(pool.trustee, user, 1), 2) \
        is not None, f"seed {seed}: verkle pool failed to order"
    # a TAA gives GET_TXN_AUTHOR_AGREEMENT its 2-key deref chain — the
    # aggregated MULTI-key envelope the splice rung attacks
    taa = Request(pool.trustee.identifier, 2,
                  {"type": TXN_AUTHOR_AGREEMENT, "version": "1",
                   "text": "terms %d" % seed})
    taa.signature = pool.trustee.sign_b58(taa.signing_bytes())
    pool.submit(taa)
    config_ledger = pool.nodes[pool.names[0]].c.db.get_ledger(
        CONFIG_LEDGER_ID)
    waited = 0.0
    while config_ledger.size < 1 and waited < 20.0:
        pool.run(0.5)
        waited += 0.5
    assert config_ledger.size >= 1, f"seed {seed}: TAA never ordered"
    pool.run(1.0)                    # let the config anchor land

    def forge_opening(result):
        env = result.get(READ_PROOF)
        if env and env.get("kind") == "verkle":
            pi = bytearray(bytes.fromhex(env["proof"]["pi"]))
            pi[0] ^= 0xFF
            pi[-1] ^= 0xFF
            env["proof"]["pi"] = bytes(pi).hex()
        return result

    def wrong_root(result):
        env = result.get(READ_PROOF)
        if env and env.get("kind") == "verkle":
            env["root_hash"] = "ab" * 32
            env["result_digest"] = result_digest(result).hex()
        return result

    def splice_multi(result):
        env = result.get(READ_PROOF)
        if env and env.get("kind") == "verkle" \
                and len(env.get("entries", ())) >= 2:
            # swap the terminal key's value inside the aggregated proof;
            # rebind data + digest so key chain, consistency, and digest
            # ALL pass — only the pairing check stands
            forged = dict(result.get("data") or {}, text="EVIL TERMS")
            env["entries"][-1]["value"] = _pack(forged).hex()
            result["data"] = forged
            env["result_digest"] = result_digest(result).hex()
        return result

    def strip(result):
        result.pop(READ_PROOF, None)
        return result

    kind, mutate, query = [
        ("forge_opening", forge_opening,
         {"type": GET_NYM, "dest": user.identifier}),
        ("wrong_root", wrong_root,
         {"type": GET_NYM, "dest": user.identifier}),
        ("splice_multi", splice_multi,
         {"type": GET_TXN_AUTHOR_AGREEMENT}),
        ("strip", strip,
         {"type": GET_NYM, "dest": user.identifier}),
    ][rng.integer(0, 3)]
    liar = pool.names[rng.integer(0, len(pool.names) - 1)]
    node = pool.nodes[liar]
    node.read_plane = LyingPlane(node.read_plane, mutate)

    driver = make_driver(pool, client="vfuzz", freshness_s=FOREVER)
    q = Request("vfuzz", 50, dict(query))
    order = [liar] + [n for n in pool.names if n != liar]
    t0 = pool.timer.get_current_time()
    res = driver.read(q, per_node_s=2.0, order=order)
    took = pool.timer.get_current_time() - t0
    deadline = 2.0 * len(pool.names) + 1.0
    assert took <= deadline, \
        f"seed {seed}: {kind} read took {took:.1f}s > {deadline:.1f}s"
    s = driver.stats
    if kind == "strip":
        # no proof at all -> escalate to the legacy f+1 broadcast; the
        # content vote key keeps the liar's divergent data sub-quorum
        assert res is None and s.fallbacks == 1, f"seed {seed}"
        from plenum_tpu_torch.client.client import PoolClient
        pool.submit(q, client="vfuzz-bc")
        pool.run(2.0)
        votes: dict = {}
        for name in pool.names:
            for m, c in pool.client_msgs[name]:
                if c == "vfuzz-bc" and isinstance(m, Reply):
                    key = PoolClient._vote_key(
                        {"op": "REPLY", "result": copy.deepcopy(m.result)})
                    votes[key] = votes.get(key, 0) + 1
        agreed = [k for k, v in votes.items()
                  if v >= pool.nodes[liar].f + 1]
        assert len(agreed) == 1, f"seed {seed}: votes {votes}"
    else:
        assert res is not None, f"seed {seed}: {kind} never failed over"
        env = res.get(READ_PROOF) or {}
        assert env.get("kind") == "verkle", \
            f"seed {seed}: honest reply not verkle ({env.get('kind')})"
        if kind == "splice_multi":
            assert len(env.get("entries", ())) >= 2, \
                f"seed {seed}: splice rung got a single-key envelope"
            assert res["data"]["text"] == "terms %d" % seed, f"seed {seed}"
        else:
            assert res["data"]["verkey"] == user.verkey_b58, f"seed {seed}"
        assert s.verify_failures >= 1 and s.failovers >= 1, \
            f"seed {seed}: {kind} accepted a forged verkle reply " \
            f"({s.summary()})"
        assert s.single_reply_ok == 1 and s.fallbacks == 0, f"seed {seed}"
    assert_safety(pool)


# --- scenario kind `client_flood`: the FRONT DOOR is under attack -----------
# Seed-driven bursts of hot clients (including bad-signature floods) hit
# per-node ingress planes while honest steady clients keep writing. The
# plane must shed the surplus EXPLICITLY (LoadShed replies, bounded
# queues), bad-signature floods must die in the batched verifier without
# ever reaching the pool, honest traffic must keep ordering within its
# SLO, and the node's raw client inbox must never wedge. Composable with
# the crypto-plane fault (device_flap's supervised verifier): a shed
# storm during CPU fallback stays bounded.


def _ingress_order_and_time(pool, ingress, req, expect_size: float,
                            timeout: float = 25.0, inbox_peaks=None):
    """Submit through EVERY node's ingress plane; -> sim seconds until
    every node's domain ledger reaches expect_size, or None."""
    t0 = pool.timer.get_current_time()
    for n in pool.names:
        ingress[n].submit(req.to_dict(), "steady")
    elapsed = 0.0
    while elapsed < timeout:
        pool.run(0.5)
        elapsed += 0.5
        if inbox_peaks is not None:
            inbox_peaks.append(max(len(pool.nodes[n]._client_inbox)
                                   for n in pool.names))
        if all(len(_domain_txns(pool.nodes[n])) >= expect_size
               for n in pool.names):
            return pool.timer.get_current_time() - t0
    return None


def run_client_flood_scenario(seed: int, faulted_plane=None) -> None:
    from plenum_tpu_torch.client.sim_clients import burst_writes
    from plenum_tpu_torch.common.node_messages import LoadShed
    from plenum_tpu_torch.ingress import IngressPlane

    rng = SimRandom(seed * 48611 + 7)
    cap = rng.integer(2, 6)
    config = Config(**FAST, INGRESS_CLIENT_QUEUE_CAP=cap,
                    INGRESS_SLO_P95=0.2, INGRESS_CONTROL_INTERVAL=0.5)
    verifier = faulted_plane[0] if faulted_plane is not None else None
    pool = _track(Pool(seed=seed, config=config, verifier=verifier))
    if faulted_plane is not None:
        sup, faulty = faulted_plane
        sup.set_clock(pool.timer.get_current_time)
        faulty.set_clock(pool.timer.get_current_time)
    ingress = {n: IngressPlane(pool.nodes[n]) for n in pool.names}
    inbox_peaks: list[int] = []
    # live telemetry rides the fuzz: every node's snapshots feed ONE
    # aggregator; the flood below MUST fire the ingress burn-rate alert
    # (and the healthy pre-flood phase must fire none)
    from plenum_tpu_torch.observability import FleetAggregator
    agg = FleetAggregator(config=config)
    for n in pool.names:
        pool.nodes[n].telemetry.add_sink(agg.ingest)

    def ingress_burn_pages():
        return [a for a in agg.alerts
                if a.kind == "slo_burn.ingress" and a.severity == "page"]

    users = [Ed25519Signer(seed=(b"cf%d-%d" % (seed, i)).ljust(32, b"\0")[:32])
             for i in range(2)]
    honest = [signed_nym(pool.trustee, u, i + 1)
              for i, u in enumerate(users)]

    # pre-flood: honest ordering through the plane, timed (the SLO datum)
    pre = _ingress_order_and_time(pool, ingress, honest[0], 2,
                                  inbox_peaks=inbox_peaks)
    assert pre is not None, f"seed {seed}: healthy plane failed to order"
    assert not ingress_burn_pages(), \
        f"seed {seed}: burn alert fired on a healthy plane (false positive)"

    if faulted_plane is not None:
        # crypto-plane fault lands BEFORE the flood: the shed storm rides
        # hedged CPU-fallback verdicts end to end
        kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
        getattr(faulted_plane[1], kind)()

    # the flood: hot clients burst well past their per-client caps; half
    # the seeds flood VALID-shaped bad signatures (they must die in the
    # ingress auth batch, not in the pool)
    n_hot = rng.integer(8, 24)
    per_client = cap + rng.integer(3, 8)
    bad = rng.integer(0, 2) == 0
    burst = burst_writes(pool.trustee, n_hot, per_client, seed=seed,
                         bad_sigs=bad)
    for client, req in burst:
        for n in pool.names:
            ingress[n].submit(req.to_dict(), client)
    # honest steady client writes DURING the flood: its queue is its own,
    # so fairness (not luck) keeps it inside the SLO
    during = _ingress_order_and_time(
        pool, ingress, honest[1],
        len(_domain_txns(pool.nodes[pool.names[0]])) + 1,
        timeout=30.0, inbox_peaks=inbox_peaks)
    deadline = pre + (15.0 if faulted_plane is not None else 8.0)
    assert during is not None, \
        f"seed {seed}: honest client starved during flood (bad={bad})"
    assert during <= deadline, \
        f"seed {seed}: honest order took {during:.1f}s > {deadline:.1f}s"

    # explicit sheds, never silent: every over-cap burst write got a
    # LoadShed reply on every node
    expect_shed = n_hot * (per_client - cap)
    for n in pool.names:
        assert ingress[n].stats["shed"] >= expect_shed, \
            f"seed {seed}: {n} shed {ingress[n].stats['shed']} < " \
            f"{expect_shed}"
        sheds = [m for m, _ in pool.client_msgs[n]
                 if isinstance(m, LoadShed)]
        assert len(sheds) >= expect_shed, f"seed {seed}: missing replies"
        # bounded queues: depth never exceeded what the caps allow
        assert ingress[n].stats["queue_depth_max"] <= \
            (n_hot + 2) * cap + 2, f"seed {seed}: queue grew past caps"
    if bad:
        # the bad-signature flood died at the front door: auth rejects
        # recorded, and NOT ONE flood write reached the ledger
        assert any(ingress[n].stats["auth_fail"] > 0 for n in pool.names), \
            f"seed {seed}: bad-sig flood never hit the batched verifier"
        assert len(_domain_txns(pool.nodes[pool.names[0]])) == 3, \
            f"seed {seed}: a bad-signature write ordered"
    # sustain the flood (same hot clients, fresh writes) across several
    # snapshot intervals: the multi-window rule pages on a shed storm
    # that PERSISTS on both burn windows (a lone burst is a blip — that
    # it cannot page is pinned deterministically in test_telemetry), and
    # the breadth rule counts the capped-client storm against the budget
    # because MANY distinct clients are being refused, not one abuser
    for wave in range(6):
        for client, req in burst_writes(pool.trustee, n_hot, per_client,
                                        seed=seed * 131 + wave + 1,
                                        bad_sigs=bad):
            for n in pool.names:
                ingress[n].submit(req.to_dict(), client)
        pool.run(1.0)
    assert ingress_burn_pages(), \
        f"seed {seed}: sustained flood never fired the ingress burn " \
        f"alert (alerts: {[a.to_dict() for a in agg.alerts]})"
    # the pool never wedged: the raw client inbox stayed near-empty the
    # whole run (writes ride ingress, never the inbox)
    assert max(inbox_peaks) <= 10, \
        f"seed {seed}: client inbox grew to {max(inbox_peaks)}"
    if faulted_plane is not None:
        st = faulted_plane[0].supervisor_stats()
        assert st["fallback_batches"] >= 1, \
            f"seed {seed}: flood under fault never took the CPU fallback"
        assert st["max_stall_s"] <= st["max_budget_s"] + 0.3, \
            f"seed {seed}: shed storm stalled past the deadline budget"
    assert_safety(pool)


def run_client_flood_with_device_flap(seed: int) -> None:
    """client_flood composed with device_flap: the shared crypto plane is
    faulted before the flood, so every shed decision and every batched
    verdict rides the supervisor's hedged CPU fallback."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 75403 + 11)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2,
                               cooldown=rng.float(0.5, 1.5)),
        budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                              warm_max=1.0, cold_max=1.0))
    run_client_flood_scenario(seed, faulted_plane=(sup, faulty))


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_client_flood_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_client_flood_scenario, seed)


def test_sim_client_flood_smoke():
    """One client_flood scenario always runs in the default suite."""
    _run_with_artifacts(run_client_flood_scenario, 2)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_client_flood_device_flap_fuzz(bucket):
    for seed in range(bucket * 3, (bucket + 1) * 3):
        _run_with_artifacts(run_client_flood_with_device_flap, seed)


def test_sim_client_flood_device_flap_smoke():
    """One composed flood+crypto-fault scenario in the default suite."""
    _run_with_artifacts(run_client_flood_with_device_flap, 1)


LYING_READER_SEEDS = 20


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_lying_reader_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_lying_reader_scenario, seed)


def test_sim_lying_reader_smoke():
    """One lying_reader scenario always runs in the default suite."""
    _run_with_artifacts(run_lying_reader_scenario, 2)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_lying_reader_verkle_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_lying_reader_verkle_scenario, seed)


def test_sim_lying_reader_verkle_smoke():
    """Two verkle rungs always run in the default suite: seed 4 draws
    the spliced-multi-key rung (the aggregated-proof-specific forgery),
    seed 9 the stripped-proof escalation."""
    _run_with_artifacts(run_lying_reader_verkle_scenario, 4)
    _run_with_artifacts(run_lying_reader_verkle_scenario, 9)


def test_sim_lying_reader_stale_replay():
    """A liar replaying a captured pre-rotation reply (honest sig, old
    root) must be rejected by the freshness bound and failed over."""
    from plenum_tpu_torch.execution.txn import GET_NYM, NYM
    from test_torch_reads import LyingPlane, make_driver

    pool = Pool(seed=5, config=Config(**FAST))
    user = Ed25519Signer(seed=b"stale-user".ljust(32, b"\0")[:32])
    assert _order_and_time(pool, signed_nym(pool.trustee, user, 1), 2) \
        is not None

    # capture an honest reply at t0 through the liar-to-be
    liar = pool.names[0]
    node = pool.nodes[liar]
    captured = node.read_plane.answer(
        Request("cap", 1, {"type": GET_NYM, "dest": user.identifier}))

    pool.run(12.0)                      # age the captured anchor
    rotated = Ed25519Signer(seed=b"stale-user-2".ljust(32, b"\0")[:32])
    upd = Request(pool.trustee.identifier, 2,
                  {"type": NYM, "dest": user.identifier,
                   "verkey": rotated.verkey_b58})
    upd.signature = pool.trustee.sign_b58(upd.signing_bytes())
    assert _order_and_time(pool, upd, 3) is not None

    # replay keeps the asker echo so the client matches the reply to its
    # request; the result digest excludes those fields, so the binding
    # still verifies and rejection comes from the freshness bound alone
    node.read_plane = LyingPlane(
        node.read_plane,
        lambda result: dict(captured, identifier=result.get("identifier"),
                            reqId=result.get("reqId")))
    driver = make_driver(pool, client="stale", freshness_s=8.0)
    q = Request("stale", 9, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q, per_node_s=2.0,
                      order=[liar] + [n for n in pool.names if n != liar])
    assert res is not None
    assert res["data"]["verkey"] == rotated.verkey_b58
    assert driver.stats.failovers >= 1
    assert driver.stats.verify_failures >= 1


def run_lying_edge_scenario(seed: int, force_rung=None) -> None:
    """The `lying_edge` fuzz kind: the Proof CDN's trust claim
    (reads/edge.py — deny-but-never-forge) under seeded attack. A
    malicious KEYLESS edge cache serves poisoned cached envelopes,
    strips proofs, or refuses outright; the verifying client must
    convert every forgery into a rejected reply + ladder failover and
    every denial into escalation — the read always completes with the
    true value, within the ladder deadline, with ZERO forged
    acceptances across all seeds. Rungs:

    * ``forge_value``: a state-proof entry's value bytes are reversed
      inside the cached envelope;
    * ``forge_root``: the envelope cites a root the pool never signed,
      with the result digest rebound by a smart liar;
    * ``tamper_data``: the result data is swapped and the digest
      rebound — only proof verification stands;
    * ``strip``: the proof is removed -> NO_PROOF escalation (a deeper
      rung can still prove);
    * ``deny``: the edge refuses -> NACK, one timed-out rung.
    """
    import copy

    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF, result_digest
    from test_torch_edge import attach_edge, make_edge_driver

    rng = SimRandom(seed * 9311 + 7)
    pool = _track(Pool(seed=seed, config=Config(**FAST)))
    edge = attach_edge(pool, name="liar-edge")
    user = Ed25519Signer(seed=(b"eliar%d" % seed).ljust(32, b"\0")[:32])
    assert _order_and_time(pool, signed_nym(pool.trustee, user, 1), 2) \
        is not None

    rejected: list = []
    driver = make_edge_driver(pool, edge, client="efuzz",
                              on_fail=rejected.append)
    # warm the cache HONESTLY first: the attack then mutates cached
    # bytes (a poisoned entry), not a mere forwarding proxy
    q0 = Request("efuzz", 50, {"type": GET_NYM, "dest": user.identifier})
    warm = driver.read(q0, per_node_s=2.0)
    assert warm is not None and driver.stats.edge_ok == 1, f"seed {seed}"

    def forge_value(result):
        env = result.get(READ_PROOF)
        if env and env.get("entries"):
            e = env["entries"][0]
            if e.get("value"):
                e["value"] = bytes(
                    reversed(bytes.fromhex(e["value"]))).hex()
        return result

    def forge_root(result):
        env = result.get(READ_PROOF)
        if env and env.get("root_hash"):
            env["root_hash"] = "ab" * 32
            env["result_digest"] = result_digest(result).hex()
        return result

    def tamper_data(result):
        if isinstance(result.get("data"), dict):
            result["data"] = dict(result["data"], verkey="EvilVerkey1111")
            env = result.get(READ_PROOF)
            if env:
                env["result_digest"] = result_digest(result).hex()
        return result

    def strip(result):
        result.pop(READ_PROOF, None)
        return result

    def deny(result):
        return None

    kinds = [("forge_value", forge_value), ("forge_root", forge_root),
             ("tamper_data", tamper_data), ("strip", strip),
             ("deny", deny)]
    kind, mutate = kinds[force_rung if force_rung is not None
                         else rng.integer(0, 4)]

    real_serve = edge.cache.serve

    def lying(request):
        res = real_serve(request)
        return mutate(copy.deepcopy(res)) if isinstance(res, dict) else res

    edge.cache.serve = lying

    q = Request("efuzz", 51, {"type": GET_NYM, "dest": user.identifier})
    t0 = pool.timer.get_current_time()
    res = driver.read(q, per_node_s=2.0)
    took = pool.timer.get_current_time() - t0
    deadline = 2.0 * (len(pool.names) + 1) + 1.0
    assert took <= deadline, \
        f"seed {seed}: {kind} read took {took:.1f}s > {deadline:.1f}s"
    s = driver.stats
    # the ONE invariant every rung shares: the lying edge never forges
    # an acceptance and never kills the read — a validator answers
    assert res is not None, f"seed {seed}: {kind} denied service for good"
    assert res["data"]["verkey"] == user.verkey_b58, \
        f"seed {seed}: {kind} FORGED an accepted read"
    assert s.edge_ok == 1 and s.fallbacks == 0, \
        f"seed {seed}: {kind} ({s.summary()})"
    if kind in ("forge_value", "forge_root", "tamper_data"):
        assert s.edge_verify_failures >= 1 and s.failovers >= 1, \
            f"seed {seed}: {kind} not rejected ({s.summary()})"
        assert rejected == [edge.name], f"seed {seed}"  # fleet was told
    elif kind == "strip":
        assert s.edge_escalations >= 1 and s.failovers >= 1, \
            f"seed {seed}: strip did not escalate ({s.summary()})"
        assert s.edge_verify_failures == 0, f"seed {seed}"
    else:                                   # deny
        assert s.timeouts >= 1 and s.failovers >= 1, \
            f"seed {seed}: deny did not fail over ({s.summary()})"
        assert s.edge_verify_failures == 0, f"seed {seed}"
    assert_safety(pool)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_lying_edge_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_lying_edge_scenario, seed)


def test_sim_lying_edge_smoke():
    """Two edge rungs always run in the default suite: the poisoned
    cached entry (forgery -> rejected + failover) and the denial rung
    (NACK -> timed-out rung + failover) — deny-but-never-forge in
    tier-1."""
    _run_with_artifacts(
        lambda s: run_lying_edge_scenario(s, force_rung=2), 2)
    _run_with_artifacts(
        lambda s: run_lying_edge_scenario(s, force_rung=4), 3)


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
def test_sim_device_flap_multidevice_fuzz(bucket):
    for seed in range(bucket * 3, bucket * 3 + 3):
        _run_with_artifacts(run_device_flap_multidevice, seed)


def test_sim_device_flap_multidevice_smoke():
    """One per-device device_flap scenario always runs in the default
    suite: the seed-targeted chip's lane breaker opens ALONE, the other
    lanes keep dispatching, and the lane re-warms and rejoins."""
    _run_with_artifacts(run_device_flap_multidevice, 2)


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


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_crypto_host_down_fuzz(bucket):
    for seed in range(bucket * 3, bucket * 3 + 3):
        _run_with_artifacts(run_crypto_host_down_scenario, seed)


def test_sim_crypto_host_down_smoke():
    """One crypto_host_down scenario always runs in the default suite:
    a rostered remote crypto host dies mid-consensus, only its lane's
    breaker opens, its queued waves steal back to local lanes (never
    double-verified), ordering holds the deadline budget, and the host
    re-warms and rejoins."""
    _run_with_artifacts(run_crypto_host_down_scenario, 2)


# 100 seeds, bucketed so failures show their seed range and xdist can split
@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(10))
def test_sim_view_change_fuzz(bucket):
    for seed in range(bucket * (N_SEEDS // 10),
                      (bucket + 1) * (N_SEEDS // 10)):
        _run_with_artifacts(run_scenario, seed)


def test_sim_fuzz_deep_window():
    """Existing scenario kinds under an AGGRESSIVELY deep pipeline:
    size-1 batches and a watermark-wide in-flight window keep many
    speculative uncommitted batches in flight straight through the fault,
    so revert-on-view-change and catchup re-staging run against a deep
    stack instead of the old 4-batch one. Seed 3 draws the primary
    blackout (partition of the primary), seed 4 the lossy network; plus
    one device_flap run with the crypto plane as the fault."""
    saved = dict(FAST)
    FAST.update(Max3PCBatchSize=1, Max3PCBatchesInFlight=300)
    try:
        _run_with_artifacts(run_scenario, 3)            # primary blackout
        _run_with_artifacts(run_scenario, 4)            # lossy network
        _run_with_artifacts(run_device_flap_scenario, 4)
    finally:
        FAST.clear()
        FAST.update(saved)


def test_sim_fuzz_smoke():
    """One scenario of each kind always runs in the default suite."""
    seen: set[int] = set()
    seed = 0
    while len(seen) < 6 and seed < 80:
        rng = SimRandom(seed * 7919 + 17)
        kind = rng.integer(0, 5)
        if kind not in seen:
            seen.add(kind)
            _run_with_artifacts(run_scenario, seed)
        seed += 1


def test_fuzz_failure_artifact_includes_all_rings(tmp_path):
    """The failure path itself: a failing rung must leave every node's
    flight-recorder ring on disk and name the artifact dir in the
    assertion (the acceptance shape for 'fuzz failures arrive with their
    last-seconds story')."""
    import glob
    import json
    import shutil

    def failing_scenario(seed):
        pool = _track(Pool(seed=seed, config=Config(**FAST)))
        user = Ed25519Signer(seed=b"artifact-user".ljust(32, b"\0")[:32])
        assert _order_and_time(pool, signed_nym(pool.trustee, user, 1), 2) \
            is not None
        raise AssertionError("synthetic rung failure")

    with pytest.raises(AssertionError) as exc:
        _run_with_artifacts(failing_scenario, 7)
    msg = str(exc.value)
    assert "flight-recorder rings of all nodes" in msg
    art_dir = msg.rsplit(": ", 1)[1].rstrip("]")
    try:
        dumps = sorted(glob.glob(art_dir + "/*-flight.json"))
        assert len(dumps) == 4, dumps          # one ring per node
        for path in dumps:
            with open(path) as fh:
                snap = json.load(fh)
            # the rings hold the pre-failure story: the ordered request's
            # span events are there
            stages = {e[1] for e in snap["events"]}
            assert "ordered" in stages and "reply" in stages, \
                (path, sorted(stages))
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)


# --- scenario kind `membership_churn`: the POOL ITSELF is the fault ---------
# Live membership operations mid-load — node add (a fresh joiner catching
# up to join), node remove (including the current primary -> forced view
# change), BLS key rotation (stale-key commits rejected, then recovery),
# primary demotion — over the topology-aware WAN fabric (geo3/lossy_wan
# presets), composable with device_flap and client_flood. Runs as its own
# seed sweep (widening run_scenario's draw would remap historical seeds).

CHURN_NAMES = ["Alpha", "Beta", "Gamma", "Delta", "Eps"]


def _order_on(pool, req, expect_size: float, nodes: list[str],
              timeout: float = 30.0, to=None):
    """Submit to live nodes and run until every node in `nodes` reaches
    expect_size; -> sim seconds, or None on deadline miss."""
    t0 = pool.timer.get_current_time()
    live = [n for n in (to or pool.names) if n in pool.nodes]
    pool.submit(req, to=live)
    elapsed = 0.0
    while elapsed < timeout:
        pool.run(0.5)
        elapsed += 0.5
        if all(n in pool.nodes
               and len(_domain_txns(pool.nodes[n])) >= expect_size
               for n in nodes):
            return pool.timer.get_current_time() - t0
    return None


def run_membership_churn_scenario(seed: int, force_rung=None,
                                  faulted_plane=None) -> None:
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.network import make_topology
    from test_torch_scale import signed_node_services

    rng = SimRandom(seed * 32452843 + 19)
    rung = rng.integer(0, 3) if force_rung is None else force_rung
    # the removed-primary rung ALWAYS runs under lossy_wan (the
    # acceptance profile); other rungs draw clean-vs-degraded WAN
    preset = "lossy_wan" if (rung == 2 or rng.integer(0, 1) == 0) \
        else "geo3"
    verifier = faulted_plane[0] if faulted_plane is not None else None
    # the join rung starts Eps demoted (it must catch up to join); every
    # OTHER rung runs all five as validators so a demotion/removal lands
    # at n=4, f=1 — removing a node from a 4-validator pool would leave
    # f=0, where ANY message loss is fatal and the rung stops measuring
    # churn and starts measuring luck
    pool = _track(Pool(names=CHURN_NAMES,
                       validator_names=CHURN_NAMES[:4] if rung == 0
                       else None,
                       seed=seed, config=Config(**FAST),
                       verifier=verifier))
    pool.net.set_topology(make_topology(preset, CHURN_NAMES))
    if faulted_plane is not None:
        sup, faulty = faulted_plane
        sup.set_clock(pool.timer.get_current_time)
        faulty.set_clock(pool.timer.get_current_time)

    users = [Ed25519Signer(seed=(b"mc%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(4)]
    reqs = [signed_nym(pool.trustee, u, i + 1) for i, u in enumerate(users)]
    validators = CHURN_NAMES[:4] if rung == 0 else list(CHURN_NAMES)
    # healthy baseline write under the drawn WAN profile
    assert _order_on(pool, reqs[0], 2, validators) is not None, \
        f"seed {seed}: healthy churn pool failed to order ({preset})"

    if faulted_plane is not None:
        # the crypto plane faults BEFORE the churn event: every auth /
        # commit verdict through the churn rides the supervisor's
        # breaker + hedged CPU fallback
        getattr(faulted_plane[1],
                ("wedge", "drop", "corrupt")[rng.integer(0, 2)])()

    req_id = 100
    if rung == 0:
        # NODE ADD: Eps restarts with no memory, catches up AS A
        # NON-VALIDATOR (the joiner bus filter), is promoted, and the
        # 5-node pool orders everywhere
        pool.crash_node("Eps")
        assert _order_on(pool, reqs[1], 3, validators) is not None, \
            f"seed {seed}: pool stalled while joiner was away"
        pool.start_node("Eps")
        pool.net.connect_all()
        eps = pool.nodes["Eps"]
        assert len(_domain_txns(eps)) == 1          # fresh from genesis
        eps.start_catchup()
        elapsed = 0.0
        while elapsed < 40.0 and (eps.leecher.is_running
                                  or len(_domain_txns(eps)) < 3):
            pool.run(0.5)
            elapsed += 0.5
        assert len(_domain_txns(eps)) >= 3, \
            f"seed {seed}: joiner catchup never completed ({preset})"
        pool.submit(signed_node_services(pool.trustee, "Eps",
                                         ["VALIDATOR"], req_id),
                    to=validators)
        pool.run(8.0)
        assert "Eps" in pool.nodes["Alpha"].validators, \
            f"seed {seed}: promotion never committed"
        expect = len(_domain_txns(pool.nodes["Alpha"])) + 1
        took = _order_on(pool, reqs[2], expect, CHURN_NAMES, timeout=40.0)
        if took is None:
            sizes = {n: len(_domain_txns(pool.nodes[n]))
                     for n in CHURN_NAMES}
            raise AssertionError(
                f"seed {seed}: post-join pool failed to order: {sizes}")
    elif rung == 1:
        # NODE REMOVE (non-primary): demote AND crash a non-primary
        # validator — the surviving 4 (f=1) keep ordering
        primary = pool.nodes["Alpha"].master_replica.data.primary_name
        victim = [n for n in validators if n != primary][rng.integer(0, 3)]
        pool.submit(signed_node_services(pool.trustee, victim, [],
                                         req_id),
                    to=[n for n in CHURN_NAMES if n in pool.nodes])
        pool.run(8.0)
        survivors = [n for n in CHURN_NAMES if n != victim]
        assert victim not in pool.nodes["Alpha"].validators, \
            f"seed {seed}: demotion never committed"
        pool.crash_node(victim)
        expect = len(_domain_txns(pool.nodes["Alpha"])) + 1
        assert _order_on(pool, reqs[2], expect, survivors,
                         timeout=40.0) is not None, \
            f"seed {seed}: pool stalled after node removal ({preset})"
    elif rung == 2:
        # REMOVE THE PRIMARY (demotion mid-load) under lossy_wan: the
        # pool must complete a FORCED view change and order new writes
        # within the rung deadline
        primary = pool.nodes["Alpha"].master_replica.data.primary_name
        view0 = pool.nodes["Alpha"].master_replica.view_no
        pool.submit(signed_node_services(pool.trustee, primary, [],
                                         req_id),
                    to=validators)
        survivors = [n for n in validators if n != primary]
        expect = len(_domain_txns(pool.nodes["Alpha"])) + 1
        took = _order_on(pool, reqs[2], expect, survivors, timeout=50.0)
        assert took is not None, \
            f"seed {seed}: no ordering after primary demotion (lossy_wan)"
        for n in survivors:
            node = pool.nodes[n]
            assert primary not in node.validators, \
                f"seed {seed}: {n} kept the demoted primary"
            assert node.master_replica.view_no > view0, \
                f"seed {seed}: {n} never completed the forced view change"
    else:
        # BLS KEY ROTATION: ledger key rotates, the node's signer stays
        # stale (its commits must be rejected WITHOUT poisoning the
        # batch check), then the operator re-keys and the node rejoins
        # aggregates
        primary = pool.nodes["Alpha"].master_replica.data.primary_name
        victim = [n for n in validators if n != primary][rng.integer(0, 3)]
        old_pk = BlsCryptoSigner(
            seed=victim.encode().ljust(32, b"\0")[:32]).pk
        new_signer = BlsCryptoSigner(
            seed=(b"mc-rot%d-%s" % (seed, victim.encode()))
            .ljust(32, b"\0")[:32])
        req = Request(pool.trustee.identifier, req_id,
                      {"type": txn_lib.NODE, "dest": f"{victim}Dest",
                       "data": {"blskey": new_signer.pk,
                                "blskey_pop": new_signer.generate_pop()}})
        req.signature = pool.trustee.sign_b58(req.signing_bytes())
        pool.submit(req, to=validators)
        elapsed = 0.0      # NODE txns land on the POOL ledger: wait on
        while elapsed < 30.0:   # the registry, not the domain size
            pool.run(0.5)
            elapsed += 0.5
            if all(pool.nodes[n].pool_manager.bls_key_of(victim)
                   == new_signer.pk for n in validators):
                break
        else:
            raise AssertionError(
                f"seed {seed}: rotation txn never committed")
        # stale window: the pool keeps ordering, aggregates EXCLUDE the
        # stale signer, no view change storms
        expect = len(_domain_txns(pool.nodes["Alpha"])) + 1
        assert _order_on(pool, reqs[2], expect, validators,
                         timeout=40.0) is not None, \
            f"seed {seed}: pool stalled during stale-key window"
        for n in validators:
            node = pool.nodes[n]
            assert node.pool_manager.bls_key_of(victim) == new_signer.pk
            assert old_pk not in \
                node.replicas.master.bls._verifier._vk_cache, \
                f"seed {seed}: {n} kept the rotated-out key warm"
            if n != victim:
                recent = list(node.replicas.master.bls
                              ._recent_multi_sigs.values())
                assert recent and victim not in recent[-1].participants, \
                    f"seed {seed}: stale-key sig counted at {n}"
        # recovery: re-key, fresh aggregates include the victim again
        pool.nodes[victim].replicas.master.bls._signer = new_signer
        expect += 1
        assert _order_on(pool, reqs[3], expect, validators,
                         timeout=40.0) is not None, \
            f"seed {seed}: pool stalled after re-key"
        recent = list(pool.nodes["Alpha"].replicas.master.bls
                      ._recent_multi_sigs.values())
        assert any(victim in m.participants for m in recent[-2:]), \
            f"seed {seed}: re-keyed node never rejoined aggregates"

    if faulted_plane is not None:
        from plenum_tpu_torch.parallel.supervisor import CLOSED
        sup, faulty = faulted_plane
        st = sup.supervisor_stats()
        assert st["fallback_batches"] >= 1, \
            f"seed {seed}: churn under crypto fault never took CPU fallback"
        faulty.heal()
        waited = 0.0
        while sup.breaker.state != CLOSED and waited < 30.0:
            pool.run(1.0)
            waited += 1.0
            sup.verify_batch([(b"mc-heal-%d-%f" % (seed, waited),
                               b"\0" * 64, b"\0" * 32)])
        assert sup.breaker.state == CLOSED, \
            f"seed {seed}: breaker never re-closed after churn+fault"
        assert sup.stats["verdict_forks"] == 0
    assert_safety(pool)


def run_membership_churn_with_device_flap(seed: int) -> None:
    """membership_churn composed with device_flap: the shared supervised
    crypto plane is faulted before the churn event, so the whole churn —
    catchup, promotion/demotion commits, the forced view change — rides
    hedged CPU-fallback verdicts, then the plane heals and re-admits."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 86028121 + 5)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2,
                               cooldown=rng.float(0.5, 1.5)),
        budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                              warm_max=1.0, cold_max=1.0))
    run_membership_churn_scenario(seed, faulted_plane=(sup, faulty))


def run_membership_churn_with_client_flood(seed: int) -> None:
    """membership_churn composed with client_flood: hot clients burst
    through per-node ingress planes while the CURRENT PRIMARY is demoted
    — the forced view change completes, the honest steady client's write
    still orders, and every over-cap burst write is shed EXPLICITLY."""
    from plenum_tpu_torch.client.sim_clients import burst_writes
    from plenum_tpu_torch.common.node_messages import LoadShed
    from plenum_tpu_torch.ingress import IngressPlane
    from plenum_tpu_torch.network import make_topology
    from test_torch_scale import signed_node_services

    rng = SimRandom(seed * 49979687 + 3)
    cap = rng.integer(2, 5)
    config = Config(**FAST, INGRESS_CLIENT_QUEUE_CAP=cap,
                    INGRESS_SLO_P95=0.3, INGRESS_CONTROL_INTERVAL=0.5)
    # five validators: demoting the primary leaves n=4 (f=1) — see the
    # base scenario's note on why removal at n=4 would measure luck
    pool = _track(Pool(names=CHURN_NAMES, seed=seed, config=config))
    pool.net.set_topology(make_topology("lossy_wan", pool.names))
    ingress = {n: IngressPlane(pool.nodes[n]) for n in pool.names}

    users = [Ed25519Signer(seed=(b"mcf%d-%d" % (seed, i))
                           .ljust(32, b"\0")[:32]) for i in range(2)]
    honest = [signed_nym(pool.trustee, u, i + 1)
              for i, u in enumerate(users)]
    pre = _ingress_order_and_time(pool, ingress, honest[0], 2,
                                  timeout=30.0)
    assert pre is not None, f"seed {seed}: healthy flood pool stalled"

    # flood + primary demotion land together
    n_hot = rng.integer(6, 16)
    per_client = cap + rng.integer(3, 6)
    burst = burst_writes(pool.trustee, n_hot, per_client, seed=seed)
    for client, req in burst:
        for n in pool.names:
            ingress[n].submit(req.to_dict(), client)
    primary = pool.nodes["Alpha"].master_replica.data.primary_name
    view0 = pool.nodes["Alpha"].master_replica.view_no
    pool.submit(signed_node_services(pool.trustee, primary, [], 400))
    during = _ingress_order_and_time(
        pool, ingress, honest[1],
        len(_domain_txns(pool.nodes[pool.names[0]])) + 1, timeout=60.0)
    assert during is not None, \
        f"seed {seed}: honest client starved during flood+demotion"
    survivors = [n for n in pool.names if n != primary]
    for n in survivors:
        assert pool.nodes[n].master_replica.view_no > view0, \
            f"seed {seed}: {n} never view-changed under flood"
        sheds = [m for m, _ in pool.client_msgs[n]
                 if isinstance(m, LoadShed)]
        assert len(sheds) >= n_hot * (per_client - cap), \
            f"seed {seed}: sheds silent at {n}"
    assert_safety(pool)


MEMBERSHIP_CHURN_SEEDS = 20


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_membership_churn_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_membership_churn_scenario, seed)


def test_sim_membership_churn_smoke():
    """Two rungs always run in the default suite: the acceptance rung —
    the CURRENT PRIMARY demoted under lossy_wan, forced view change
    completing within deadline — and the key-rotation rung (stale-key
    commits rejected, then recovery)."""
    _run_with_artifacts(
        lambda seed: run_membership_churn_scenario(seed, force_rung=2), 1)
    _run_with_artifacts(
        lambda seed: run_membership_churn_scenario(seed, force_rung=3), 2)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_membership_churn_device_flap_fuzz(bucket):
    for seed in range(bucket * 3, (bucket + 1) * 3):
        _run_with_artifacts(run_membership_churn_with_device_flap, seed)


def test_sim_membership_churn_device_flap_smoke():
    _run_with_artifacts(run_membership_churn_with_device_flap, 2)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_membership_churn_client_flood_fuzz(bucket):
    for seed in range(bucket * 2, (bucket + 1) * 2):
        _run_with_artifacts(run_membership_churn_with_client_flood, seed)


def test_sim_membership_churn_client_flood_smoke():
    _run_with_artifacts(run_membership_churn_with_client_flood, 1)


def _fabric_outcome(fab) -> dict:
    """Every live shard node's ordered txns and root, the mapping root
    and epoch, and the autopilot's control-ledger records."""
    ap = getattr(fab, "autopilot", None)
    return {"nodes": _outcome(fab), "map": (fab.mapping.root_hex,
                                            fab.mapping.epoch),
            "control": ap.ledger.to_dicts() if ap is not None else None}


def _held_smoke(scenario, seed: int, **kw) -> None:
    """A fabric smoke call, then the same call on the reference's suite:
    every shard node ordered the same txns to the same root as the
    reference's node of that name, under the same mapping root, and the
    autopilot wrote the same control-ledger records."""
    import test_sim_fuzz as ref_fuzz
    from test_torch_pool import fresh_bls_caches
    ours = []

    def run(s):
        scenario(s, **kw)
        ours.append(_fabric_outcome(_SCENARIO_POOLS[0]))

    with fresh_bls_caches():
        _run_with_artifacts(run, seed)
        getattr(ref_fuzz, scenario.__name__)(seed, **kw)
        theirs = _fabric_outcome(ref_fuzz._SCENARIO_POOLS[0])
    assert ours == [theirs]


# --- scenario kind `cross_shard`: the SHARD BOUNDARY is under attack --------
# Over the 2-shard ShardedSimFabric (plenum_tpu_torch/shards/): tamper rungs —
# a forged mapping proof, a wrong-shard answer, a stale map served after
# a resharding — must every one fail CLOSED at the composed cross-shard
# check; confinement rungs — a partition or a device_flap landing on ONE
# shard — must never stall the other shard's ordering or its verified
# cross-shard reads. Runs as its own seed sweep (the existing kinds keep
# their historical seeds).


def _shard_sizes(shard, names=None) -> set[int]:
    return {shard.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
            for n in (names or shard.names)}


def _fab_order_and_time(fab, shard, req, expect: int, names=None,
                        timeout: float = 25.0):
    """Route through the fabric and run until every node in `names` of
    `shard` reaches ledger size `expect`; -> sim seconds, or None."""
    t0 = fab.timer.get_current_time()
    assert fab.submit_write(req) == shard.shard_id
    elapsed = 0.0
    while elapsed < timeout:
        fab.run(0.5)
        elapsed += 0.5
        if _shard_sizes(shard, names) == {expect}:
            return fab.timer.get_current_time() - t0
    return None


def run_cross_shard_fuzz_scenario(seed: int, force_rung=None) -> None:
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.shards import (MappingLedger, ShardDescriptor,
                                   ShardReadGate, ShardedSimFabric)
    from plenum_tpu_torch.shards.mapping import directory_bls_signers
    from test_torch_shards import LyingGate, signed_write, user_on_shard

    rng = SimRandom(seed * 15485863 + 29)
    rung = rng.integer(0, 4) if force_rung is None else force_rung

    sup = faulty = None
    shard_verifiers = None
    flap_sid = rng.integer(0, 1)
    if rung == 4:
        # the crypto plane of ONE shard is the fault: that shard's four
        # nodes share a supervised faulty device, the other shard's
        # plane is untouched
        from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
        from plenum_tpu_torch.parallel.faults import FaultyVerifier
        from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                    DeadlineBudget,
                                                    SupervisedVerifier)
        faulty = FaultyVerifier(CpuEd25519Verifier())
        sup = SupervisedVerifier(
            faulty, fallback=CpuEd25519Verifier(),
            breaker=CircuitBreaker(fail_threshold=2,
                                   cooldown=rng.float(0.5, 1.5)),
            budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                                  warm_max=1.0, cold_max=1.0))
        shard_verifiers = {flap_sid: sup}

    fab = _track(ShardedSimFabric(n_shards=2, nodes_per_shard=4, seed=seed,
                                  config=Config(**FAST),
                                  shard_verifiers=shard_verifiers))
    if sup is not None:
        sup.set_clock(fab.timer.get_current_time)
        faulty.set_clock(fab.timer.get_current_time)

    # seed one owned write per shard; both shards order independently
    users = {sid: user_on_shard(fab, sid, b"xsf%d-" % seed)
             for sid in fab.shards}
    for req_id, (sid, u) in enumerate(sorted(users.items()), start=1):
        assert fab.submit_write(signed_write(fab, u, req_id)) == sid
    elapsed = 0.0
    while elapsed < 25.0 and any(_shard_sizes(s) != {2}
                                 for s in fab.shards.values()):
        fab.run(0.5)
        elapsed += 0.5
    for sid, shard in fab.shards.items():
        assert _shard_sizes(shard) == {2}, \
            f"seed {seed}: shard {sid} never ordered its seed write"

    victim_sid = rng.integer(0, 1)       # the shard the tamper targets
    victim = users[victim_sid]
    q = Request("xsf", 50, {"type": GET_NYM, "dest": victim.identifier})

    if rung == 0:
        # FORGED MAPPING PROOF: every node of the owning shard cites a
        # map signed by a non-directory committee — each ladder rung must
        # reject fail-closed; after the gate heals, the SAME driver
        # verifies again
        evil = MappingLedger(
            [ShardDescriptor.from_dict(d.to_dict())
             for d in fab.mapping.descriptors],
            directory_bls_signers([f"Ev{i}-{seed}" for i in range(4)]),
            now=fab.timer.get_current_time)

        def forge(result, key):
            result["shard_proof"] = evil.ownership_proof(key)
            return result

        fab.gates[victim_sid] = LyingGate(fab.gates[victim_sid], forge)
        driver = fab.read_driver()
        res = driver.read(q, per_node_s=1.0, step_s=0.1)
        s = driver.stats.summary()
        assert res is None and s["fallbacks"] == 1, \
            f"seed {seed}: forged map accepted ({s})"
        assert s["map_proof_failures"] >= 1 and \
            s["map_failure_reasons"].get("bad_map_multi_sig", 0) >= 1, \
            f"seed {seed}: wrong rejection reason ({s})"
        fab.gates[victim_sid] = fab.gates[victim_sid].inner
        res = driver.read(Request("xsf", 51, dict(q.operation)),
                          per_node_s=2.0, step_s=0.1)
        assert res is not None and \
            res["data"]["verkey"] == victim.verkey_b58, \
            f"seed {seed}: healed gate still rejected"
    elif rung == 1:
        # WRONG-SHARD ANSWER: a foreign-shard node serves a valid-looking
        # absence envelope against ITS root — the composed check rejects
        # it and the ladder fails over INTO the owning shard
        other_sid = 1 - victim_sid
        wrong = fab.shards[other_sid].names[rng.integer(0, 3)]
        driver = fab.read_driver()
        res = driver.read(q, per_node_s=2.0, step_s=0.1,
                          order=[wrong] + list(fab.shards[victim_sid].names))
        s = driver.stats.summary()
        assert res is not None and \
            res["data"]["verkey"] == victim.verkey_b58, \
            f"seed {seed}: wrong-shard ladder never recovered ({s})"
        assert s["verify_failures"] >= 1 and s["failovers"] >= 1 and \
            s["fallbacks"] == 0, f"seed {seed}: wrong-shard accepted ({s})"
    elif rung == 2:
        # STALE MAP AFTER RESHARDING: the owning shard's gate keeps
        # serving the epoch-0 map after the directory publishes epoch 1 —
        # a client whose view saw epoch 1 must fail closed, then verify
        # once the gate refreshes
        stale_ml = MappingLedger(
            [ShardDescriptor.from_dict(d.to_dict())
             for d in fab.mapping.descriptors],
            fab.directory, now=fab.timer.get_current_time)
        fab.gates[victim_sid] = ShardReadGate(stale_ml)
        fab.mapping.reshard([ShardDescriptor.from_dict(d.to_dict())
                             for d in fab.mapping.descriptors])
        driver = fab.read_driver()           # view is at epoch 1
        res = driver.read(q, per_node_s=1.0, step_s=0.1)
        s = driver.stats.summary()
        assert res is None and s["fallbacks"] == 1, \
            f"seed {seed}: stale map accepted ({s})"
        assert s["map_failure_reasons"].get("stale_map", 0) >= 1, \
            f"seed {seed}: wrong stale rejection ({s})"
        fab.gates[victim_sid] = ShardReadGate(fab.mapping)
        res = driver.read(Request("xsf", 52, dict(q.operation)),
                          per_node_s=2.0, step_s=0.1)
        assert res is not None, f"seed {seed}: refreshed gate rejected"
    elif rung == 3:
        # PARTITION CONFINED TO ONE SHARD: blackout the victim shard's
        # primary on ITS OWN SimNetwork; the other shard must keep
        # ordering within its healthy latency AND keep answering verified
        # cross-shard reads while the victim is mid-view-change; the
        # victim's survivors then view-change and recover on their own
        other_sid = 1 - victim_sid
        vshard, oshard = fab.shards[victim_sid], fab.shards[other_sid]
        primary = vshard.nodes[vshard.names[0]] \
            .master_replica.data.primary_name
        vshard.net.add_rule(Discard(), match_dst(primary))
        vshard.net.add_rule(Discard(), match_frm(primary))
        survivors = [n for n in vshard.names if n != primary]
        # a write pending on the victim shard across its view change
        pend = user_on_shard(fab, victim_sid, b"pend%d-" % seed)
        fab.router.route(signed_write(fab, pend, 60), "xsf")
        # ...must not slow the OTHER shard below healthy ordering
        u2 = user_on_shard(fab, other_sid, b"live%d-" % seed, start=50)
        took = _fab_order_and_time(fab, oshard, signed_write(fab, u2, 61),
                                   3, timeout=10.0)
        assert took is not None, \
            f"seed {seed}: healthy shard stalled by foreign partition"
        driver = fab.read_driver()
        q2 = Request("xsf", 62, {"type": GET_NYM,
                                 "dest": users[other_sid].identifier})
        res = driver.read(q2, per_node_s=2.0, step_s=0.1)
        assert res is not None and driver.stats.summary()["fallbacks"] == 0, \
            f"seed {seed}: cross-shard read starved by foreign partition"
        fab.run(25.0)                        # victim view-changes and heals
        for n in survivors:
            assert vshard.nodes[n].master_replica.view_no >= 1, \
                f"seed {seed}: {n} stuck in view 0 behind the partition"
        assert _shard_sizes(vshard, survivors) == {3}, \
            f"seed {seed}: victim survivors lost the pending write"
    else:
        # DEVICE_FLAP CONFINED TO ONE SHARD: wedge/drop/corrupt the
        # faulted shard's shared device MID-TRAFFIC; that shard degrades
        # to hedged CPU fallback and keeps ordering, the OTHER shard's
        # plane never even notices; heal re-closes the breaker
        kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
        assert sup.stats["device_batches"] >= 1, \
            f"seed {seed}: seed traffic never hit the faulted shard device"
        getattr(faulty, kind)()
        fshard = fab.shards[flap_sid]
        oshard = fab.shards[1 - flap_sid]
        uf = user_on_shard(fab, flap_sid, b"flap%d-" % seed, start=100)
        uo = user_on_shard(fab, 1 - flap_sid, b"calm%d-" % seed, start=100)
        t_other = _fab_order_and_time(fab, oshard,
                                      signed_write(fab, uo, 70), 3,
                                      timeout=10.0)
        assert t_other is not None, \
            f"seed {seed}: un-faulted shard stalled by foreign {kind}"
        t_fault = _fab_order_and_time(fab, fshard,
                                      signed_write(fab, uf, 71), 3)
        assert t_fault is not None, \
            f"seed {seed}: faulted shard stopped ordering under {kind}"
        st = sup.supervisor_stats()
        assert st["fallback_batches"] >= 1, \
            f"seed {seed}: no CPU fallback under {kind}"
        assert st["max_stall_s"] <= st["max_budget_s"] + 0.3, \
            f"seed {seed}: stall past deadline budget"
        from plenum_tpu_torch.parallel.supervisor import CLOSED
        faulty.heal()
        waited = 0.0
        while sup.breaker.state != CLOSED and waited < 30.0:
            fab.run(1.0)
            waited += 1.0
            sup.verify_batch([(b"xsf-heal-%d-%f" % (seed, waited),
                               b"\0" * 64, b"\0" * 32)])
        assert sup.breaker.state == CLOSED, \
            f"seed {seed}: shard breaker never re-closed after {kind}"
        assert sup.stats["verdict_forks"] == 0

    for shard in fab.shards.values():        # no fork inside any shard
        assert_safety(shard)


CROSS_SHARD_SEEDS = 20


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_cross_shard_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_cross_shard_fuzz_scenario, seed)


def test_sim_cross_shard_smoke():
    """Two rungs always run in the default suite: one tamper rung (the
    forged mapping proof, failing closed end to end) and one confinement
    rung (a partition landing on one shard leaving the other's ordering
    and cross-shard reads untouched)."""
    _held_smoke(run_cross_shard_fuzz_scenario, 1, force_rung=0)
    _held_smoke(run_cross_shard_fuzz_scenario, 2, force_rung=3)


# --- scenario kind `reshard`: the SHARD MAP ITSELF is in motion -------------
# Live split/merge (shards/reshard.py) and proof-carrying cross-shard
# writes (shards/cross_write.py) under fire: every admitted write across
# a migration must be ordered EXACTLY ONCE (no drop, no duplicate),
# every stale-epoch or partitioned cross-shard write must fail closed
# with ZERO half-commits, and a coordinator crash between prepare and
# commit must never lose atomicity. Composes with partition (rung 2),
# the ratchet race (rung 3), the 2PC fault matrix (rungs 4/5), and
# device_flap / client_flood via the run_reshard_with_* runners.


def _reshard_fabric(seed: int, shard_verifiers=None):
    from plenum_tpu_torch.shards import ShardedSimFabric
    return _track(ShardedSimFabric(
        n_shards=2, nodes_per_shard=4, seed=seed, config=Config(**FAST),
        shard_verifiers=shard_verifiers))


def _drive_migration(fab, m, timeout: float = 90.0) -> None:
    elapsed = 0.0
    while elapsed < timeout and m.phase not in ("done", "aborted"):
        fab.run(0.5)
        elapsed += 0.5


def _owner_sid(fab, req) -> int:
    return fab.router.shard_of(req)


def _assert_exactly_once(fab, seed: int, writes) -> None:
    """Every admitted write is ordered exactly once at its CURRENT
    owner (post-migration map), and nowhere gains a duplicate."""
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NYM
    ledger_dests: dict[int, list] = {}
    for sid, shard in fab.shards.items():
        node = next(iter(shard.nodes.values()))
        ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
        # NYM creations only: 2PC records are ATTRIBs that legitimately
        # repeat their shard's anchor DID
        ledger_dests[sid] = [
            txn_lib.txn_data(ledger.get_by_seq_no(i)).get("dest")
            for i in range(2, ledger.size + 1)
            if txn_lib.txn_type_of(ledger.get_by_seq_no(i)) == NYM]
    for sid, dests in ledger_dests.items():
        dup = [d for d in set(dests) if dests.count(d) > 1]
        assert not dup, f"seed {seed}: duplicates on shard {sid}: {dup}"
    for user, req in writes:
        owner = _owner_sid(fab, req)
        assert owner is not None, f"seed {seed}: write lost from the map"
        assert user.identifier in ledger_dests[owner], \
            (f"seed {seed}: write {user.identifier[:8]} missing at its "
             f"owner {owner} ({ {s: len(d) for s, d in ledger_dests.items()} })")


def run_reshard_fuzz_scenario(seed: int, force_rung=None,
                              faulted_plane=None) -> None:
    from plenum_tpu_torch.execution.txn import GET_NYM
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 49979693 + 41)
    rung = rng.integer(0, 5) if force_rung is None else force_rung

    shard_verifiers = None
    if faulted_plane is not None:
        shard_verifiers = {0: faulted_plane[0]}   # the SOURCE shard's plane
    fab = _reshard_fabric(seed, shard_verifiers=shard_verifiers)
    if faulted_plane is not None:
        sup, faulty = faulted_plane
        sup.set_clock(fab.timer.get_current_time)
        faulty.set_clock(fab.timer.get_current_time)

    # zipfian-shaped seed load: most writes key into shard 0 (the hot
    # range a split relieves), a trickle into shard 1
    writes = []
    rid = 0
    n_hot = 4 + rng.integer(0, 2)
    for k in range(n_hot):
        u = user_on_shard(fab, 0, b"rs%d-" % seed, start=k * 17)
        rid += 1
        writes.append((u, signed_write(fab, u, rid)))
    u_cold = user_on_shard(fab, 1, b"rc%d-" % seed)
    rid += 1
    writes.append((u_cold, signed_write(fab, u_cold, rid)))
    for _u, req in writes:
        assert fab.submit_write(req) is not None
    elapsed = 0.0
    while elapsed < 30.0 and any(
            s.ordered_count() < 1 for s in fab.shards.values()):
        fab.run(0.5)
        elapsed += 0.5
    assert fab.shards[0].ordered_count() >= n_hot, \
        f"seed {seed}: hot shard never ordered its seed load"

    if faulted_plane is not None:
        # the source shard's crypto plane faults BEFORE the split: the
        # whole migration (copy replays, handoff) rides the supervisor's
        # breaker + hedged CPU fallback
        getattr(faulted_plane[1],
                ("wedge", "drop", "corrupt")[rng.integer(0, 2)])()

    if rung == 0:
        # HEALTHY SPLIT UNDER TRAFFIC: the hot range splits onto a new
        # sub-pool while writes keep flowing; exactly-once everywhere,
        # epoch ratchets, a stale-view reader refreshes instead of
        # erroring
        stale_driver = fab.read_driver()          # view predates the split
        m = fab.reshard.split(0)
        for k in range(3):                        # mid-migration traffic
            u = user_on_shard(fab, 0, b"rm%d-" % seed, start=k * 23)
            rid += 1
            req = signed_write(fab, u, rid)
            writes.append((u, req))
            assert fab.submit_write(req) is not None
        _drive_migration(fab, m)
        assert m.phase == "done", \
            f"seed {seed}: migration stuck: {m.to_dict()}"
        assert fab.mapping.epoch == 1 and len(fab.shards) == 3
        _assert_exactly_once(fab, seed, writes)
        moved = next((u for u, req in writes if _owner_sid(fab, req) == 2),
                     None)
        assert moved is not None, f"seed {seed}: split moved nothing"
        q = Request("rr", 900, {"type": GET_NYM, "dest": moved.identifier})
        res = stale_driver.read(q, per_node_s=1.5, step_s=0.1)
        s = stale_driver.stats.summary()
        assert res is not None and \
            res["data"]["verkey"] == moved.verkey_b58, \
            f"seed {seed}: stale-view read errored during healthy reshard {s}"
        assert s.get("map_retries", 0) == 1 and s["fallbacks"] == 0, s
    elif rung == 1:
        # LIVE MERGE: shard 1's whole range folds into shard 0 under
        # traffic; the source retires, its data verifies at the survivor
        m = fab.reshard.merge(1, 0)
        _drive_migration(fab, m)
        assert m.phase == "done", \
            f"seed {seed}: merge stuck: {m.to_dict()}"
        assert fab.mapping.epoch == 1 and sorted(fab.shards) == [0]
        _assert_exactly_once(fab, seed, writes)
        driver = fab.read_driver()
        q = Request("rr", 901, {"type": GET_NYM,
                                "dest": u_cold.identifier})
        res = driver.read(q, per_node_s=2.0, step_s=0.1)
        assert res is not None and \
            res["data"]["verkey"] == u_cold.verkey_b58, \
            f"seed {seed}: merged-away data unreadable at the survivor"
        assert not any(n.startswith("S1N") for n in fab.aggregator.latest)
    elif rung == 2:
        # RESHARD MID-PARTITION: the split target's primary is cut off
        # mid-copy — the migration must NOT ratchet while the copy
        # cannot complete (source keeps ownership, no write lost), then
        # complete after the heal + the target's own view change
        m = fab.reshard.split(0)
        tshard = fab.shards[m.target]
        primary = tshard.nodes[tshard.names[0]] \
            .master_replica.data.primary_name
        rules = [tshard.net.add_rule(Discard(), match_dst(primary)),
                 tshard.net.add_rule(Discard(), match_frm(primary))]
        fab.run(rng.float(3.0, 6.0))
        # the fail-closed coupling: the epoch ratchets IFF the copy
        # completed (the target's survivors may legitimately view-change
        # around their cut primary and finish early — but a ratchet with
        # the copy incomplete would be data loss)
        assert (fab.mapping.epoch == 0) == (m.phase == "copying"), \
            f"seed {seed}: ratchet/copy desync: epoch=" \
            f"{fab.mapping.epoch} phase={m.phase}"
        if m.phase == "copying":
            assert not m.pending or fab.mapping.epoch == 0
        # writes during the (possibly stalled) migration are never lost
        u = user_on_shard(fab, 0, b"rp%d-" % seed, start=31)
        rid += 1
        req = signed_write(fab, u, rid)
        writes.append((u, req))
        assert fab.submit_write(req) is not None
        for r in rules:
            tshard.net.remove_rule(r)
        _drive_migration(fab, m, timeout=120.0)
        assert m.phase == "done", \
            f"seed {seed}: migration never recovered from the partition " \
            f"({m.to_dict()})"
        _assert_exactly_once(fab, seed, writes)
    elif rung == 3:
        # STALE-EPOCH WRITES RACING THE RATCHET: a write landing at the
        # OLD owner inside the handoff window is forwarded and ordered
        # exactly once at the NEW owner; past the window it fails closed
        # (explicit NACK, ordered NOWHERE)
        m = fab.reshard.split(0)
        while m.phase == "copying":
            fab.run(0.5)
        assert m.phase == "handoff"
        stale_sink = fab.router.sinks[0]
        mover = user_on_shard(fab, 2, b"rw%d-" % seed)
        rid += 1
        req = signed_write(fab, mover, rid)
        writes.append((mover, req))
        before = fab.shards[2].ordered_count()
        stale_sink(req, "stale-client")
        elapsed = 0.0
        while elapsed < 30.0 and fab.shards[2].ordered_count() <= before:
            fab.run(0.5)
            elapsed += 0.5
        assert fab.shards[2].ordered_count() == before + 1, \
            f"seed {seed}: in-window stale write dropped"
        assert m.forwarded >= 1 and not fab.stale_nacks
        # run out the window (+ drain grace), then race again: fail closed
        fab.run(fab.config.RESHARD_HANDOFF_WINDOW * 3 + 5.0)
        late_u = user_on_shard(fab, 2, b"rw%d-" % seed, start=60)
        rid += 1
        late = signed_write(fab, late_u, rid)
        c0, c2 = fab.shards[0].ordered_count(), fab.shards[2].ordered_count()
        stale_sink(late, "stale-client")
        fab.run(5.0)
        assert fab.stale_nacks, f"seed {seed}: late stale write not NACKed"
        assert fab.shards[0].ordered_count() == c0 and \
            fab.shards[2].ordered_count() == c2, \
            f"seed {seed}: post-window stale write ordered somewhere"
        _assert_exactly_once(fab, seed, writes)
    elif rung == 4:
        # 2PC COORDINATOR CRASH between prepare and commit: the
        # participant's lock TTL resolves via the anchored decision read
        # (proven absence -> abort), ledger recovery orders the abort —
        # and a later transaction over the same dependency commits
        import json as _json
        from plenum_tpu_torch.execution.txn import ATTRIB, NYM
        xsw = fab.cross_writes()
        home = user_on_shard(fab, 0, b"xh%d-" % seed, start=80)
        txid = xsw.begin(
            0, 1, {"type": NYM, "dest": home.identifier,
                   "verkey": home.verkey_b58},
            {"type": GET_NYM, "dest": u_cold.identifier},
            {"type": ATTRIB, "dest": u_cold.identifier,
             "raw": _json.dumps({"linked": home.identifier})})
        assert xsw.step(txid) == "prepared"
        crash_after_lock = rng.integer(0, 1) == 1
        if crash_after_lock:
            assert xsw.step(txid) == "locked"
        fab.run(25.0)                  # crash; TTLs expire
        rec = xsw.recover_from_ledger(0)
        assert txid in rec["aborted"], f"seed {seed}: {rec}"
        xsw.participant(1).service()
        assert xsw.participant(1).locks == {}, \
            f"seed {seed}: orphan lock survived the crash"
        records = xsw._scan_records(0)
        assert records[txid]["decision"]["decision"] == "abort"
        # atomicity: NEITHER half applied
        node0 = next(iter(fab.shards[0].nodes.values()))
        from plenum_tpu_torch.execution import txn as txn_lib
        ledger0 = node0.c.db.get_ledger(DOMAIN_LEDGER_ID)
        assert not any(
            txn_lib.txn_data(ledger0.get_by_seq_no(i)).get("dest")
            == home.identifier for i in range(2, ledger0.size + 1)), \
            f"seed {seed}: half-commit at home after crash"
        # the dependency is free again: a retry commits cleanly
        home2 = user_on_shard(fab, 0, b"xh%d-" % seed, start=120)
        txid2 = xsw.begin(
            0, 1, {"type": NYM, "dest": home2.identifier,
                   "verkey": home2.verkey_b58},
            {"type": GET_NYM, "dest": u_cold.identifier})
        assert xsw.drive(txid2) == "committed", \
            f"seed {seed}: retry after crash-abort failed"
    else:
        # 2PC RACING THE RATCHET: a LIVE SPLIT of the coordinator's own
        # shard lands between lock and commit — the transaction must
        # abort fail-closed (epoch changed), with zero half-commits,
        # while the migration itself completes
        from plenum_tpu_torch.execution.txn import NYM
        xsw = fab.cross_writes()
        xsw._anchor(0)                 # anchors ordered pre-migration
        xsw._anchor(1)
        home = user_on_shard(fab, 0, b"xr%d-" % seed, start=80)
        txid = xsw.begin(
            0, 1, {"type": NYM, "dest": home.identifier,
                   "verkey": home.verkey_b58},
            {"type": GET_NYM, "dest": u_cold.identifier})
        assert xsw.step(txid) == "prepared"
        assert xsw.step(txid) == "locked"
        m = fab.reshard.split(0)       # the map moves under the 2PC
        _drive_migration(fab, m)
        assert m.phase == "done" and fab.mapping.epoch == 1
        assert xsw.step(txid) == "aborted"
        assert xsw.txs[txid].abort_reason == "epoch_changed", \
            f"seed {seed}: {xsw.txs[txid].abort_reason}"
        assert xsw.participant(1).locks == {}
        node0 = next(iter(fab.shards[0].nodes.values()))
        from plenum_tpu_torch.execution import txn as txn_lib
        ledger0 = node0.c.db.get_ledger(DOMAIN_LEDGER_ID)
        assert not any(
            txn_lib.txn_data(ledger0.get_by_seq_no(i)).get("dest")
            == home.identifier for i in range(2, ledger0.size + 1)), \
            f"seed {seed}: half-commit despite the epoch ratchet"
        _assert_exactly_once(fab, seed, writes)

    if faulted_plane is not None:
        sup, faulty = faulted_plane
        st = sup.supervisor_stats()
        assert st["fallback_batches"] >= 1, \
            f"seed {seed}: reshard under crypto fault never took fallback"
        assert sup.stats["verdict_forks"] == 0

    for shard in fab.shards.values():
        assert_safety(shard)


def run_reshard_with_device_flap(seed: int) -> None:
    """A live split while the SOURCE shard's crypto plane is faulted:
    the copy replays and the handoff ride hedged CPU fallback, and the
    migration still completes exactly-once."""
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    rng = SimRandom(seed * 67867979 + 7)
    faulty = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        faulty, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=2,
                               cooldown=rng.float(0.5, 1.5)),
        budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                              warm_max=1.0, cold_max=1.0))
    # rung 0 (the live split): its mid-migration writes drive auth
    # through the faulted source plane, so the breaker + hedged CPU
    # fallback are actually exercised by the migration itself
    run_reshard_fuzz_scenario(seed, force_rung=0,
                              faulted_plane=(sup, faulty))


def run_reshard_with_client_flood(seed: int) -> None:
    """A live split while hot clients flood the front door: over-cap
    bursts shed EXPLICITLY, the honest client's write (owned by the
    migrating shard) survives the migration, and the reshard completes."""
    from plenum_tpu_torch.client.sim_clients import burst_writes
    from plenum_tpu_torch.common.node_messages import LoadShed
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 37199 + 11)
    cap = rng.integer(2, 4)
    from plenum_tpu_torch.shards import ShardedSimFabric
    fab = _track(ShardedSimFabric(
        n_shards=2, nodes_per_shard=4, seed=seed,
        config=Config(**FAST, INGRESS_CLIENT_QUEUE_CAP=cap)))
    entry = fab.shards[0].names[0]
    ing = fab.ingress_plane(entry, tick=False)

    honest = user_on_shard(fab, 0, b"fl%d-" % seed)
    req = signed_write(fab, honest, 1)
    fab.submit_write(req)
    elapsed = 0.0
    while elapsed < 20.0 and fab.shards[0].ordered_count() < 1:
        fab.run(0.5)
        elapsed += 0.5
    assert fab.shards[0].ordered_count() >= 1

    m = fab.reshard.split(0)
    n_hot = rng.integer(4, 8)
    per_client = cap + rng.integer(3, 5)
    for client, burst_req in burst_writes(fab.trustee, n_hot, per_client,
                                          seed=seed):
        ing.submit(burst_req.to_dict(), client)
    honest2 = user_on_shard(fab, 0, b"fh%d-" % seed, start=40)
    ing.submit(signed_write(fab, honest2, 2).to_dict(), "honest-2")
    for _ in range(240):
        ing.service()
        fab.run(0.5)
        if m.phase == "done":
            break
    assert m.phase == "done", \
        f"seed {seed}: reshard starved by the flood ({m.to_dict()})"
    sheds = [msg for msg, _ in fab.shards[0].client_msgs[entry]
             if isinstance(msg, LoadShed)]
    assert len(sheds) >= n_hot * (per_client - cap), \
        f"seed {seed}: over-cap burst not shed explicitly"
    owner = fab.router.shard_of(signed_write(fab, honest2, 2))
    node = next(iter(fab.shards[owner].nodes.values()))
    elapsed = 0.0
    while elapsed < 30.0 and node._executed_txn(
            signed_write(fab, honest2, 2)) is None:
        ing.service()
        fab.run(0.5)
        elapsed += 0.5
    assert node._executed_txn(signed_write(fab, honest2, 2)) is not None, \
        f"seed {seed}: honest write lost across flood + migration"
    for shard in fab.shards.values():
        assert_safety(shard)


RESHARD_SEEDS = 20


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_reshard_fuzz(bucket):
    for seed in range(bucket * 5, (bucket + 1) * 5):
        _run_with_artifacts(run_reshard_fuzz_scenario, seed)


def test_sim_reshard_smoke():
    """Two rungs always run in the default suite: the healthy split
    under traffic (exactly-once + the stale-view reader refreshing) and
    the ratchet race (in-window forward, post-window fail-closed NACK)."""
    _held_smoke(run_reshard_fuzz_scenario, 1, force_rung=0)
    _held_smoke(run_reshard_fuzz_scenario, 2, force_rung=3)


def test_sim_reshard_2pc_smoke():
    """The 2PC fault rungs always run: coordinator crash between
    prepare and commit (atomicity through recovery), and the live split
    racing an in-flight cross-shard write (fail-closed epoch abort)."""
    _held_smoke(run_reshard_fuzz_scenario, 3, force_rung=4)
    _held_smoke(run_reshard_fuzz_scenario, 4, force_rung=5)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_reshard_device_flap_fuzz(bucket):
    for seed in range(bucket * 3, (bucket + 1) * 3):
        _run_with_artifacts(run_reshard_with_device_flap, seed)


def test_sim_reshard_device_flap_smoke():
    _held_smoke(run_reshard_with_device_flap, 1)


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_reshard_client_flood_fuzz(bucket):
    for seed in range(bucket * 2, (bucket + 1) * 2):
        _run_with_artifacts(run_reshard_with_client_flood, seed)


def test_sim_reshard_client_flood_smoke():
    _held_smoke(run_reshard_with_client_flood, 1)


# --- membership_churn satellite: DIRECTORY-COMMITTEE key rotation -----------


def run_membership_churn_dir_rotation_scenario(seed: int) -> None:
    """Rotate one directory-committee signer MID-LOAD: the mapping root
    re-signs under the new committee, old-committee map proofs fail
    closed against the rotated trust root, and reads/writes keep
    flowing for clients holding the new root."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.execution.txn import GET_NYM
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 23456789 + 13)
    fab = _reshard_fabric(seed)
    users = {sid: user_on_shard(fab, sid, b"dr%d-" % seed)
             for sid in fab.shards}
    for rid, (sid, u) in enumerate(sorted(users.items()), start=1):
        assert fab.submit_write(signed_write(fab, u, rid)) == sid
    elapsed = 0.0
    while elapsed < 25.0 and any(s.ordered_count() < 1
                                 for s in fab.shards.values()):
        fab.run(0.5)
        elapsed += 0.5

    victim_sid = rng.integer(0, 1)
    key = fab.mapping.shard_of(
        users[victim_sid].identifier.encode())     # sanity: map intact
    old_keys = dict(fab.mapping.directory_keys)
    old_proof = fab.mapping.ownership_proof(
        users[victim_sid].identifier.encode())
    stale_client = fab.read_driver()               # trusts the OLD root
    assert stale_client.checker.directory_keys == old_keys

    # rotate one signer mid-load; writes keep flowing around it
    victim_dir = sorted(fab.directory)[rng.integer(0, 3)]
    new_signer = BlsCryptoSigner(
        seed=(b"dirrot%d-%s" % (seed, victim_dir.encode()))
        .ljust(32, b"\0")[:32])
    fab.mapping.rotate_signer(victim_dir, new_signer)
    u_mid = user_on_shard(fab, 0, b"dm%d-" % seed, start=30)
    elapsed, target = 0.0, fab.shards[0].ordered_count() + 1
    assert fab.submit_write(signed_write(fab, u_mid, 50)) == 0
    while elapsed < 25.0 and fab.shards[0].ordered_count() < target:
        fab.run(0.5)
        elapsed += 0.5
    assert fab.shards[0].ordered_count() >= target, \
        f"seed {seed}: pool stalled across the directory rotation"

    from plenum_tpu_torch.shards import verify_ownership
    new_keys = fab.mapping.directory_keys
    # the root RE-SIGNED: fresh proofs verify under the new committee
    fresh = fab.mapping.ownership_proof(users[victim_sid]
                                        .identifier.encode())
    got, why = verify_ownership(users[victim_sid].identifier.encode(),
                                fresh, new_keys,
                                now=fab.timer.get_current_time)
    assert why == "ok" and got.shard_id == key.shard_id, \
        f"seed {seed}: re-signed root does not verify ({why})"
    # OLD-committee proofs fail closed against the rotated trust root
    got, why = verify_ownership(users[victim_sid].identifier.encode(),
                                old_proof, new_keys,
                                now=fab.timer.get_current_time)
    assert got is None and why == "bad_map_multi_sig", \
        f"seed {seed}: old-committee proof accepted ({why})"
    # a client on the NEW root verifies reads end to end
    fresh_client = fab.read_driver()
    q = Request("dr", 60, {"type": GET_NYM,
                           "dest": users[victim_sid].identifier})
    res = fresh_client.read(q, per_node_s=2.0, step_s=0.1)
    assert res is not None and fresh_client.stats.summary()[
        "map_proof_failures"] == 0, \
        f"seed {seed}: rotated root broke healthy reads"
    # a client still pinning the OLD root rejects the new signature —
    # fail closed, never a silently-accepted downgrade
    q2 = Request("dr", 61, dict(q.operation))
    res = stale_client.read(q2, per_node_s=1.0, step_s=0.1)
    s = stale_client.stats.summary()
    assert res is None and \
        s["map_failure_reasons"].get("bad_map_multi_sig", 0) >= 1, \
        f"seed {seed}: old-root client accepted the rotated committee {s}"
    for shard in fab.shards.values():
        assert_safety(shard)


DIR_ROTATION_SEEDS = 8


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(2))
def test_sim_membership_churn_dir_rotation_fuzz(bucket):
    for seed in range(bucket * 4, (bucket + 1) * 4):
        _run_with_artifacts(run_membership_churn_dir_rotation_scenario,
                            seed)


def test_sim_membership_churn_dir_rotation_smoke():
    _held_smoke(run_membership_churn_dir_rotation_scenario, 1)


# --- autopilot: the control plane under composed stress ----------------------
# The `autopilot` fuzz kind: telemetry -> actuation closed-loop
# (control/autopilot.py). Every scenario runs with ZERO test-driven
# actuation — the test injects load and faults, the autopilot alone
# splits, re-pins, scales and degrades — and every run must leave a
# control ledger that AUDITS CLEAN (tools/control_audit.py): the pinned
# no-flap property (no action/undo pair inside one cooldown window, no
# oscillating split/merge), every action evidenced, every undo citing
# its action.

def _autopilot_config(**over):
    cfg = dict(FAST)
    cfg.update(AUTOPILOT=True, AUTOPILOT_INTERVAL=0.5,
               AUTOPILOT_SUSTAIN=2, AUTOPILOT_RECOVER_SUSTAIN=3,
               AUTOPILOT_COOLDOWN=6.0, RESHARD_COOLDOWN=6.0,
               TELEMETRY_INTERVAL=0.5, SLO_BURN_FAST_WINDOW=2.0,
               SLO_BURN_SLOW_WINDOW=6.0)
    cfg.update(over)
    return Config(**cfg)


def _autopilot_audit(ap, seed: int) -> list[dict]:
    from plenum_tpu_torch.tools.control_audit import audit_records
    recs = ap.ledger.to_dicts()
    problems = audit_records(recs)
    assert problems == [], \
        f"seed {seed}: control ledger failed its audit: {problems}"
    return recs


def _supervised_lanes(rng, n_lanes):
    from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.supervisor import (CircuitBreaker,
                                                DeadlineBudget,
                                                SupervisedVerifier)
    faulties, sups = [], []
    for k in range(n_lanes):
        faulty = FaultyVerifier(CpuEd25519Verifier())
        sup = SupervisedVerifier(
            faulty, fallback=CpuEd25519Verifier(),
            breaker=CircuitBreaker(fail_threshold=2,
                                   cooldown=rng.float(0.5, 1.5)),
            budget=DeadlineBudget(base=rng.float(0.3, 0.6), min_s=0.2,
                                  warm_max=1.0, cold_max=1.0),
            label=f"lane{k}")
        faulties.append(faulty)
        sups.append(sup)
    return faulties, sups


def _junk(tag: bytes, seed: int, n: int = 3):
    return [(b"%s-%d-%d" % (tag, seed, i), b"\x01" * 63 + b"\x00",
             bytes([i % 250 + 1]) * 32) for i in range(n)]


def run_autopilot_split_scenario(seed: int) -> None:
    """Zipfian flood onto shard 0: the autopilot's SUSTAINED imbalance
    judgment must drive maybe_split on its own, the migration completes
    exactly-once, and the ledger shows ONE split (evidence + pre/post
    shard state) with no merge chasing it."""
    from plenum_tpu_torch.shards import ShardedSimFabric
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 93179 + 3)
    fab = _track(ShardedSimFabric(n_shards=2, nodes_per_shard=3,
                                  seed=seed, config=_autopilot_config()))
    ap = fab.autopilot
    assert ap is not None

    writes, rid = [], 0
    for k in range(10 + rng.integer(0, 4)):
        sid = 1 if k % 8 == 7 else 0           # ~90% keyed into shard 0
        u = user_on_shard(fab, sid, b"as%d-" % seed, start=k * 13)
        rid += 1
        req = signed_write(fab, u, rid)
        writes.append((u, req))
        assert fab.submit_write(req) is not None

    elapsed = 0.0
    while elapsed < 60.0 and not any(
            r.action == "split" for r in ap.ledger.records):
        fab.run(0.5)
        elapsed += 0.5
    splits = [r for r in ap.ledger.records if r.action == "split"]
    assert splits, \
        f"seed {seed}: sustained imbalance never actuated a split " \
        f"({ap.summary()})"
    m = fab.reshard.active or fab.reshard.history[-1]
    _drive_migration(fab, m, timeout=120.0)
    assert m.phase == "done", \
        f"seed {seed}: autopilot split never completed: {m.to_dict()}"
    assert len(fab.shards) == 3 and fab.mapping.epoch == 1
    rec = splits[0]
    assert rec.evidence.get("hot_shard") == 0 and \
        rec.evidence.get("index", 0) >= \
        fab.config.SHARD_IMBALANCE_THRESHOLD, rec.evidence
    assert rec.pre["shards"] == [0, 1] and rec.post["shards"] == [0, 1, 2]
    # no oscillation: one split, zero merges, audit-clean ledger
    fab.run(fab.config.AUTOPILOT_COOLDOWN + 3.0)
    assert len([r for r in ap.ledger.records
                if r.action == "split"]) == 1, \
        f"seed {seed}: the split chased its own transient"
    assert not [r for r in ap.ledger.records if r.action == "merge"], \
        f"seed {seed}: split/merge oscillation"
    _autopilot_audit(ap, seed)
    _assert_exactly_once(fab, seed, writes)
    for shard in fab.shards.values():
        assert_safety(shard)


def run_autopilot_repin_scenario(seed: int) -> None:
    """One chip of the shared multi-device ring flaps: the sustained
    open breaker re-pins the sick lane's shards to a healthy chip, a
    write ordered mid-sickness survives, and after the breaker holds
    closed through the recovery window (+cooldown) the pins RESTORE —
    the unpin citing its repin, never both inside one window."""
    from plenum_tpu_torch.parallel.pipeline import MultiDeviceCryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import CLOSED
    from plenum_tpu_torch.shards import ShardedSimFabric
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 69623 + 29)
    faulties, sups = _supervised_lanes(rng, n_lanes=3)
    pipeline = MultiDeviceCryptoPipeline(
        ed_inners=sups, config=Config(**FAST), threaded=False)
    fab = _track(ShardedSimFabric(n_shards=2, nodes_per_shard=3,
                                  seed=seed, config=_autopilot_config(),
                                  pipeline=pipeline))
    ap = fab.autopilot
    for obj in (*sups, *faulties):
        obj.set_clock(fab.timer.get_current_time)

    sick = fab.lane_pins[0]
    assert sick is not None
    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    getattr(faulties[sick], kind)()
    elapsed = 0.0
    while elapsed < 40.0 and not any(
            r.action == "repin" for r in ap.ledger.records):
        pipeline.verifier(lane=sick).verify_batch(
            _junk(b"ap-sick%d" % int(elapsed * 2), seed))
        fab.run(0.5)
        elapsed += 0.5
    repins = [r for r in ap.ledger.records if r.action == "repin"]
    assert repins, \
        f"seed {seed}: sustained open breaker never re-pinned " \
        f"(breaker={sups[sick].breaker.state}, {ap.summary()})"
    target = fab.lane_pins[0]
    assert target != sick, f"seed {seed}: pin did not move off lane {sick}"
    assert repins[0].evidence.get("sick_lane") == sick

    # ordering continues on the re-pinned lane while the chip is dark
    u = user_on_shard(fab, 0, b"ar%d-" % seed)
    req = signed_write(fab, u, 1)
    assert fab.submit_write(req) is not None
    before = fab.shards[0].ordered_count()
    elapsed = 0.0
    while elapsed < 30.0 and fab.shards[0].ordered_count() <= before:
        fab.run(0.5)
        elapsed += 0.5
    assert fab.shards[0].ordered_count() > before, \
        f"seed {seed}: shard stopped ordering after the re-pin"

    # heal: probe traffic re-closes the breaker; the clear streak plus
    # the repin's cooldown stamp gate the restore
    faulties[sick].heal()
    elapsed = 0.0
    while elapsed < 60.0 and not any(
            r.action == "unpin" for r in ap.ledger.records):
        if sups[sick].breaker.state != CLOSED:
            pipeline.verifier(lane=sick).verify_batch(
                _junk(b"ap-heal%d" % int(elapsed * 2), seed))
        fab.run(0.5)
        elapsed += 0.5
    unpins = [r for r in ap.ledger.records if r.action == "unpin"]
    assert unpins, \
        f"seed {seed}: pins never restored after the re-warm " \
        f"({ap.summary()})"
    assert fab.lane_pins[0] == sick            # back on its own chip
    assert unpins[0].cites == repins[0].seq
    # hysteresis, not a flap: the undo landed OUTSIDE the cooldown
    assert unpins[0].t >= repins[0].cooldown_until
    _autopilot_audit(ap, seed)
    for shard in fab.shards.values():
        assert_safety(shard)


def run_autopilot_observer_scenario(seed: int) -> None:
    """Regional read burn: reads beyond the region's pooled capacity
    ledger SLO violations, the sustained burn spawns an observer, and
    after demand falls back (with measured headroom) the newest one
    retires — the retire citing its spawn."""
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.shards import ShardedSimFabric

    rng = SimRandom(seed * 50329 + 13)
    cap = 3.0 + rng.integer(0, 3)
    fab = _track(ShardedSimFabric(n_shards=2, nodes_per_shard=3,
                                  seed=seed, config=_autopilot_config()))
    fleet = fab.attach_observer_fleet(regions=("r0",), capacity=cap)
    ap = fab.autopilot
    q = Request("rdr", 1, {"type": GET_NYM,
                           "dest": fab.trustee.identifier}).to_dict()

    elapsed = 0.0
    while elapsed < 40.0 and fleet.count("r0") == 1:
        for _ in range(int(cap * 3) + 2):      # ~3x pooled capacity
            fleet.serve_read("r0", q)
        fab.run(0.5)
        elapsed += 0.5
    assert fleet.count("r0") == 2, \
        f"seed {seed}: read burn never spawned an observer " \
        f"({fleet.summary()}, {ap.summary()})"
    spawns = [r for r in ap.ledger.records
              if r.action == "observer_spawn"]
    assert spawns[0].subject == "r0" and spawns[0].evidence

    # demand falls to a trickle one observer holds with headroom
    elapsed = 0.0
    while elapsed < 60.0 and fleet.count("r0") == 2:
        fleet.serve_read("r0", q)
        fab.run(0.5)
        elapsed += 0.5
    assert fleet.count("r0") == 1, \
        f"seed {seed}: observer never retired after recovery " \
        f"({fleet.summary()}, {ap.summary()})"
    retires = [r for r in ap.ledger.records
               if r.action == "observer_retire"]
    assert retires[0].cites == spawns[0].seq
    assert retires[0].t >= spawns[0].cooldown_until
    assert fleet.stats["reads"] > 0 and fleet.stats["violations"] > 0
    _autopilot_audit(ap, seed)
    for shard in fab.shards.values():
        assert_safety(shard)


def run_autopilot_ladder_scenario(seed: int) -> None:
    """A front door's SLO ledger burns hot and STAYS hot: the ladder
    steps down (shed-harder clamps every ingress plane, then pool-wide
    read-only), holds at the floor, and steps back UP one level at a
    time on sustained recovery — recovers citing their degrades LIFO,
    and a catchup-parked read-only is never the autopilot's to clear."""
    from plenum_tpu_torch.shards import ShardedSimFabric

    rng = SimRandom(seed * 104729 + 5)
    fab = _track(ShardedSimFabric(n_shards=2, nodes_per_shard=3,
                                  seed=seed, config=_autopilot_config()))
    ap = fab.autopilot
    entry = fab.shards[0].names[0]
    plane = fab.ingress_plane(entry, tick=False)
    base_wm = plane.shed_watermark
    tracker = fab.aggregator.tracker("ingress", "front-door")

    def feed(viol: int, n: int = 5) -> None:
        tracker.note(fab.timer.get_current_time(), viol, n)
        fab.run(0.5)

    burn = 3 + rng.integer(0, 2)
    elapsed = 0.0
    while elapsed < 60.0 and ap.level < 1:
        feed(burn)
        elapsed += 0.5
    assert ap.level >= 1, f"seed {seed}: ladder never degraded " \
                          f"({ap.summary()})"
    assert plane.shed_watermark == max(
        1, fab.config.INGRESS_HIGH_WATERMARK
        // fab.config.AUTOPILOT_SHED_FACTOR)
    while elapsed < 120.0 and ap.level < 2:
        feed(burn)
        elapsed += 0.5
    assert ap.level == 2, f"seed {seed}: ladder stuck below read-only " \
                          f"({ap.summary()})"
    assert all(n.read_only_degraded for n in fab.nodes.values())
    # held at the floor: more burn, no action past the ladder's end
    floor_actions = ap.counts["actions"]
    for _ in range(8):
        feed(burn)
    assert ap.counts["actions"] == floor_actions

    # recovery: clean intervals age the burn out of both windows
    while elapsed < 300.0 and ap.level > 0:
        feed(0)
        elapsed += 0.5
    assert ap.level == 0, f"seed {seed}: ladder never recovered " \
                          f"({ap.summary()})"
    assert not any(n.read_only_degraded for n in fab.nodes.values())
    assert plane.shed_watermark == base_wm
    recs = _autopilot_audit(ap, seed)
    degrades = [r for r in recs if r["action"] == "degrade"]
    recovers = [r for r in recs if r["action"] == "recover"]
    assert [r["subject"] for r in degrades] == ["shed_harder",
                                                "read_only"]
    assert [r["cites"] for r in recovers] == \
        [degrades[1]["seq"], degrades[0]["seq"]]
    for shard in fab.shards.values():
        assert_safety(shard)


def run_autopilot_composed_scenario(seed: int) -> None:
    """The acceptance run: zipfian client flood + a flapping chip lane
    + the live-split membership churn the autopilot itself drives, all
    at once, healed end-to-end with zero test-driven actuation. Pinned:
    the ledger audits clean (no action/undo inside a cooldown window),
    no split/merge oscillation, exactly-once ordering, no fork."""
    from plenum_tpu_torch.parallel.pipeline import MultiDeviceCryptoPipeline
    from plenum_tpu_torch.parallel.supervisor import CLOSED
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.shards import ShardedSimFabric
    from test_torch_shards import signed_write, user_on_shard

    rng = SimRandom(seed * 122949823 + 19)
    faulties, sups = _supervised_lanes(rng, n_lanes=3)
    pipeline = MultiDeviceCryptoPipeline(
        ed_inners=sups, config=Config(**FAST), threaded=False)
    # generous SLO budgets: the composed run exercises split + re-pin +
    # observer scale; the ladder has its own dedicated scenario and
    # must not park the pool read-only mid-migration over sim timing
    fab = _track(ShardedSimFabric(
        n_shards=2, nodes_per_shard=3, seed=seed,
        config=_autopilot_config(BATCH_SLO_P95=30.0,
                                 INGRESS_SLO_P95=30.0),
        pipeline=pipeline))
    ap = fab.autopilot
    for obj in (*sups, *faulties):
        obj.set_clock(fab.timer.get_current_time)
    cap = 3.0 + rng.integer(0, 2)
    fleet = fab.attach_observer_fleet(regions=("r0",), capacity=cap)
    q = Request("rdr", 1, {"type": GET_NYM,
                           "dest": fab.trustee.identifier}).to_dict()

    # zipfian flood: ~90% of the writes key into shard 0
    writes, rid = [], 0
    for k in range(8 + rng.integer(0, 4)):
        sid = 1 if k % 8 == 7 else 0
        u = user_on_shard(fab, sid, b"ac%d-" % seed, start=k * 19)
        rid += 1
        req = signed_write(fab, u, rid)
        writes.append((u, req))
        assert fab.submit_write(req) is not None

    sick = fab.lane_pins[0]
    kind = ("wedge", "drop", "corrupt")[rng.integer(0, 2)]
    fab.run(rng.float(0.5, 1.5))
    getattr(faulties[sick], kind)()            # the chip flaps mid-flood
    heal_step = 24 + rng.integer(0, 8)
    for step in range(120):
        if step == heal_step:
            faulties[sick].heal()
        if step < heal_step:
            pipeline.verifier(lane=sick).verify_batch(
                _junk(b"cx%d" % step, seed))
        elif sups[sick].breaker.state != CLOSED:
            pipeline.verifier(lane=sick).verify_batch(
                _junk(b"ch%d" % step, seed))
        for _ in range(int(cap * 3) + 2 if step < 40 else 1):
            fleet.serve_read("r0", q)          # read burn, then trickle
        fab.run(0.5)
        if step > 80 and fab.reshard.active is None \
                and sups[sick].breaker.state == CLOSED \
                and not ap._repins:
            break
    if fab.reshard.active is not None:
        _drive_migration(fab, fab.reshard.active, timeout=120.0)

    recs = _autopilot_audit(ap, seed)          # the pinned no-flap gate
    splits = [r for r in recs if r["action"] == "split"]
    merges = [r for r in recs if r["action"] == "merge"]
    assert len(splits) <= 1 and not merges, \
        f"seed {seed}: split/merge oscillation under composed stress " \
        f"({[r['action'] for r in recs]})"
    assert splits, \
        f"seed {seed}: the hot-shard flood never split ({ap.summary()})"
    assert fab.reshard.history and \
        fab.reshard.history[-1].phase == "done", \
        f"seed {seed}: composed stress starved the migration"
    repins = [r for r in recs if r["action"] == "repin"]
    assert repins, \
        f"seed {seed}: the flapping chip never forced a re-pin " \
        f"({ap.summary()})"
    _assert_exactly_once(fab, seed, writes)
    for shard in fab.shards.values():
        assert_safety(shard)


AUTOPILOT_SEEDS = 12


@pytest.mark.slow
@pytest.mark.parametrize("bucket", range(4))
def test_sim_autopilot_fuzz(bucket):
    for seed in range(bucket * 3, (bucket + 1) * 3):
        _run_with_artifacts(run_autopilot_composed_scenario, seed)


def test_sim_autopilot_split_smoke():
    _held_smoke(run_autopilot_split_scenario, 1)


def test_sim_autopilot_repin_smoke():
    _held_smoke(run_autopilot_repin_scenario, 1)


def test_sim_autopilot_observer_smoke():
    _held_smoke(run_autopilot_observer_scenario, 1)


def test_sim_autopilot_ladder_smoke():
    _held_smoke(run_autopilot_ladder_scenario, 1)


def test_sim_autopilot_composed_smoke():
    _held_smoke(run_autopilot_composed_scenario, 1)


# --- the port against the reference, and against itself -------------------

def _outcome(pool) -> dict:
    """Every node's ordered domain txns and ledger root."""
    return {n: (_domain_txns(node),
                node.c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash)
            for n, node in sorted(pool.nodes.items())}


@pytest.mark.parametrize("name,seed", [
    ("run_scenario", 2), ("run_device_flap_multidevice", 2),
    ("run_crypto_host_down_scenario", 2), ("run_client_flood_scenario", 2),
    ("run_membership_churn_scenario", 2)])
def test_scenario_orders_the_references_txns(name, seed):
    """One seed of a rung through both packages: every node ordered the
    same txns to the same root as the reference's node of that name."""
    import test_sim_fuzz as ref_fuzz
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        globals()[name](seed)
        ours = _outcome(_SCENARIO_POOLS[0])
        getattr(ref_fuzz, name)(seed)
        theirs = _outcome(ref_fuzz._SCENARIO_POOLS[0])
    assert ours == theirs


@pytest.mark.parametrize("name", ["run_device_flap_multidevice",
                                  "run_crypto_host_down_scenario"])
def test_scale_out_rungs_replay_identically(name):
    """The multi-device and crypto-host-down rungs are pure functions of
    their seed: two runs order the same txns and drive every lane alike
    (CPU lanes stay inline, so nothing races the sim clock)."""
    runs = []
    for _ in range(2):
        globals()[name](3)
        pool = _SCENARIO_POOLS[0]
        runs.append((_outcome(pool), pool.pipeline.device_state(),
                     dict(pool.pipeline.stats)))
    assert runs[0] == runs[1]
