"""The port's copy of tests/test_ingress.py, run on plenum_tpu_torch
(sim pools and the in-process observer on the `cpu` backend), and the
ingress plane's batched admission on a `torch` pool, where it reaches
the kernels' plain K3 + K4 through the node's own authenticator, and
the reference's bench configuration config7 (slow) on the `cpu`
backend.

Ingress plane: admission control, fair queueing, batched auth, and
observer read fan-out (docs/ingress.md).

The smoke test at the top is the CI acceptance shape: construct the
whole plane on a 4-node sim pool and round-trip one admitted write and
one observer-verified read. The rest pins each mechanism: per-client
caps, watermark hysteresis + explicit LoadShed replies, weighted-fair
dequeue, one-dispatch auth batching through the ReqAuthenticator seam,
the AIMD admission controller, verification-gated observer anchors, and
the anchor-lag escalation.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID, BatchCommitted,
                                             LoadShed, Reply, RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import GET_NYM
from plenum_tpu_torch.ingress import (SHED_CLIENT_CAP, SHED_OVERLOAD,
                                IngressController, IngressPlane, SimObserver)

from test_torch_pool import Pool, one_torch_thread, signed_nym  # noqa: F401

FAST = Config(Max3PCBatchWait=0.05, STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
              crypto_backend="cpu")


def attach_ingress(pool, names=None, config=None):
    """One IngressPlane per node, ticking on the pool's MockTimer."""
    return {n: IngressPlane(pool.nodes[n], config=config)
            for n in (names or pool.names)}


def attach_observer(pool, name="obs1", anchor_lag_max=None, f=1):
    """In-process observer registered with every validator. Attach
    BEFORE ordering traffic: pushes only cover live batches."""
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys
    obs = SimObserver(name, pool.genesis, pool.names,
                      pool_bls_keys(pool.names),
                      now=pool.timer.get_current_time, f=f,
                      anchor_lag_max=anchor_lag_max, crypto_backend="cpu")
    obs.register(lambda v, msg: pool.nodes[v].handle_client_message(
        msg, obs.client_id))
    pool.run(0.5)                       # registrations land
    return obs


def route_pushes(pool, observers):
    """Move BatchCommitted pushes from validator client outboxes into
    the observers (the sim twin of the TCP push connection)."""
    by_id = {o.client_id: o for o in observers}
    for v in pool.names:
        keep = []
        for m, c in pool.client_msgs[v]:
            obs = by_id.get(c)
            if obs is not None:
                if isinstance(m, BatchCommitted):
                    obs.deliver_push(m, v)
            else:
                keep.append((m, c))
        pool.client_msgs[v] = keep


def run_routed(pool, observers, seconds=1.0, step=0.1):
    elapsed = 0.0
    while elapsed < seconds:
        pool.run(step, step=step)
        route_pushes(pool, observers)
        elapsed += step


def shed_replies(pool, node_name, client=None):
    return [m for m, c in pool.client_msgs[node_name]
            if isinstance(m, LoadShed) and (client is None or c == client)]


# --- the CI smoke: whole plane, one write + one observer-verified read ---

def test_ingress_smoke_write_and_observer_read():
    from plenum_tpu_torch.reads import SimReadDriver
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    pool = Pool(config=FAST)
    obs = attach_observer(pool)
    ingress = attach_ingress(pool)

    user = Ed25519Signer(seed=b"ing-smoke-user".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, req_id=1)
    for n in pool.names:
        ingress[n].submit(req.to_dict(), "cli1")
    run_routed(pool, [obs], 6.0)

    # the write round-tripped: ordered everywhere + client REPLY
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {2}, sizes
    assert any(isinstance(m, Reply) for m, c in pool.client_msgs["Alpha"]
               if c == "cli1")
    assert ingress["Alpha"].stats["admitted"] == 1
    assert ingress["Alpha"].stats["auth_batches"] >= 1
    # the write NEVER touched the node's raw client inbox
    assert all(len(pool.nodes[n]._client_inbox) == 0 for n in pool.names)

    # the observer replicated the batch and serves a VERIFIED read
    assert obs.batches_applied >= 1
    assert obs.gate.stats["ms_adopted"] >= 1

    def submit(name, q):
        if name == obs.name:
            obs.handle_client_message(q.to_dict(), "rdr")
        else:
            pool.nodes[name].handle_client_message(q.to_dict(), "rdr")

    def collect(name):
        if name == obs.name:
            out = [m.result for m, _ in obs.sent if isinstance(m, Reply)]
            obs.sent.clear()
            return out
        out = [m.result for m, c in pool.client_msgs[name]
               if isinstance(m, Reply) and c == "rdr"]
        pool.client_msgs[name] = [
            (m, c) for m, c in pool.client_msgs[name]
            if not (isinstance(m, Reply) and c == "rdr")]
        return out

    driver = SimReadDriver(submit, collect, pool.run, pool.names,
                           pool_bls_keys(pool.names), freshness_s=1e12,
                           now=pool.timer.get_current_time,
                           observer_names=[obs.name])
    q = Request("rdr", 10, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None and res["data"]["verkey"] == user.verkey_b58
    s = driver.stats
    assert s.observer_ok == 1 and s.single_reply_ok == 1
    assert s.failovers == 0 and s.fallbacks == 0
    # fanout 2 and the pool was never touched by the read
    assert s.msgs_sent == 1 and s.replies_seen == 1


# --- admission control ----------------------------------------------------

def test_per_client_cap_sheds_hot_client_only():
    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_CLIENT_QUEUE_CAP=4, INGRESS_CONTROLLER=False)
    # tick=False: the queue must be observable BEFORE a service drains it
    ing = IngressPlane(pool.nodes["Alpha"], config=cfg, tick=False)

    hot_reqs = [signed_nym(pool.trustee,
                           Ed25519Signer(seed=(b"hot%d" % i).ljust(32, b"\0")),
                           req_id=100 + i) for i in range(10)]
    for r in hot_reqs:
        ing.submit(r.to_dict(), "hot")
    steady = signed_nym(pool.trustee,
                        Ed25519Signer(seed=b"steady".ljust(32, b"\0")), 200)
    ing.submit(steady.to_dict(), "steady")

    assert ing.stats["shed_client_cap"] == 6       # 10 - cap(4)
    assert ing.stats["admitted"] == 5              # 4 hot + 1 steady
    sheds = shed_replies(pool, "Alpha", "hot")
    assert len(sheds) == 6
    assert all(m.reason == SHED_CLIENT_CAP for m in sheds)
    assert not shed_replies(pool, "Alpha", "steady")


def test_global_watermark_hysteresis_and_recovery():
    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_HIGH_WATERMARK=8, INGRESS_LOW_WATERMARK=2,
                       INGRESS_CLIENT_QUEUE_CAP=4, INGRESS_ADMIT_MAX=4,
                       INGRESS_ADMIT_MIN=4, INGRESS_CONTROLLER=False)
    ing = IngressPlane(pool.nodes["Alpha"], config=cfg, tick=False)
    reqs = [signed_nym(pool.trustee,
                       Ed25519Signer(seed=(b"wm%02d" % i).ljust(32, b"\0")),
                       300 + i) for i in range(20)]
    # 20 distinct clients, 1 req each: per-client caps never bind, the
    # GLOBAL watermark does — admit 8, shed the rest, latch engaged
    for i, r in enumerate(reqs[:12]):
        ing.submit(r.to_dict(), f"c{i}")
    assert ing.queue_depth == 8
    assert ing.stats["shed_overload"] == 4
    assert all(m.reason == SHED_OVERLOAD
               for m in shed_replies(pool, "Alpha"))
    # latched: still shedding even though depth < high watermark
    ing.service()                       # drains 4 -> depth 4 > low mark
    ing.submit(reqs[12].to_dict(), "c12")
    assert ing.stats["shed_overload"] == 5
    # drain below the low mark -> latch clears, admission resumes
    ing.service()
    assert ing.queue_depth <= 2
    ing.submit(reqs[13].to_dict(), "c13")
    assert ing.stats["shed_overload"] == 5
    assert ing.queue_depth >= 1
    pool.run(2.0)


def test_fair_dequeue_splits_budget_across_clients():
    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_CLIENT_QUEUE_CAP=32, INGRESS_ADMIT_MAX=6,
                       INGRESS_ADMIT_MIN=6, INGRESS_CONTROLLER=False,
                       INGRESS_HIGH_WATERMARK=1000)
    node = pool.nodes["Alpha"]
    ing = IngressPlane(node, config=cfg, tick=False)
    admitted = []
    node.submit_preverified = lambda req, frm: admitted.append(frm)

    # hog floods 20, two mice bring 2 each; a 6-budget drain must take
    # from EVERY active client, not FIFO-reward the hog
    for i in range(20):
        ing.submit(signed_nym(pool.trustee, Ed25519Signer(
            seed=(b"hog%02d" % i).ljust(32, b"\0")), 400 + i).to_dict(),
            "hog")
    for c in ("mouse1", "mouse2"):
        for i in range(2):
            ing.submit(signed_nym(pool.trustee, Ed25519Signer(
                seed=(c.encode() + b"%d" % i).ljust(32, b"\0")),
                500 + i).to_dict(), c)
    ing.service()
    assert len(admitted) == 6
    assert admitted.count("mouse1") == 2 and admitted.count("mouse2") == 2
    assert admitted.count("hog") == 2    # fair share, not the whole budget

    # weights: a weight-3 client gets 3 slots per rotation pass
    ing.set_weight("hog", 3)
    admitted.clear()
    ing.service()
    assert admitted.count("hog") >= 3


def test_bad_signature_flood_dies_at_ingress():
    from plenum_tpu_torch.client.sim_clients import burst_writes
    pool = Pool(config=FAST)
    ing = IngressPlane(pool.nodes["Alpha"], config=FAST, tick=False)
    burst = burst_writes(pool.trustee, n_clients=5, per_client=3,
                         bad_sigs=True)
    for client, req in burst:
        ing.submit(req.to_dict(), client)
    ing.service()
    assert ing.stats["auth_fail"] == 15
    nacks = [m for m, _ in pool.client_msgs["Alpha"]
             if isinstance(m, RequestNack)]
    assert len(nacks) == 15
    assert all("signature" in m.reason for m in nacks)
    pool.run(2.0)
    # nothing reached the pool: no propagates, nothing ordered
    assert pool.nodes["Alpha"].c.db.get_ledger(DOMAIN_LEDGER_ID).size == 1
    assert len(pool.nodes["Alpha"]._client_inbox) == 0


def test_auth_batch_amortizes_one_dispatch_per_tick():
    """Many clients' writes admitted in one tick ride ONE submit_batch
    dispatch — the measured auth batch size the bench line publishes."""
    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_ADMIT_MAX=64, INGRESS_ADMIT_MIN=64,
                       INGRESS_CONTROLLER=False)
    ing = IngressPlane(pool.nodes["Alpha"], config=cfg, tick=False)
    for i in range(24):
        ing.submit(signed_nym(pool.trustee, Ed25519Signer(
            seed=(b"amort%02d" % i).ljust(32, b"\0")), 600 + i).to_dict(),
            f"c{i}")
    ing.service()
    assert ing.stats["auth_batches"] == 1
    assert ing.stats["auth_items"] == 24
    assert ing.summary()["auth_batch_mean"] == 24.0


def test_duplicate_digest_settles_both_copies_one_verify():
    pool = Pool(config=FAST)
    ing = IngressPlane(pool.nodes["Alpha"], config=FAST, tick=False)
    node = pool.nodes["Alpha"]
    settled = []
    node.submit_preverified = lambda req, frm: settled.append(frm)
    req = signed_nym(pool.trustee,
                     Ed25519Signer(seed=b"dup-user".ljust(32, b"\0")), 700)
    ing.submit(req.to_dict(), "a")
    ing.submit(req.to_dict(), "b")
    ing.service()
    assert ing.stats["auth_items"] == 1          # ONE device verify
    assert sorted(settled) == ["a", "b"]         # both copies settled


# --- the admission controller --------------------------------------------

def test_ingress_controller_aimd_policy():
    timer = MockTimer()
    cfg = Config(INGRESS_ADMIT_MIN=16, INGRESS_ADMIT_MAX=256,
                 INGRESS_HIGH_WATERMARK=1024, INGRESS_LOW_WATERMARK=64,
                 INGRESS_SLO_P95=0.1, INGRESS_CONTROL_INTERVAL=1.0)
    ctl = IngressController(cfg, timer)
    start_admit = ctl.admit_max

    def interval(wait):
        for _ in range(20):
            ctl.note_admitted(wait)
        timer.advance(1.1)
        ctl.note_admitted(wait)

    # over SLO with drain headroom: admit budget grows first
    interval(0.5)
    assert ctl.last_decision["verdict"] == "grow:drain"
    assert ctl.admit_max == start_admit * 2
    # keep violating until the budget caps, then the watermark shrinks
    guard = 0
    while ctl.admit_max < cfg.INGRESS_ADMIT_MAX and guard < 10:
        interval(0.5)
        guard += 1
    interval(0.5)
    assert ctl.last_decision["verdict"] == "shrink:watermark"
    assert ctl.shed_watermark < cfg.INGRESS_HIGH_WATERMARK
    shrunk = ctl.shed_watermark
    # floor: repeated violation can never shed everything
    for _ in range(30):
        interval(0.5)
    assert ctl.shed_watermark >= cfg.INGRESS_HIGH_WATERMARK // 8
    # headroom: watermark recovers additively, budget decays
    interval(0.01)
    assert ctl.last_decision["verdict"] == "recover:headroom"
    assert ctl.shed_watermark > ctl._watermark_floor or \
        ctl.shed_watermark > shrunk - 1
    guard = 0
    while (ctl.shed_watermark < cfg.INGRESS_HIGH_WATERMARK
           or ctl.admit_max > start_admit) and guard < 200:
        interval(0.01)
        guard += 1
    assert ctl.shed_watermark == cfg.INGRESS_HIGH_WATERMARK
    assert ctl.admit_max == start_admit
    # no samples -> no decision (idle front door holds the knobs)
    before = ctl.decisions
    timer.advance(5.0)
    ctl.tick()
    assert ctl.decisions == before


def test_controller_steers_live_plane_under_flood():
    """Queue waits over the SLO must move the live plane's effective
    watermark/budget (decisions ride sample arrivals on the MockTimer)."""
    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_SLO_P95=0.05, INGRESS_CONTROL_INTERVAL=0.2,
                       INGRESS_ADMIT_MAX=8, INGRESS_ADMIT_MIN=2,
                       INGRESS_CLIENT_QUEUE_CAP=64,
                       INGRESS_HIGH_WATERMARK=4096,
                       INGRESS_TICK_INTERVAL=0.5)
    ing = IngressPlane(pool.nodes["Alpha"], config=cfg)
    for i in range(64):
        ing.submit(signed_nym(pool.trustee, Ed25519Signer(
            seed=(b"ctl%03d" % i).ljust(32, b"\0")), 800 + i).to_dict(),
            f"c{i % 8}")
    pool.run(5.0)
    assert ing.controller is not None
    assert ing.controller.decisions >= 1
    # a 0.5s tick draining 8/turn over 64 queued FAR exceeds the 50ms
    # SLO: the budget must have grown off its default
    assert ing.controller.admit_max > 2


# --- wire + tracing + report ----------------------------------------------

def test_loadshed_wire_roundtrip():
    from plenum_tpu_torch.common.message_base import message_from_dict
    from plenum_tpu_torch.common.serialization import pack, unpack
    m = LoadShed(identifier="cli", req_id=7, reason=SHED_OVERLOAD,
                 retry_after=0.5)
    got = message_from_dict(unpack(pack(m.to_dict())))
    assert got == m
    with pytest.raises(Exception):
        LoadShed.from_dict({"op": "LOAD_SHED", "identifier": "x",
                            "req_id": 1, "reason": "r",
                            "retry_after": -1.0})


def test_ingress_spans_reach_tracer_and_waterfall():
    from plenum_tpu_torch.common import tracing
    from plenum_tpu_torch.tools.trace_report import assemble

    pool = Pool(config=FAST)
    cfg = FAST.replace(INGRESS_CLIENT_QUEUE_CAP=1, INGRESS_CONTROLLER=False)
    ingress = attach_ingress(pool, config=cfg)
    user = Ed25519Signer(seed=b"span-user".ljust(32, b"\0"))
    req = signed_nym(pool.trustee, user, req_id=1)
    shed_me = signed_nym(pool.trustee, Ed25519Signer(
        seed=b"span-shed".ljust(32, b"\0")), 2)
    for n in pool.names:
        ingress[n].submit(req.to_dict(), "cli1")
        ingress[n].submit(shed_me.to_dict(), "cli1")   # over the cap: shed
    pool.run(6.0)

    ring = list(pool.nodes["Alpha"].tracer.ring)
    stages = {e[1] for e in ring}
    assert {tracing.ING_ADMIT, tracing.ING_SHED, tracing.ING_AUTH,
            tracing.ING_VERDICT} <= stages
    shed = [e for e in ring if e[1] == tracing.ING_SHED]
    assert shed[0][2] == shed_me.digest
    assert shed[0][3]["reason"] == SHED_CLIENT_CAP

    # the assembled waterfall attributes the front door as a stage
    report = assemble([pool.nodes[n].tracer.snapshot() for n in pool.names])
    wf = report["requests"][req.digest]["Alpha"]
    assert "front_door" in wf["stages"]
    assert "front_door" in report["attribution"]


def test_metrics_report_ingress_section():
    from plenum_tpu_torch.common.metrics import KvMetricsCollector
    from plenum_tpu_torch.storage.kv_memory import KvMemory
    from plenum_tpu_torch.tools.metrics_report import derive_summary, fold_rows

    pool = Pool(config=FAST)
    node = pool.nodes["Alpha"]
    kv = KvMemory()
    collector = KvMetricsCollector(kv, now=pool.timer.get_current_time)
    cfg = FAST.replace(INGRESS_CLIENT_QUEUE_CAP=2, INGRESS_CONTROLLER=True,
                       INGRESS_CONTROL_INTERVAL=0.1)
    ing = IngressPlane(node, config=cfg, metrics=collector, tick=False)
    for i in range(6):
        ing.submit(signed_nym(pool.trustee, Ed25519Signer(
            seed=(b"mr%02d" % i).ljust(32, b"\0")), 900 + i).to_dict(),
            f"c{i % 2}")                 # 2 clients, cap 2 -> sheds
    pool.timer.advance(0.2)
    ing.service()
    collector.flush()
    folds = fold_rows(collector.read_rows())
    summary = derive_summary(folds, span_s=10.0)
    ing_section = summary["ingress"]
    assert ing_section["admitted"] == 4
    assert ing_section["shed"] == 2
    assert ing_section["auth_batches"] == 1
    assert ing_section["auth_batch_mean"] == 4.0
    assert "queue_wait_ms_p95" in ing_section
    assert "controller" in ing_section


# --- observer read fan-out ------------------------------------------------

def test_observer_rejects_forged_multi_sig_anchor():
    """A Byzantine pusher can stall an observer's anchor but never move
    it: a tampered multi-sig fails MultiSignature.verify and is never
    adopted, so reads stay proofless instead of lying."""
    pool = Pool(config=FAST)
    obs = attach_observer(pool, f=1)
    user = Ed25519Signer(seed=b"forge-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)

    pushes = [(m, v) for v in pool.names for m, c in pool.client_msgs[v]
              if c == obs.client_id and isinstance(m, BatchCommitted)]
    assert len(pushes) >= 2
    import dataclasses
    for m, v in pushes:
        if m.multi_sig:
            forged = list(m.multi_sig)
            forged[1] = list(forged[1])[:-1]     # drop a participant
            m = dataclasses.replace(m, multi_sig=tuple(forged))
        obs.deliver_push(m, v)
    assert obs.batches_applied >= 1              # quorum still applies
    assert obs.gate.stats["ms_adopted"] == 0
    assert obs.gate.stats["ms_rejected"] >= 1
    # served read carries NO proof (never a forged anchor)
    q = Request("rdr", 5, {"type": GET_NYM, "dest": user.identifier})
    out = obs.gate.answer_batch([q])[0]
    from plenum_tpu_torch.reads import READ_PROOF
    assert isinstance(out, dict) and READ_PROOF not in out


def test_observer_push_quorum_tolerates_multi_sig_variation():
    """Honest validators attach DIFFERENT (all-valid) aggregations to the
    same batch; the f+1 content quorum must still converge."""
    pool = Pool(config=FAST)
    obs = attach_observer(pool, f=1)
    user = Ed25519Signer(seed=b"msvar-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    pool.run(6.0)
    pushes = [(m, v) for v in pool.names for m, c in pool.client_msgs[v]
              if c == obs.client_id and isinstance(m, BatchCommitted)]
    assert len(pushes) >= 2
    import dataclasses
    delivered = 0
    for i, (m, v) in enumerate(pushes[:2]):
        if m.multi_sig:
            # rotate the participant list: same sig, different list ORDER
            # (a legitimately different aggregation shape)
            ms = list(m.multi_sig)
            ms[1] = list(ms[1])[i:] + list(ms[1])[:i]
            m = dataclasses.replace(m, multi_sig=tuple(ms))
        delivered += 1
        obs.deliver_push(m, v)
    assert delivered == 2
    assert obs.batches_applied == 1              # 2 votes = f+1 quorum


def test_observer_anchor_lag_escalates_to_validator():
    """An observer whose anchor aged past the lag bound serves PROOFLESS;
    the two-tier driver escalates to a validator and the read still
    verifies — stale proofs are never served."""
    from plenum_tpu_torch.reads import READ_PROOF, SimReadDriver
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    pool = Pool(config=FAST)
    obs = attach_observer(pool, anchor_lag_max=5.0)
    user = Ed25519Signer(seed=b"lag-user".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, user, req_id=1))
    run_routed(pool, [obs], 6.0)
    assert obs.gate.stats["ms_adopted"] >= 1

    # age the anchor past the bound with NO new pushes
    pool.timer.advance(60.0)

    def submit(name, q):
        if name == obs.name:
            obs.handle_client_message(q.to_dict(), "rdr")
        else:
            pool.nodes[name].handle_client_message(q.to_dict(), "rdr")

    def collect(name):
        if name == obs.name:
            out = [m.result for m, _ in obs.sent if isinstance(m, Reply)]
            obs.sent.clear()
            return out
        out = [m.result for m, c in pool.client_msgs[name]
               if isinstance(m, Reply) and c == "rdr"]
        pool.client_msgs[name] = [
            (m, c) for m, c in pool.client_msgs[name]
            if not (isinstance(m, Reply) and c == "rdr")]
        return out

    driver = SimReadDriver(submit, collect, pool.run, pool.names,
                           pool_bls_keys(pool.names), freshness_s=1e12,
                           now=pool.timer.get_current_time,
                           observer_names=[obs.name])
    q = Request("rdr", 9, {"type": GET_NYM, "dest": user.identifier})
    res = driver.read(q)
    assert res is not None and res["data"]["verkey"] == user.verkey_b58
    assert READ_PROOF in res                     # proven BY THE VALIDATOR
    s = driver.stats
    assert s.observer_escalations == 1 and s.observer_ok == 0
    assert s.failovers == 1 and s.fallbacks == 0
    assert obs.gate.stats["stale_suppressed"] == 1


# --- the full 10k bench config, shrunk (slow) -----------------------------

@pytest.mark.slow
def test_bench_config7_ingress_end_to_end():
    """The acceptance bench config end to end at reduced scale: batched
    auth measured >> 1, observer-served verified reads, and the overload
    A/B (bounded+shedding vs unbounded inbox)."""
    from plenum_tpu_torch.tools.bench_configs import config7_ingress_10k
    out = config7_ingress_10k(n_clients=10_000, n_ops=300,
                              burst_clients=40, burst_per_client=6,
                              timeout=120.0, backend="cpu")
    assert "error" not in out, out
    assert out["reads_served"] > 0
    assert out["observer_served"] == out["reads_served"]
    assert out["writes_ordered"] == out["writes_submitted"]
    assert out["auth_batch_mean"] is not None
    ab = out["overload_ab"]
    assert ab["ingress"]["bounded"]
    assert ab["ingress"]["shed"] > 0
    assert ab["no_ingress"]["inbox_depth_after_burst"] == ab["no_ingress"]["burst"]
    assert ab["ingress"]["queue_depth_peak"] <= ab["ingress"]["watermark"]


# --- the plain K3 + K4 behind admission ------------------------------------

@pytest.mark.usefixtures("one_torch_thread")
def test_admission_batches_reach_the_plain_kernels():
    """On a `torch` pool the ingress plane's one submit_batch per tick
    goes through each node's authenticator to its supervised verifier on
    the kernels' plain versions; the writes order, and any hedge on the
    CPU (the supervisor's answer to a slow dispatch on a loaded host)
    agrees with them."""
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    pool = Pool(config=FAST.replace(crypto_backend="torch"))
    ingress = attach_ingress(pool)
    users = [Ed25519Signer(seed=(b"ing-torch-%d" % i).ljust(32, b"\0"))
             for i in range(3)]
    for i, user in enumerate(users):
        req = signed_nym(pool.trustee, user, req_id=800 + i)
        for n in pool.names:
            ingress[n].submit(req.to_dict(), "cli-t")
    pool.run(6.0)
    sizes = {pool.nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
             for n in pool.names}
    assert sizes == {1 + len(users)}, sizes
    for n in pool.names:
        assert ingress[n].stats["auth_items"] == len(users)
        sup = find_supervisor(
            pool.nodes[n].c.authenticator.core_authenticator.verifier)
        assert type(sup._device).__name__ == "TorchEd25519Verifier"
        assert sup.stats["device_items"] >= len(users)
        assert sup.stats["device_errors"] == sup.stats["verdict_forks"] == 0
