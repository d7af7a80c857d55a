"""The port's copy of tests/test_resilience.py, run on plenum_tpu_torch
(the sim pools' nodes on the CPU): WAN-degraded operation hardening:
jittered backoff (the TCP dial schedule also held to the reference's),
RTT-adaptive catchup pacing, the catchup progress watchdog, read-only
degradation, membership-aware bus filtering, key-rotation key-table
eviction, and the churn soak (tools/churn_soak.py).

The deterministic A/B here is the acceptance shape for the hardening:
the SAME seed, the SAME fault (catchup replies dropped for a window),
one arm on the legacy flat 5 s retry timer and one on the RTT-adaptive
backoff — flat misses the recovery deadline the adaptive path makes.
"""
from __future__ import annotations

import pytest

from plenum_tpu_torch.common.backoff import ExponentialBackoff, RttEstimator
from plenum_tpu_torch.common.node_messages import (CatchupRep, CatchupReq,
                                             DOMAIN_LEDGER_ID, LedgerStatus)
from test_torch_pool import CpuConfig as Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.network import Discard, match_dst, match_frm
from plenum_tpu_torch.network.sim_network import match_type

from test_torch_pool import Pool, signed_nym

QUIET = dict(Max3PCBatchWait=0.05,
             STATE_FRESHNESS_UPDATE_INTERVAL=600.0,
             STUCK_BEHIND_CHECK_FREQ=600.0,
             PerfCheckFreq=600.0)


# --- backoff / RTT primitives ----------------------------------------------


def test_exponential_backoff_bounds_growth_and_jitter():
    b = ExponentialBackoff(base=0.1, cap=1.0, jitter=0.5, salt="x")
    seq = [b.next() for _ in range(8)]
    for k, d in enumerate(seq):
        raw = min(0.1 * 2 ** k, 1.0)
        assert 0.5 * raw - 1e-9 <= d <= raw + 1e-9, (k, d)
    # truncation: late attempts hover at the cap band, not beyond
    assert seq[-1] <= 1.0


def test_backoff_desynchronizes_across_salts_and_replays_per_salt():
    a = ExponentialBackoff(base=0.1, cap=1.0, salt="Alpha->Beta")
    c = ExponentialBackoff(base=0.1, cap=1.0, salt="Gamma->Beta")
    seq_a = [a.next() for _ in range(8)]
    seq_c = [c.next() for _ in range(8)]
    assert seq_a != seq_c                     # no stampede lockstep
    replay = ExponentialBackoff(base=0.1, cap=1.0, salt="Alpha->Beta")
    assert [replay.next() for _ in range(8)] == seq_a
    # reset returns to the floor but keeps the jitter stream advancing
    a.reset()
    assert a.next() <= 0.1 + 1e-9


def test_tcp_dial_backoff_is_the_jittered_one():
    """The reconnect-stampede fix: two dialers' retry schedules differ,
    both bounded by RETRY_MIN doubling to RETRY_MAX."""
    from plenum_tpu_torch.network import tcp_stack
    a = tcp_stack._retry_backoff("Alpha", "Beta")
    g = tcp_stack._retry_backoff("Gamma", "Beta")
    seq_a = [a.next() for _ in range(6)]
    seq_g = [g.next() for _ in range(6)]
    assert seq_a != seq_g
    for k, d in enumerate(seq_a):
        raw = min(tcp_stack.RETRY_MIN * 2 ** k, tcp_stack.RETRY_MAX)
        assert (1 - tcp_stack.RETRY_JITTER) * raw - 1e-9 <= d <= raw + 1e-9


def test_tcp_dial_backoff_replays_the_references():
    """_retry_backoff salts its jitter with the dialer and the peer: the
    port's schedule for each pair is the reference's, delay for delay."""
    from plenum_tpu.network import tcp_stack as ref
    from plenum_tpu_torch.network import tcp_stack
    for dialer, peer in (("Alpha", "Beta"), ("Node1", "Node4")):
        ours = tcp_stack._retry_backoff(dialer, peer)
        theirs = ref._retry_backoff(dialer, peer)
        assert [ours.next() for _ in range(10)] == \
            [theirs.next() for _ in range(10)]
    assert (tcp_stack.RETRY_MIN, tcp_stack.RETRY_MAX,
            tcp_stack.RETRY_JITTER) == (ref.RETRY_MIN, ref.RETRY_MAX,
                                        ref.RETRY_JITTER)


def test_rtt_estimator_rfc6298_shape():
    r = RttEstimator()
    # no samples: fallback wins, clamped
    assert r.timeout(floor=0.1, cap=10.0, fallback=5.0) == 5.0
    assert r.timeout(floor=6.0, cap=10.0, fallback=5.0) == 6.0
    r.note(0.2)
    assert r.srtt == 0.2 and r.rttvar == 0.1
    # srtt + 4*rttvar = 0.6
    assert abs(r.timeout(floor=0.0, cap=10.0) - 0.6) < 1e-9
    for _ in range(50):
        r.note(0.2)                           # stable link: variance decays
    assert r.timeout(floor=0.0, cap=10.0) < 0.3
    r.note(-1.0)                              # clock skew: ignored
    assert r.samples == 51


# --- deterministic flat-vs-adaptive catchup A/B -----------------------------


def _catchup_ab_arm(adaptive: bool, seed: int = 31, heal_at: float = 1.0):
    """One arm: Delta partitioned while 2 txns order, healed, then its
    catchup runs with every CatchupRep TO Delta dropped for the first
    `heal_at` seconds — a lossy-WAN blip eating one request/reply
    exchange. -> sim seconds from catchup start to Delta fully synced
    (None if not synced within 25 s)."""
    config = Config(**QUIET, CATCHUP_ADAPTIVE_TIMEOUTS=adaptive,
                    CATCHUP_WATCHDOG_INTERVAL=600.0)
    pool = Pool(seed=seed, config=config)
    pool.net.set_latency(0.02, 0.1)
    users = [Ed25519Signer(seed=(b"ab-%d" % i).ljust(32, b"\0")[:32])
             for i in range(2)]
    part = [pool.net.add_rule(Discard(), match_dst("Delta")),
            pool.net.add_rule(Discard(), match_frm("Delta"))]
    others = [n for n in pool.names if n != "Delta"]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, i + 1), to=others)
    pool.run(6.0)
    sizes = {len_of(pool, n) for n in others}
    assert sizes == {3}, sizes               # genesis + 2, Delta at 1
    for rule in part:
        pool.net.remove_rule(rule)
    drop = pool.net.add_rule(Discard(), match_dst("Delta"),
                             match_type(CatchupRep))
    delta = pool.nodes["Delta"]
    t0 = pool.timer.get_current_time()
    delta.start_catchup()
    healed = False
    elapsed = 0.0
    while elapsed < 25.0:
        pool.run(0.25)
        elapsed += 0.25
        if not healed and elapsed >= heal_at:
            pool.net.remove_rule(drop)
            healed = True
        if len_of(pool, "Delta") >= 3 and not delta.leecher.is_running:
            return pool.timer.get_current_time() - t0
    return None


def len_of(pool, name):
    from test_torch_sim_fuzz import _domain_txns
    return len(_domain_txns(pool.nodes[name]))


def test_catchup_adaptive_beats_flat_timeout_deterministically():
    """Same seed, same fault (one catchup request/reply exchange eaten
    by the lossy link): the RTT-adaptive retry re-asks within a few
    measured round trips and completes; the flat 5 s timer sits out its
    full period first — at the recovery DEADLINE between them, flat has
    stalled where adaptive completed. THE acceptance A/B."""
    adaptive = _catchup_ab_arm(adaptive=True)
    flat = _catchup_ab_arm(adaptive=False)
    assert adaptive is not None, "adaptive arm never completed"
    assert flat is not None, "flat arm never completed (even eventually)"
    deadline = 4.0          # > heal + several RTTs, < the flat 5 s timer
    assert adaptive < deadline, (adaptive, flat)
    assert flat > deadline, (adaptive, flat)
    assert adaptive + 1.0 < flat, (adaptive, flat)


# --- catchup progress watchdog + provider switching ------------------------


def test_catchup_watchdog_kicks_then_restarts_a_stalled_round():
    config = Config(**QUIET, CATCHUP_WATCHDOG_INTERVAL=2.0,
                    CATCHUP_WATCHDOG_RESTART_KICKS=3)
    pool = Pool(seed=37, config=config)
    pool.net.set_latency(0.02, 0.1)
    users = [Ed25519Signer(seed=(b"wd-%d" % i).ljust(32, b"\0")[:32])
             for i in range(2)]
    part = [pool.net.add_rule(Discard(), match_dst("Delta")),
            pool.net.add_rule(Discard(), match_frm("Delta"))]
    others = [n for n in pool.names if n != "Delta"]
    for i, u in enumerate(users):
        pool.submit(signed_nym(pool.trustee, u, i + 1), to=others)
    pool.run(6.0)
    for rule in part:
        pool.net.remove_rule(rule)
    drop = pool.net.add_rule(Discard(), match_dst("Delta"),
                             match_type(CatchupRep))
    delta = pool.nodes["Delta"]
    delta.start_catchup()
    pool.run(9.0)            # several watchdog intervals, reps all dropped
    kicks = [e for e in delta.spylog if e[0] == "catchup_watchdog_kick"]
    assert kicks, "watchdog never fired on a frozen catchup"
    assert delta.leecher.is_running          # restarted, not wedged
    pool.net.remove_rule(drop)
    pool.run(10.0)
    assert len_of(pool, "Delta") >= 3
    assert not delta.leecher.is_running
    # stall accounting reached the metrics plane
    summary = delta.metrics.summary()
    from plenum_tpu_torch.common.metrics import MetricsName
    assert summary.get(MetricsName.CATCHUP_WATCHDOG_KICKS, {}).get("count")
    assert summary.get(MetricsName.CATCHUP_DURATION, {}).get("count")
    # the all-peers stall sidelined providers at least once
    switches = delta.leecher.round_stats()["provider_switches"]
    assert switches >= 1, delta.leecher.round_stats()


# --- graceful degradation: read-only instead of wedging ---------------------


def test_diverged_catchup_degrades_to_read_only_serving():
    config = Config(**QUIET, CATCHUP_MAX_DIVERGED_ROUNDS=2)
    pool = Pool(seed=41, config=config)
    user = Ed25519Signer(seed=b"deg-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(6.0)
    assert len_of(pool, "Delta") == 2

    delta = pool.nodes["Delta"]
    # simulate a catchup round that ended in divergence, twice (the rep
    # service sets .diverged when every provider's chunk conflicts with
    # the f+1-agreed target — fabricating that end-to-end needs >f
    # correlated amnesia, outside the sim's fault model, so the node
    # seam is driven directly)
    delta.start_catchup()                    # pauses ordering
    delta.leecher.stop()
    lid = delta.leecher._order[0]
    delta.leecher.leechers[lid].rep.diverged = True
    delta._on_catchup_complete(None)         # diverged round 1: retry
    assert not delta.read_only_degraded
    delta._on_catchup_complete(None)         # diverged round 2: degrade
    assert delta.read_only_degraded
    assert any(e[0] == "degraded_read_only" for e in delta.spylog)

    # degraded = no new catchup rounds, no ordering participation...
    delta.start_catchup()
    assert not delta.leecher.is_running
    user2 = Ed25519Signer(seed=b"deg-user2".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user2, 2))
    pool.run(8.0)
    survivors = [n for n in pool.names if n != "Delta"]
    assert {len_of(pool, n) for n in survivors} == {3}
    assert len_of(pool, "Delta") == 2        # parked, not participating

    # ...but verified reads still serve at the LAST ANCHORED root
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.reads import READ_PROOF
    res = delta.read_plane.answer(
        Request("ro-cli", 9, {"type": GET_NYM, "dest": user.identifier}))
    assert res["data"]["verkey"] == user.verkey_b58
    env = res.get(READ_PROOF)
    assert env is not None and env.get("multi_signature"), \
        "degraded node stopped serving anchored proofs"
    info = delta.validator_info()
    assert info["read_only_degraded"] is True


# --- membership-aware bus filter (catchup-to-join) --------------------------


def test_known_non_validator_is_served_catchup_to_join():
    """A pool-ledger-known but demoted node that restarts from genesis
    can catch up from the validators (the joiner filter admits its
    LedgerStatus/CatchupReq), while its replies/votes stay filtered."""
    names = ["Alpha", "Beta", "Gamma", "Delta", "Eps"]
    pool = Pool(names=names, validator_names=names[:4],
                config=Config(**QUIET))
    user = Ed25519Signer(seed=b"join-user".ljust(32, b"\0")[:32])
    pool.submit(signed_nym(pool.trustee, user, 1))
    pool.run(6.0)
    assert len_of(pool, "Alpha") == 2

    # Eps restarts with NO memory (fresh from genesis, still demoted)
    pool.crash_node("Eps")
    pool.start_node("Eps")
    pool.net.connect_all()
    eps = pool.nodes["Eps"]
    assert len_of(pool, "Eps") == 1
    assert "Eps" not in pool.nodes["Alpha"].validators

    # the joiner filter: queries pass, replies/votes do not
    alpha = pool.nodes["Alpha"]
    req = CatchupReq(ledger_id=DOMAIN_LEDGER_ID, seq_no_start=1,
                     seq_no_end=2, catchup_till=2)
    assert alpha._accept_joiner_msg(req, "Eps")
    assert alpha._accept_joiner_msg(
        LedgerStatus(ledger_id=DOMAIN_LEDGER_ID, txn_seq_no=1,
                     merkle_root="00", view_no=None, pp_seq_no=None), "Eps")
    assert not alpha._accept_joiner_msg(
        LedgerStatus(ledger_id=DOMAIN_LEDGER_ID, txn_seq_no=1,
                     merkle_root="00", view_no=None, pp_seq_no=None,
                     is_reply=True), "Eps")
    assert not alpha._accept_joiner_msg(
        CatchupRep(ledger_id=DOMAIN_LEDGER_ID, txns={}, cons_proof=()),
        "Eps")
    assert not alpha._accept_joiner_msg(req, "NotInLedger")

    eps.start_catchup()
    pool.run(15.0)
    assert len_of(pool, "Eps") == 2, "joiner was not served catchup"
    assert not eps.leecher.is_running


# --- key rotation: stale-key commits + key-table eviction -------------------


def test_rotated_out_bls_key_is_excluded_without_poisoning_quorum():
    """A validator whose ledger BLS key rotated but whose process still
    signs with the OLD key: its commits fail the batch check and are
    culprit-named (the culprit path) — they never count toward the multi-sig
    quorum and never poison the batch for honest signers; the pool keeps
    ordering and, after the operator re-keys, the node rejoins
    aggregates. The rotated-out key is also evicted from every node's
    BLS key table."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.execution.txn import NODE

    pool = Pool(seed=53, config=Config(**QUIET))
    u0 = Ed25519Signer(seed=b"rot2-u0".ljust(32, b"\0"))
    pool.submit(signed_nym(pool.trustee, u0, 1))
    pool.run(5.0)

    old_pk = BlsCryptoSigner(seed=b"Gamma".ljust(32, b"\0")[:32]).pk
    # the old key is warm in the verifiers' key tables
    assert any(old_pk in node.replicas.master.bls._verifier._vk_cache
               for node in pool.nodes.values())

    new_signer = BlsCryptoSigner(seed=b"gamma-rot2".ljust(32, b"\0")[:32])
    req = Request(pool.trustee.identifier, 10,
                  {"type": NODE, "dest": "GammaDest",
                   "data": {"blskey": new_signer.pk,
                            "blskey_pop": new_signer.generate_pop()}})
    req.signature = pool.trustee.sign_b58(req.signing_bytes())
    pool.submit(req)
    pool.run(5.0)
    for name, node in pool.nodes.items():
        assert node.pool_manager.bls_key_of("Gamma") == new_signer.pk
        # eviction: the dead key left the key table on every node
        assert old_pk not in node.replicas.master.bls._verifier._vk_cache, \
            name
        ms = node.metrics.summary()
        from plenum_tpu_torch.common.metrics import MetricsName
        assert ms.get(MetricsName.MEMBERSHIP_KEY_ROTATIONS, {}).get("sum")

    # Gamma's signer is STALE: its commits carry old-key signatures
    for i in range(2, 5):
        u = Ed25519Signer(seed=(b"rot2-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, u, i))
        pool.run(4.0)
    sizes = {len_of(pool, n) for n in pool.names}
    assert sizes == {5}, sizes               # pool stayed live throughout
    for name in pool.names:
        node = pool.nodes[name]
        assert node.master_replica.view_no == 0, name   # no VC storm
        if name == "Gamma":
            continue
        bls = node.replicas.master.bls
        # stale-key commits were culprit-named, and the post-rotation
        # aggregates exclude Gamma rather than dying
        assert any("Gamma" in bad for bad in bls._known_bad.values()), name
        post = [m for m in bls._recent_multi_sigs.values()]
        assert post and all("Gamma" not in m.participants
                            for m in post[-2:]), name

    # operator re-keys Gamma: recovery — fresh aggregates include it
    pool.nodes["Gamma"].replicas.master.bls._signer = new_signer
    for i in range(5, 8):
        u = Ed25519Signer(seed=(b"rot2-u%d" % i).ljust(32, b"\0"))
        pool.submit(signed_nym(pool.trustee, u, i))
        pool.run(4.0)
    assert {len_of(pool, n) for n in pool.names} == {8}
    ms = pool.nodes["Alpha"].replicas.master.bls._recent_multi_sigs
    assert any("Gamma" in m.participants for m in list(ms.values())[-2:])


def test_crypto_plane_key_eviction_seams():
    """evict_key drops exactly the named key from each key table: the
    CPU verifier's parsed-key cache, the device verifier's staged
    quarter-point rows, the BLS decoded-G2 table — and the pipeline
    forwards to its inners."""
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, BlsCryptoVerifier
    from plenum_tpu_torch.crypto.ed25519 import (CpuEd25519Verifier,
                                                 TorchEd25519Verifier)
    from plenum_tpu_torch.parallel.pipeline import CryptoPipeline

    signer = Ed25519Signer(seed=b"evict-me".ljust(32, b"\0"))
    vk = signer.verkey
    cpu = CpuEd25519Verifier()
    # the parsed-key cache only fills on the cryptography-backed path
    # (this container runs the pure-Python fallback) — seed it directly:
    # eviction semantics are what's under test, not the backend
    if hasattr(cpu, "_pk_cache"):
        cpu._pk_cache[vk] = object()
        cpu.evict_key(vk)
        assert vk not in cpu._pk_cache

    dev = TorchEd25519Verifier(device="cpu")
    dev._neg_a_limbs(vk)
    assert vk in dev._pt_cache
    dev.evict_key(vk)
    assert vk not in dev._pt_cache

    bls_pk = BlsCryptoSigner(seed=b"evict-bls".ljust(32, b"\0")[:32]).pk
    bls = BlsCryptoVerifier()
    bls._pk(bls_pk)
    assert bls_pk in bls._vk_cache
    bls.evict_key(bls_pk)
    assert bls_pk not in bls._vk_cache

    pipe = CryptoPipeline(ed_inner=cpu, bls_inner=bls)
    cpu._pk_cache[vk] = object()
    bls._pk(bls_pk)
    pipe.evict_key(vk)
    pipe.evict_key(bls_pk)
    assert vk not in cpu._pk_cache and bls_pk not in bls._vk_cache


# --- metrics_report: view_change / catchup / membership sections ------------


def test_metrics_report_churn_sections():
    from plenum_tpu_torch.tools.metrics_report import derive_summary

    def fold(count=1, total=0.0, samples=None, last=None, mn=None, mx=None):
        return {"count": count, "sum": total, "mean":
                (total / count) if count else None, "min": mn, "max": mx,
                "last": last, "flushes": 1,
                **({"samples": samples} if samples else {})}

    folds = {
        "view_change.duration": fold(3, 6.0, samples=[1.0, 2.0, 3.0]),
        "consensus.vc_detect_to_vote": fold(3, 1.5),
        "catchup.duration": fold(2, 9.0, samples=[4.0, 5.0]),
        "catchup.rounds": fold(2, 7.0, samples=[3.0, 4.0]),
        "catchup.provider_switches": fold(1, 2.0),
        "catchup.watchdog_kicks": fold(4, 4.0),
        "catchup.degraded": fold(1, 1.0, mx=1.0),
        "membership.pool_changes": fold(5, 5.0),
        "membership.validators": fold(5, 23.0, last=5.0, mn=4.0, mx=5.0),
        "membership.key_rotations": fold(2, 2.0),
    }
    out = derive_summary(folds, span_s=100.0)
    vc = out["view_change"]
    assert vc["episodes"] == 3
    assert vc["duration_s_p50"] == 2.0 and vc["duration_s_p95"] == 3.0
    assert vc["detect_to_vote_s"] == 0.5
    cu = out["catchup"]
    assert cu["completed"] == 2 and cu["duration_s_p95"] == 5.0
    assert cu["provider_switches"] == 2 and cu["watchdog_kicks"] == 4
    assert cu["read_only_degraded"] is True
    mem = out["membership"]
    assert mem == {"pool_changes": 5, "validators_last": 5,
                   "validators_min": 4, "validators_max": 5,
                   "key_rotations": 2}


# --- churn soak: bounded growth under churn ---------------------------------


def test_churn_soak_smoke_bounded_and_converged():
    """Fast tier-1 slice of the 10-minute churn soak: two churn waves
    over lossy_wan, every bounded-growth cap respected, pool converged —
    and the history plane wired in: growth verdicts on every footprint
    gauge with zero unbounded_growth alerts, and a queryable,
    downsampled history ring covering the run."""
    from plenum_tpu_torch.tools.churn_soak import run_churn_soak
    out = run_churn_soak(seconds=40.0, seed=3, crypto_backend="cpu")
    assert out["bounds_ok"], (out["violations"], out["growth_unexpected"])
    assert out["converged"], out["ledger_sizes"]
    assert out["waves"] >= 2 and "demote" in out["events"][0]
    # every footprint gauge got a growth verdict, none alerted
    for gauge in ("stashed_entries", "flight_ring_entries",
                  "bls_sig_entries", "kv_entries"):
        assert gauge in out["growth_verdicts"], out["growth_verdicts"]
    assert out["growth_alerts"] == []
    # the ring recorded one row per pool interval, downsampled on query
    assert out["history_seq"] >= out["waves"]
    assert 0 < len(out["history_tail"]) <= 12
    assert out["history_tail"][0]["seq"] < out["history_tail"][-1]["seq"]
    # the reference's soak, the same seed: the same churn, ledgers and
    # telemetry rows
    from plenum_tpu.tools.churn_soak import run_churn_soak as ref_soak
    from test_torch_pool import fresh_bls_caches
    with fresh_bls_caches():
        ref = ref_soak(seconds=40.0, seed=3)
    keys = ("waves", "events", "txns_submitted", "converged",
            "ledger_sizes", "bounds_ok", "history_seq")
    assert {k: out[k] for k in keys} == {k: ref[k] for k in keys}


def test_churn_soak_injected_leak_pages_once_naming_gauge():
    """The detector self-test: an injected unbounded gauge (leak_rate)
    raises EXACTLY ONE edge-triggered unbounded_growth page naming the
    gauge, while every real structure stays quiet."""
    from plenum_tpu_torch.tools.churn_soak import run_churn_soak
    out = run_churn_soak(seconds=40.0, seed=3, leak_rate=8.0,
                         crypto_backend="cpu")
    assert out["bounds_ok"], (out["violations"], out["growth_unexpected"])
    pages = out["growth_alerts"]
    assert len(pages) == 1, pages
    assert pages[0]["subject"] == "leaky_stash"
    assert pages[0]["detail"]["gauge"] == "leaky_stash"
    assert out["growth_verdicts"]["leaky_stash"]["verdict"] == "growing"


@pytest.mark.slow
@pytest.mark.soak
def test_churn_soak_ten_minutes():
    """The full bounded-growth soak: 10 SIMULATED minutes of sustained
    writes + one churn event per 20 s wave (demote/promote, BLS
    rotation, primary demotion) over lossy_wan. Fails on the first
    bound violation or unbounded_growth page, so a leak names its
    structure and its wave; the history ring must hold a queryable,
    downsampled record of the whole run."""
    from plenum_tpu_torch.tools.churn_soak import run_churn_soak
    out = run_churn_soak(seconds=600.0, seed=11, crypto_backend="cpu")
    assert out["bounds_ok"], (out["violations"], out["growth_unexpected"])
    assert out["converged"], out["ledger_sizes"]
    assert out["growth_alerts"] == []
    # 600 sim-seconds at 1 s telemetry intervals: the ring saw the whole
    # run (seq counts every row) while holding at most HISTORY_MAX_SLOTS
    assert out["history_seq"] >= 500
    assert out["history_rows"] <= 512
    tail = out["history_tail"]
    assert 0 < len(tail) <= 12 and tail[0]["seq"] < tail[-1]["seq"]


@pytest.mark.parametrize("name", [
    "test_catchup_adaptive_beats_flat_timeout_deterministically",
    "test_catchup_watchdog_kicks_then_restarts_a_stalled_round",
    "test_diverged_catchup_degrades_to_read_only_serving",
    "test_known_non_validator_is_served_catchup_to_join",
    "test_rotated_out_bls_key_is_excluded_without_poisoning_quorum",
])
def test_pools_end_as_the_references(name, tmp_path):
    """The case above and the reference's case of the same name, each
    run once: every pool they build ends with the same domain ledger and
    state on every node."""
    import test_resilience as ref
    from test_torch_pool import held_to_reference
    held_to_reference(globals()[name], getattr(ref, name), tmp_path)
