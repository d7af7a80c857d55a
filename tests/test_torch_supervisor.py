"""The port's plane supervisor (plenum_tpu_torch/parallel/supervisor.py +
faults.py), held to the reference's cases (tests/test_supervisor.py):
breaker lifecycle, re-warm before re-admission, flap hysteresis, adaptive
deadlines with hedged CPU fallback (no-fork invariant) and backpressure,
driven by the deterministic fault injector on an injected clock. The two
cases against a live crypto service wait for the service's port (ROADMAP
A6). Then one seeded script through both packages' supervisors, and the
port's own default: the card's verifier comes bare."""
from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch

from plenum_tpu_torch.crypto.ed25519 import (CpuEd25519Verifier,
                                             Ed25519Signer, make_verifier)
from plenum_tpu_torch.parallel.faults import FaultPlan, FaultyVerifier
from plenum_tpu_torch.parallel.supervisor import (CLOSED, HALF_OPEN, OPEN,
                                                  CircuitBreaker,
                                                  DeadlineBudget,
                                                  SupervisedVerifier,
                                                  find_supervisor)

_signer = Ed25519Signer(seed=b"supervisor-tests".ljust(32, b"\0"))


def _items(tag: bytes, n: int = 3, bad: int = -1):
    out = []
    for i in range(n):
        msg = tag + b"-%d" % i
        sig = _signer.sign(msg if i != bad else msg + b"!")
        out.append((msg, sig, _signer.verkey))
    return out


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _plane(fail_threshold=2, cooldown=1.0, **budget_kw):
    clock = _Clock()
    dev = FaultyVerifier(CpuEd25519Verifier(), now=clock)
    sup = SupervisedVerifier(
        dev, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=fail_threshold,
                               cooldown=cooldown, now=clock),
        budget=DeadlineBudget(base=0.3, min_s=0.2, warm_max=1.0,
                              cold_max=1.0, **budget_kw),
        now=clock)
    return clock, dev, sup


# --- breaker lifecycle ------------------------------------------------------


def test_closed_to_open_on_k_consecutive_deadline_misses():
    clock, dev, sup = _plane(fail_threshold=2)
    assert sup.verify_batch(_items(b"warm")).all()
    assert sup.breaker.state == CLOSED
    dev.wedge()
    for i in range(2):
        tok = sup.submit_batch(_items(b"wedged-%d" % i))
        assert tok.kind == "dev"
        clock.advance(2.0)                       # past the deadline budget
        verdicts = sup.collect_batch(tok, wait=False)
        assert verdicts is not None and verdicts.all()   # hedged, correct
    assert sup.breaker.state == OPEN
    assert sup.breaker.opens == 1
    assert sup.stats["deadline_misses"] == 2
    # open circuit: dispatch routes to CPU INSTANTLY (no device submit)
    before = dev.submits
    tok = sup.submit_batch(_items(b"instant"))
    assert tok.kind == "cpu" and dev.submits == before
    assert sup.collect_batch(tok).all()
    assert sup.stats["open_circuit_fallbacks"] >= 1


def test_device_errors_also_trip_the_breaker():
    clock, dev, sup = _plane(fail_threshold=3)
    dev.drop()                                  # connection refused
    for i in range(3):
        assert sup.verify_batch(_items(b"drop-%d" % i)).all()
    assert sup.breaker.state == OPEN
    assert sup.stats["device_errors"] == 3


def test_half_open_probe_rewarns_before_readmitting():
    clock, dev, sup = _plane(fail_threshold=1, cooldown=1.0)
    dev.corrupt()
    assert sup.verify_batch(_items(b"c")).all()          # error -> open
    assert sup.breaker.state == OPEN
    dev.heal()
    clock.advance(1.5)                                   # cooldown elapsed
    sup.submit_batch(_items(b"trigger"))                 # starts the probe
    assert sup.breaker.state in (HALF_OPEN, CLOSED)
    assert dev.rewarms == 1, "re-warm must precede the probe dispatch"
    sup.submit_batch(_items(b"poll"))                    # probe lands
    assert sup.breaker.state == CLOSED
    # the device is genuinely re-admitted
    tok = sup.submit_batch(_items(b"back"))
    assert tok.kind == "dev" and sup.collect_batch(tok).all()


def test_probe_verdict_must_be_correct_not_just_present():
    """A device that answers but answers WRONG (all-True garbage) must not
    be re-admitted: the probe carries a known-bad signature."""

    class _LyingVerifier(CpuEd25519Verifier):
        def verify_batch(self, items):
            return np.ones(len(items), dtype=bool)

    clock = _Clock()
    dev = FaultyVerifier(_LyingVerifier(), now=clock)
    sup = SupervisedVerifier(
        dev, fallback=CpuEd25519Verifier(),
        breaker=CircuitBreaker(fail_threshold=1, cooldown=1.0, now=clock),
        budget=DeadlineBudget(base=0.3, min_s=0.2, warm_max=1.0,
                              cold_max=1.0),
        now=clock)
    dev.drop()
    sup.verify_batch(_items(b"x"))
    assert sup.breaker.state == OPEN
    dev.heal()
    clock.advance(1.5)
    sup.submit_batch(_items(b"t1"))          # probe starts
    sup.submit_batch(_items(b"t2"))          # probe lands: [True, True] != expected
    assert sup.breaker.state == OPEN, "lying device must stay quarantined"
    assert sup.stats["probe_failures"] >= 1


def test_flap_hysteresis_doubles_cooldown_and_decays():
    clock, dev, sup = _plane(fail_threshold=1, cooldown=1.0)
    base = sup.breaker.cooldown

    def flap_once():
        dev.wedge()
        tok = sup.submit_batch(_items(b"f%f" % clock.t))
        clock.advance(2.0)
        sup.collect_batch(tok, wait=False)            # miss -> open
        assert sup.breaker.state == OPEN
        dev.heal()
        clock.advance(sup.breaker.cooldown + 0.1)
        sup.submit_batch(_items(b"p%f" % clock.t))    # probe starts
        sup.submit_batch(_items(b"q%f" % clock.t))    # probe lands -> close
        assert sup.breaker.state == CLOSED

    flap_once()
    after_one = sup.breaker.cooldown          # first open: base cooldown
    flap_once()
    after_two = sup.breaker.cooldown
    flap_once()
    after_three = sup.breaker.cooldown
    # every RE-open (an open before the decay window passed) doubles the
    # probe cooldown: a flapping relay faces exponentially rarer probes,
    # not a thrash loop
    assert after_one == base
    assert after_two == base * 2
    assert after_three == base * 4
    # hysteresis decay: a long run of healthy traffic restores the base
    for i in range(sup.breaker.reset_after + 1):
        assert sup.verify_batch(_items(b"ok-%d" % i, n=1)).all()
    assert sup.breaker.cooldown == base


def test_failed_probe_reopens_with_longer_cooldown():
    clock, dev, sup = _plane(fail_threshold=1, cooldown=1.0)
    dev.wedge()
    tok = sup.submit_batch(_items(b"w"))
    clock.advance(2.0)
    sup.collect_batch(tok, wait=False)
    assert sup.breaker.state == OPEN
    clock.advance(1.5)                       # still wedged: probe will hang
    sup.submit_batch(_items(b"t"))           # probe starts (lost in wedge)
    assert sup.breaker.state == HALF_OPEN
    clock.advance(2.0)                       # probe deadline passes
    sup.submit_batch(_items(b"u"))           # reopen, cooldown doubled
    assert sup.breaker.state == OPEN
    assert sup.breaker.cooldown == 2.0
    assert sup.stats["probe_failures"] == 1


# --- hedged dispatch + no-fork invariant ------------------------------------


def test_hedged_race_verdicts_identical_per_item():
    """Device delayed past its budget: the CPU hedge answers; when the
    device verdict finally lands it is reaped and compared — identical
    per item (including the known-bad one), zero forks."""
    clock, dev, sup = _plane(fail_threshold=5)
    items = _items(b"hedge", n=5, bad=2)
    expected = [True, True, False, True, True]
    dev.delay(3.0)                            # longer than any budget
    tok = sup.submit_batch(items)
    assert sup.collect_batch(tok, wait=False) is None   # still in flight
    clock.advance(1.5)                        # past deadline
    verdicts = sup.collect_batch(tok, wait=False)
    assert list(verdicts) == expected         # CPU hedge verdict, correct
    assert sup.stats["hedge_wins"] == 1
    # the late device verdict lands; the reaper must compare and agree
    clock.advance(5.0)
    dev.heal()
    sup.submit_batch(_items(b"reap"))         # drives the zombie reaper
    assert sup.stats["late_landings"] == 1
    assert sup.stats["verdict_forks"] == 0


def test_blocking_collect_hedges_at_deadline_real_clock():
    """Wall-clock: a blocking collect on a wedged device returns the CPU
    verdict within the deadline budget — measured, not slept-and-hoped."""
    dev = FaultyVerifier(CpuEd25519Verifier())
    sup = SupervisedVerifier(
        dev, fallback=CpuEd25519Verifier(),
        budget=DeadlineBudget(base=0.4, min_s=0.3, warm_max=0.5,
                              cold_max=0.5))
    items = _items(b"block", n=4, bad=1)
    dev.wedge()
    t0 = time.monotonic()
    verdicts = sup.verify_batch(items)
    elapsed = time.monotonic() - t0
    assert list(verdicts) == [True, False, True, True]
    assert elapsed < 2.0, f"stall {elapsed:.2f}s exceeded the budget"
    assert sup.stats["hedge_wins"] == 1
    assert sup.stats["max_stall_s"] <= sup.stats["max_budget_s"] + 0.5


# --- backpressure -----------------------------------------------------------


def test_backpressure_watermark_routes_to_cpu():
    clock, dev, sup = _plane()
    sup.max_outstanding_bytes = 400
    dev.delay(10.0)                           # keep dispatches in flight
    big = _items(b"x" * 100, n=3)             # ~300+ bytes over watermark
    t1 = sup.submit_batch(big)
    assert t1.kind == "dev"
    t2 = sup.submit_batch(big)
    assert t2.kind == "cpu", "past the watermark new batches go straight to CPU"
    assert sup.stats["backpressure_fallbacks"] == 1
    assert sup.collect_batch(t2).all()


# --- deadline budget --------------------------------------------------------


def test_deadline_budget_cold_then_warm_ceiling():
    b = DeadlineBudget(base=1.0, per_item_initial=0.5, margin=2.0,
                       min_s=0.5, warm_max=10.0, cold_max=300.0)
    # cold: a first dispatch may sit behind a multi-minute compile
    assert b.budget(1000) == 300.0
    b.record(1000, 2.0)                       # first success: warmed
    assert b.budget(1000) <= 10.0
    # p99 of observed per-item cost now drives the estimate
    assert b.per_item_p99() == pytest.approx(0.002)
    assert b.budget(100) == pytest.approx(1.0 + 100 * 0.002 * 2.0)


def test_deadline_budget_scales_with_batch_size():
    b = DeadlineBudget(base=0.5, margin=4.0, min_s=0.25, warm_max=30.0)
    for _ in range(10):
        b.record(100, 0.5)                    # 5 ms/item observed
    assert b.budget(10) < b.budget(1000)
    assert b.budget(1000) == pytest.approx(0.5 + 1000 * 0.005 * 4.0)


# --- fault injector determinism ---------------------------------------------


def test_fault_plan_is_pure_function_of_seed():
    for seed in (0, 1, 7, 12345):
        a, b = FaultPlan.from_seed(seed), FaultPlan.from_seed(seed)
        assert a.windows == b.windows
    assert FaultPlan.from_seed(1).windows != FaultPlan.from_seed(2).windows


def test_fault_plan_drives_modes_by_clock():
    plan = FaultPlan([(1.0, 2.0, "wedge"), (3.0, 4.0, "drop")])
    clock = _Clock()
    dev = FaultyVerifier(CpuEd25519Verifier(), plan=plan, now=clock)
    assert dev.mode() == "ok"
    clock.t = 1.5
    assert dev.mode() == "wedge"
    clock.t = 2.5
    assert dev.mode() == "ok"
    clock.t = 3.5
    with pytest.raises(ConnectionError):
        dev.submit_batch(_items(b"planned"))


def test_wedge_loses_inflight_tokens_even_after_heal():
    clock = _Clock()
    dev = FaultyVerifier(CpuEd25519Verifier(), now=clock)
    tok = dev.submit_batch(_items(b"inflight"))
    dev.wedge()
    dev.heal()
    # the reply died with the wedge; it must never resolve
    assert dev.collect_batch(tok, wait=False) is None
    with pytest.raises(ConnectionError):
        dev.collect_batch(tok, wait=True)


# --- factory + wiring -------------------------------------------------------


def test_make_verifier_wraps_device_backends(monkeypatch):
    for backend, cls in (("torch", "TorchEd25519Verifier"),
                         ("torch-sharded", "ShardedTorchEd25519Verifier")):
        v = make_verifier(backend, min_batch=8)
        assert isinstance(v, SupervisedVerifier)
        assert type(v._device).__name__ == cls
        if backend == "torch-sharded":
            # only the sharded verifier pads; the single-device one
            # takes no min_batch
            assert v._device._min_batch == 8
        assert find_supervisor(v) is v
        # bare escape hatch, by argument and by the ops variable
        v2 = make_verifier(backend, min_batch=8, supervised=False)
        assert not isinstance(v2, SupervisedVerifier)
        monkeypatch.setenv("PLENUM_CRYPTO_SUPERVISOR", "0")
        assert not isinstance(make_verifier(backend), SupervisedVerifier)
        monkeypatch.delenv("PLENUM_CRYPTO_SUPERVISOR")
    # cpu stays bare: there is nothing to supervise
    assert not isinstance(make_verifier("cpu"), SupervisedVerifier)


def test_make_verifier_leaves_the_card_bare(monkeypatch):
    """On the card the verifier comes bare unless a caller opts in: a
    failed launch raises instead of turning into CPU verdicts. Its
    kernels are built first, so a failed build raises from make_verifier
    and never reaches a supervisor. (No card here: the availability
    check and the build are stood in for.)"""
    from plenum_tpu_torch import ops
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ops, "build",
                        lambda names: built.append(tuple(names)) or {})
    v = make_verifier("cuda", min_batch=8)
    assert type(v).__name__ == "TorchEd25519Verifier"
    assert v.device.type == "cuda" and built == [("ed25519",)]
    opted = make_verifier("cuda", supervised=True)
    assert isinstance(opted, SupervisedVerifier)
    assert opted._device.device.type == "cuda"

    def failed_build(names):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(ops, "build", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        make_verifier("cuda", supervised=True)


# --- the same seeded script through both packages' supervisors --------------

_SCRIPT_SIGNER = Ed25519Signer(seed=b"supervisor-script".ljust(32, b"\0"))
_SCRIPT_ITEMS = []
for _i in range(24):
    _msg = b"script-%d" % _i
    _sig = _SCRIPT_SIGNER.sign(_msg)
    _SCRIPT_ITEMS.append((_msg if _i % 5 else _msg + b"!", _sig,
                          _SCRIPT_SIGNER.verkey))


def _supervisor_script(cpu_mod, faults_mod, sup_mod, seed):
    """Submits, polls, recovery pumps and a final blocking drain on an
    injected clock, against a seeded FaultPlan of wedges, drops,
    corruptions and delays, with a small in-flight watermark and short
    deadlines; -> every verdict, the breaker's state after each step, the
    fault injector's counters and supervisor_stats()."""
    rng = random.Random(seed)
    clock = _Clock()
    plan = faults_mod.FaultPlan.from_seed(
        seed, horizon=30.0, n_faults=5,
        modes=("wedge", "drop", "corrupt", "delay"),
        min_len=0.5, max_len=3.0)
    dev = faults_mod.FaultyVerifier(cpu_mod.CpuEd25519Verifier(), plan=plan,
                                    now=clock, delay_s=0.3)
    sup = sup_mod.SupervisedVerifier(
        dev, fallback=cpu_mod.CpuEd25519Verifier(),
        breaker=sup_mod.CircuitBreaker(fail_threshold=2, cooldown=1.0,
                                       now=clock),
        budget=sup_mod.DeadlineBudget(base=0.02, per_item_initial=0.005,
                                      margin=2.0, min_s=0.02, warm_max=0.1,
                                      cold_max=0.2),
        max_outstanding_bytes=600, now=clock)
    out = {"verdicts": [], "states": []}
    pending = []
    for _ in range(160):
        clock.t += rng.uniform(0.0, 0.35)
        act = rng.random()
        if act < 0.45 or not pending:
            items = rng.sample(_SCRIPT_ITEMS, rng.randint(1, 4))
            pending.append(sup.submit_batch(items))
        elif act < 0.9:
            tok = pending.pop(rng.randrange(len(pending)))
            got = sup.collect_batch(tok, wait=False)
            if got is None:
                pending.append(tok)
                out["verdicts"].append(None)
            else:
                out["verdicts"].append(np.asarray(got).tolist())
        else:
            sup.pump_recovery()
        out["states"].append(sup.breaker.state)
    for tok in pending:
        out["verdicts"].append(
            np.asarray(sup.collect_batch(tok, wait=True)).tolist())
    out["injector"] = (dev.submits, dev.rewarms, dev.faults_served)
    out["stats"] = sup.supervisor_stats()
    return out


@pytest.mark.parametrize("seed", [1, 11])
def test_supervisor_matches_reference_on_one_seeded_script(seed):
    """The port's supervisor and fault injector against the reference's:
    the same script gives the same verdicts, breaker states, injector
    counters and the whole supervisor_stats() dict. The script reaches
    every route: device errors, deadline misses and hedges, backpressure,
    open-circuit fallbacks and probes."""
    from plenum_tpu.crypto import ed25519 as ref_ed
    from plenum_tpu.parallel import faults as ref_faults
    from plenum_tpu.parallel import supervisor as ref_sup
    from plenum_tpu_torch.crypto import ed25519 as port_ed
    from plenum_tpu_torch.parallel import faults as port_faults
    from plenum_tpu_torch.parallel import supervisor as port_sup
    ref = _supervisor_script(ref_ed, ref_faults, ref_sup, seed)
    port = _supervisor_script(port_ed, port_faults, port_sup, seed)
    assert port == ref
    st = port["stats"]
    for key in ("device_errors", "deadline_misses", "hedge_wins",
                "backpressure_fallbacks", "open_circuit_fallbacks",
                "probes_started", "rewarms"):
        assert st[key] > 0, key
    assert st["verdict_forks"] == 0
    good = [v for v in port["verdicts"] if v is not None]
    assert good and all(isinstance(v, list) for v in good)


def test_supervisor_delegates_device_attributes():
    _, dev, sup = _plane()
    dev.extra_attribute = 42
    assert sup.extra_attribute == 42
    with pytest.raises(AttributeError):
        sup._not_proxied
