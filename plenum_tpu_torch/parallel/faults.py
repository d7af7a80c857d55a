"""Deterministic fault injection for the crypto plane.

The supervisor (parallel/supervisor.py) is a state machine over device
failures; this module produces those failures ON DEMAND and ON SCHEDULE,
deterministically, so every breaker/hedge/fallback path is drivable from
a seed — in unit tests, in the sim-fuzz sweep (`device_flap` scenario in
tests/test_sim_fuzz.py), and against a live CryptoPlaneServer (wrap the
server's inner verifier).

`FaultyVerifier` wraps any Ed25519Verifier with the failure modes a real
relay/tunnel exhibits:

  wedge    requests are accepted but replies never come (the failure
           seen in the field: the relay process alive, the device gone) — in-flight
           AND subsequent tokens are lost until heal()
  drop     connection refused: submit_batch raises ConnectionError
  corrupt  the connection dies mid-stream: collect_batch raises
  delay    replies land late by a fixed or seeded interval
  flap     wedge/heal windows alternating on a seed-derived schedule

Modes switch manually (wedge()/heal()/drop()/corrupt()/delay()) or by a
`FaultPlan` — a seed-derived list of (start, end, mode) windows evaluated
against an injectable clock, so a MockTimer sim replays a failing seed
exactly. The injector never changes verdicts: a landed reply is always
the inner verifier's honest answer (verdict corruption would simulate a
*malicious* device, which is the Byzantine suite's job, not ops faults).
"""
from __future__ import annotations

import random
import time
from typing import Optional, Sequence

from plenum_tpu_torch.crypto.ed25519 import Ed25519Verifier, VerifyItem

MODES = ("ok", "wedge", "drop", "corrupt", "delay")


class FaultPlan:
    """Seed-derived schedule of fault windows: [(start, end, mode), ...]
    evaluated against the injected clock. Windows may not overlap; gaps
    are healthy. Pure function of (seed, horizon, rates) — any failing
    seed replays exactly.

    `device` optionally TARGETS one lane of a multi-device crypto
    pipeline: a verifier that identifies itself with a different
    `device_index` reads the plan as permanently healthy, so wedging
    chip k mid-consensus faults exactly lane k's breaker while every
    other lane keeps dispatching (the `device_flap` fuzz kind's
    per-device rung)."""

    def __init__(self, windows: Sequence[tuple[float, float, str]],
                 device: Optional[int] = None):
        self.windows = sorted(windows)
        self.device = device
        for _, _, mode in self.windows:
            if mode not in MODES:
                raise ValueError(f"unknown fault mode {mode!r}")

    @classmethod
    def from_seed(cls, seed: int, horizon: float = 30.0,
                  n_faults: Optional[int] = None,
                  modes: Sequence[str] = ("wedge", "drop", "corrupt"),
                  min_len: float = 1.0, max_len: float = 5.0,
                  device: Optional[int] = None,
                  n_devices: Optional[int] = None) -> "FaultPlan":
        rng = random.Random(seed * 6364136223846793005 + 1442695040888963407)
        if device is None and n_devices:
            # the targeted chip is part of the seed's identity: a failing
            # per-device seed replays against the same lane
            device = rng.randrange(n_devices)
        n = n_faults if n_faults is not None else rng.randint(1, 3)
        windows = []
        t = rng.uniform(0.0, horizon / 4)
        for _ in range(n):
            length = rng.uniform(min_len, max_len)
            if t + length > horizon:
                break
            windows.append((t, t + length, modes[rng.randrange(len(modes))]))
            t = t + length + rng.uniform(min_len, max_len)
        return cls(windows, device=device)

    def mode_at(self, now: float, device: Optional[int] = None) -> str:
        if (self.device is not None and device is not None
                and device != self.device):
            return "ok"          # the fault targets a different chip
        for start, end, mode in self.windows:
            if start <= now < end:
                return mode
        return "ok"


class FaultyVerifier(Ed25519Verifier):
    """Fault-injecting wrapper with the same submit/collect protocol.

    Token semantics under each mode (matching how the real service
    client experiences the relay):
      - tokens submitted while wedged are LOST: collect never resolves
        (a wedged relay restarting does not answer old requests)
      - tokens in flight when the wedge starts are lost too
      - drop refuses at submit; corrupt raises at collect
      - delay withholds the (honest) verdict until ready_at
    """

    def __init__(self, inner: Ed25519Verifier,
                 plan: Optional[FaultPlan] = None,
                 now=None, delay_s: float = 0.5,
                 device_index: Optional[int] = None):
        self._inner = inner
        self._plan = plan
        # which pipeline lane this verifier backs: a device-targeted
        # FaultPlan only fires when the indices match (None matches all)
        self.device_index = device_index
        self._now = now or time.monotonic
        self._forced: Optional[str] = None   # manual override, wins
        self._wedge_epoch = 0                # bumped per wedge: loses tokens
        self._last_mode = "ok"
        self.delay_s = delay_s
        self.submits = 0
        self.rewarms = 0
        self.faults_served = 0

    def set_clock(self, now) -> None:
        self._now = now

    # --- manual controls --------------------------------------------------

    def wedge(self) -> None:
        # the epoch bumps the moment the wedge starts: everything in
        # flight is lost NOW, whether or not anyone polls in between
        if self._last_mode != "wedge":
            self._wedge_epoch += 1
        self._forced = "wedge"
        self._last_mode = "wedge"

    def drop(self) -> None:
        self._forced = "drop"

    def corrupt(self) -> None:
        self._forced = "corrupt"

    def delay(self, delay_s: float = 0.5) -> None:
        self.delay_s = delay_s
        self._forced = "delay"

    def heal(self) -> None:
        self._forced = "ok"

    def mode(self) -> str:
        mode = self._forced if self._forced is not None else (
            self._plan.mode_at(self._now(), device=self.device_index)
            if self._plan else "ok")
        # a plan-driven wedge transition invalidates in-flight work, same
        # as the manual wedge() control does
        if mode == "wedge" and self._last_mode != "wedge":
            self._wedge_epoch += 1
        self._last_mode = mode
        return mode

    # --- rewarm hook (the supervisor calls this before its probe) ---------

    def rewarm(self) -> None:
        self.rewarms += 1
        if self.mode() == "drop":
            self.faults_served += 1
            raise ConnectionError("fault: relay refused (drop mode)")
        inner_rewarm = getattr(self._inner, "rewarm", None)
        if callable(inner_rewarm):
            inner_rewarm()

    # --- verifier protocol ------------------------------------------------

    def submit_batch(self, items: Sequence[VerifyItem]):
        self.submits += 1
        mode = self.mode()
        if mode == "drop":
            self.faults_served += 1
            raise ConnectionError("fault: relay refused (drop mode)")
        token = {
            "inner": self._inner.submit_batch(items),
            "epoch": self._wedge_epoch,
            "wedged": mode == "wedge",
            "ready_at": (self._now() + self.delay_s
                         if mode == "delay" else None),
        }
        if mode in ("wedge", "delay"):
            self.faults_served += 1
        return token

    def collect_batch(self, token, wait: bool = True):
        mode = self.mode()
        if mode == "corrupt":
            self.faults_served += 1
            raise ConnectionError("fault: connection corrupted mid-read")
        # lost = submitted during a wedge, or in flight when one started
        # (older epoch): such replies never arrive, even after heal
        lost = token["wedged"] or token["epoch"] < self._wedge_epoch
        if lost:
            if wait:
                # what the real client sees: its bounded socket deadline
                # fires and the connection is torn down
                raise ConnectionError("fault: relay wedged (reply lost)")
            return None
        if token["ready_at"] is not None and self._now() < token["ready_at"]:
            if wait:
                real_deadline = time.monotonic() + 5.0
                while (self._now() < token["ready_at"]
                       and time.monotonic() < real_deadline):
                    time.sleep(0.001)
                if self._now() < token["ready_at"]:
                    return None
            else:
                return None
        return self._inner.collect_batch(token["inner"], wait=wait)

    def verify_batch(self, items: Sequence[VerifyItem]):
        return self.collect_batch(self.submit_batch(items), wait=True)
