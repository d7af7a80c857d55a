"""Cross-host crypto federation: rent verification capacity from a
fleet of crypto hosts, with work-stealing between backlogged lanes.

The multi-device ring scales per-chip lanes WITHIN one host; this
module extends the same lane model ACROSS hosts. Each remote crypto
host — a `parallel.crypto_service` owner process reached over its unix
(or forwarded) socket, rostered via `multihost.crypto_host_roster` —
appears as one more lane in the submission ring:

  - its own wave queue and double-buffered dispatch (a threaded worker
    drives the wire, so the remote computes — and its verdicts land —
    while this host packs the next wave),
  - its own pinned bucket ladder, NEGOTIATED over the wire: the prewarm
    RPC compiles each pad bucket on the remote before pin(), and the
    wave-frame submit path (`FederatedEd25519Client`) dispatches the
    padded batch verbatim — no server-side dedup/coalescing — so a
    remote never sees an uncompiled shape,
  - its own supervised breaker: a dead/wedged host opens THAT lane's
    circuit and its traffic degrades to the supervisor's host fallback
    while every other lane keeps dispatching; the supervisor's probe +
    re-warm (client reconnect) re-admits the host when it returns.

Placement is LATENCY-AWARE: a rented host is rarely the same speed as
a local chip, so unhinted waves go to the healthy lane minimizing
expected completion — (queued items + one nominal wave) x an EWMA of
the lane's measured per-item service time — not to whichever lane
answered the round-robin. Unsampled lanes score zero (probed first);
until any lane has a sample the base least-occupancy placement keeps
cold starts deterministic.

Work-stealing: a backlogged lane's queued (still fully-unplanned)
tokens migrate to the least-backlogged healthy lane — local or remote —
when the occupancy delta clears `PIPELINE_STEAL_THRESHOLD`, with
per-lane-pair cooldown hysteresis (`PIPELINE_STEAL_COOLDOWN`) so a
symmetric load never oscillates. Stolen tokens are whole and unplanned,
so no item is ever double-verified; placement-pinned tokens NEVER move
(a pinned submitter's fallback chain is its own lane's supervisor). A
lane whose breaker is open evacuates unconditionally — back to
host-local lanes, the `crypto_host_down` steal-back contract.

Ship-out priority is phase-aware per VaultxGPU's consensus attribution:
only the ingress-dominant Ed25519 verify waves federate. `KIND_CMT`
(triple-root recommit) and BLS stay host-local — they inherit the base
class's host-side flush paths untouched, so a remote host can never
hold a commit root or an aggregate check hostage.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsName, percentile
from plenum_tpu_torch.crypto.ed25519 import VerifyItem

from .crypto_service import FederatedEd25519Client, ServiceEd25519Verifier
from .pipeline import (MultiDeviceCryptoPipeline, _DeviceLane, _EdToken,
                       _Wave, _device_backed)


def _service_client(verifier) -> Optional[ServiceEd25519Verifier]:
    """The crypto-service client inside a (supervised) verifier chain,
    walked the same bounded way as `_device_backed`."""
    obj = verifier
    for _ in range(4):
        if isinstance(obj, ServiceEd25519Verifier):
            return obj
        if not hasattr(obj, "__dict__"):
            return None
        obj = (obj.__dict__.get("_device")
               or obj.__dict__.get("_inner"))
        if obj is None:
            return None
    return None


class _RemoteLane(_DeviceLane):
    """One rostered crypto host as a ring lane. Wire-backed lanes are
    THREADED like chip lanes: the worker's blocking collect consumes
    the reply the moment it lands, so the wave's latency is the wire's
    — an inline lane would leave verdicts sitting in the socket buffer
    for as long as the main thread blocks on another lane's collect.
    In-proc stand-ins (tests, fuzz) stay inline so the deterministic
    harness replays exactly."""

    __slots__ = ("host",)

    def __init__(self, idx: int, inner, host: str,
                 threaded: Optional[bool] = None):
        if threaded is None:
            threaded = _service_client(inner) is not None
        super().__init__(idx, inner, threaded=threaded)
        self.host = host
        # a service client pads until prewarm negotiation says the
        # remote inner is host-backed (then padding would burn real
        # verifies over there); in-proc stand-ins keep the base answer
        if _service_client(inner) is not None:
            self.bucketed = True

    def close(self) -> None:
        super().close()
        client = _service_client(self.inner)
        if client is not None:
            try:
                client.close()
            except Exception:
                pass


class FederatedCryptoPipeline(MultiDeviceCryptoPipeline):
    """The multi-device ring with remote crypto hosts as extra lanes
    and work-stealing between backlogged lanes. See module docstring.

    Placement: `place(tag)` pins co-hosted sub-pool shards to LOCAL
    chips only (`tag % n_local`) — a pinned submitter's key table lives
    on its chip and its fallback chain is its own lane's supervisor;
    unhinted traffic goes to the healthy lane with the lowest EXPECTED
    COMPLETION (queue x measured per-item drain EWMA) across the whole
    federation — see "latency-aware" in the module docstring. Only Ed25519 verify waves route through
    lanes; BLS/SHA/commitment traffic inherits the base host-side
    flush paths (phase-aware ship-out: `KIND_CMT` and BLS never leave
    the host)."""

    def __init__(self, ed_inners: Sequence, remote_inners: Sequence = (),
                 hosts: Sequence[str] = (), config=None, now=None,
                 threaded: Optional[bool] = None, **kw):
        super().__init__(ed_inners, config=config, now=now,
                         threaded=threaded, **kw)
        self.n_local = len(self.lanes)
        for j, inner in enumerate(remote_inners):
            host = hosts[j] if j < len(hosts) else f"remote{j}"
            self.lanes.append(_RemoteLane(self.n_local + j, inner,
                                          host=host, threaded=threaded))
        for lane in self.lanes:
            lane.stats.setdefault("steals_in", 0)
            lane.stats.setdefault("steals_out", 0)
        self._bucketed = any(lane.bucketed for lane in self.lanes)
        self.stats["steals"] = 0
        self.stats["stolen_items"] = 0
        # (src_idx, dst_idx) -> last steal time: the anti-flap memory
        self._steal_log: dict[tuple, float] = {}
        # remote dispatch->verdict latencies (ms), bounded window
        self._ship_ms: deque = deque(maxlen=512)
        # lane idx -> EWMA of per-item service seconds: the drain-rate
        # model behind latency-aware placement — a rented host is rarely
        # the same speed as a local chip, so queue length alone places
        # work on whichever lane answered the round-robin, not the lane
        # that will FINISH it first
        self._lane_item_s: dict[int, float] = {}

    # --- placement ------------------------------------------------------

    def place(self, tag: int) -> Optional[int]:
        # pinned shards partition the LOCAL key space; remote lanes only
        # serve unhinted overflow and stolen work
        return tag % self.n_local

    def healthy_lane(self, exclude=()) -> Optional[int]:
        # the autopilot's re-placement target keeps the same local-only
        # pin discipline as place(): a shard re-pinned off a sick chip
        # lands on another LOCAL chip, never a WAN lane — remote
        # capacity stays overflow/steal-only. Falls back to any healthy
        # remote only when every local lane is excluded or degraded.
        skip = set(exclude)
        local = [l for l in self.lanes[:self.n_local]
                 if not l.degraded() and l.idx not in skip]
        if local:
            return min(local, key=lambda l: (l.occupancy(), l.idx)).idx
        return super().healthy_lane(exclude)

    def _pick_lane(self, hint: Optional[int]) -> _DeviceLane:
        if hint is not None:
            return self.lanes[hint % self.n_local]
        rates = self._lane_item_s
        healthy = [l for l in self.lanes if not l.degraded()]
        if len(healthy) >= 2 and any(l.idx in rates for l in healthy):
            # latency-aware: minimize expected completion = (queued
            # items + one nominal wave) x measured per-item drain time.
            # An unsampled lane scores 0 — it gets probed first, then
            # competes on its record; until ANY lane is sampled the
            # base least-occupancy placement keeps cold starts (and the
            # zero-remote identity contract) deterministic
            nominal = self.buckets[0] if self.buckets else 1
            return min(healthy,
                       key=lambda l: ((l.occupancy() + nominal)
                                      * rates.get(l.idx, 0.0)))
        return super()._pick_lane(None)

    def submit_verify(self, items: Sequence[VerifyItem],
                      lane: Optional[int] = None) -> _EdToken:
        tok = super().submit_verify(items, lane=lane)
        tok.lane_hint = lane          # steal eligibility: pinned stay put
        return tok

    # --- work-stealing --------------------------------------------------

    @staticmethod
    def _lane_backlog(lane: _DeviceLane) -> int:
        """Items still STAGED (unplanned) on the lane — what a steal can
        actually move; packed/in-flight waves are already committed."""
        return sum(len(t.items) - t.planned for t in lane.staged)

    def _balance(self) -> None:
        """One rebalance pass per pump: the most-backlogged lane donates
        to the least-occupied healthy lane under the occupancy-delta
        threshold + per-pair cooldown hysteresis; an open-breaker lane
        evacuates unconditionally to host-local lanes."""
        if len(self.lanes) < 2:
            return
        threshold = int(getattr(self.config,
                                "PIPELINE_STEAL_THRESHOLD", 32))
        cooldown = float(getattr(self.config,
                                 "PIPELINE_STEAL_COOLDOWN", 0.25))
        now = self._now()
        healthy = [l for l in self.lanes if not l.degraded()]
        if not healthy:
            return
        for src in self.lanes:
            backlog = self._lane_backlog(src)
            if backlog == 0:
                continue
            evac = src.degraded()
            if not evac and backlog < threshold:
                continue
            pool = [l for l in healthy if l is not src]
            if evac:
                # steal-back: a sick lane's queue drains to HOST-LOCAL
                # lanes (crypto_host_down contract); only when no local
                # lane is healthy may another remote absorb it
                local = [l for l in pool if l.idx < self.n_local]
                pool = local or pool
            if not pool:
                continue
            dst = min(pool, key=lambda l: l.occupancy())
            delta = backlog - dst.occupancy()
            if evac:
                quota = backlog
            else:
                if delta < threshold:
                    continue
                # anti-flap hysteresis: a recent steal on this pair (in
                # EITHER direction) blocks another — symmetric load can
                # never oscillate work between two lanes
                last = max(
                    self._steal_log.get((src.idx, dst.idx), -1e18),
                    self._steal_log.get((dst.idx, src.idx), -1e18))
                if now - last < cooldown:
                    continue
                quota = delta // 2
            moved = self._steal(src, dst, quota, now)
            if moved:
                self._steal_log[(src.idx, dst.idx)] = now

    def _steal(self, src: _DeviceLane, dst: _DeviceLane,
               max_items: int, now: float) -> int:
        """Migrate whole, fully-UNPLANNED, unpinned tokens from the tail
        of src's queue to dst (relative order preserved). Planned tokens
        have items already assigned to a wave — moving them could
        double-verify — and only the queue HEAD can be part-planned, so
        walking newest-first and stopping at the first ineligible token
        is exact. -> items moved."""
        moved: list[_EdToken] = []
        n = 0
        while src.staged and n < max_items:
            tok = src.staged[-1]
            if tok.planned or tok.lane_hint is not None:
                break
            src.staged.pop()
            moved.append(tok)
            n += len(tok.items)
        if not moved:
            return 0
        if not dst.staged:
            dst.first_staged = moved[-1].t_submit
        for tok in reversed(moved):      # oldest first: order preserved
            dst.staged.append(tok)
        if not src.staged:
            src.first_staged = None
        self.stats["steals"] += 1
        self.stats["stolen_items"] += n
        src.stats["steals_out"] += 1
        dst.stats["steals_in"] += 1
        return n

    def service(self, force: bool = False) -> bool:
        self._balance()
        self._pump_recovery()
        return super().service(force=force)

    def _pump_recovery(self) -> None:
        """A dead host's lane gets NO traffic — placement routes around
        degraded lanes and evacuation empties their queues — so nothing
        on the submit/collect path would ever run its supervisor's probe
        and the host could never rejoin. The pump nudges the probe state
        machine on idle open lanes instead. Idle-only on purpose: a lane
        with queued or in-flight work drives its own recovery from the
        traffic path (for threaded wire lanes, on the worker thread —
        pumping a busy lane here would race it)."""
        for lane in self.lanes:
            if not lane.degraded():
                continue
            if lane.occupancy() != 0 or lane.inflight is not None:
                continue
            pump = getattr(lane.inner, "pump_recovery", None)
            if callable(pump):
                pump()

    def _note_lane_shape(self, lane: _DeviceLane, key) -> None:
        if lane.idx >= self.n_local and not lane.bucketed:
            # prewarm negotiation said this remote's inner is HOST-backed:
            # it ships bare waves, widths aren't compiles, so a novel
            # width after pin() is not an unpinned-shape fault
            lane.shapes.add(key)
            return
        super()._note_lane_shape(lane, key)

    def _resolve_wave(self, wave: _Wave, ok) -> None:
        super()._resolve_wave(wave, ok)
        if wave.lane is None or wave.t_dispatched is None:
            return
        dt = self._now() - wave.t_dispatched
        per_item = dt / max(1, len(wave.items))
        prev = self._lane_item_s.get(wave.lane)
        self._lane_item_s[wave.lane] = (
            per_item if prev is None else 0.8 * prev + 0.2 * per_item)
        if wave.lane >= self.n_local:
            self._ship_ms.append(dt * 1000.0)

    # --- warmup / pinning over the wire ---------------------------------

    def prewarm(self, buckets: Optional[Sequence[int]] = None) -> list[int]:
        """Local lanes warm through the base machinery (concurrent
        threaded compiles); each remote host warms via the prewarm RPC —
        one verbatim all-pad wave per bucket, compiled server-side — and
        the reply NEGOTIATES whether the remote pads at all. A remote
        that cannot compile its ladder fails warmup loudly, exactly like
        a local lane."""
        lanes_all = self.lanes
        self.lanes = lanes_all[:self.n_local]
        try:
            warmed = super().prewarm(buckets)
        finally:
            self.lanes = lanes_all
        want = [b for b in sorted(set(
            buckets if buckets is not None else self.buckets[:1]))
            if b in set(self.buckets)]
        for lane in self.lanes[self.n_local:]:
            client = _service_client(lane.inner)
            if client is not None:
                reply = client.prewarm(want)          # raises on failure
                lane.bucketed = bool(reply.get("bucketed", lane.bucketed))
                if lane.bucketed:
                    for b in reply.get("warmed") or want:
                        self._note_lane_shape(
                            lane, self._cache_bucket(1, int(b)))
                    warmed = warmed or want
            elif lane.bucketed:
                # in-proc stand-in (tests/sims): warm inline like a
                # local lane
                for b in want:
                    items = [(b"pipeline-prewarm", b"\x00" * 64,
                              b"\x00" * 32)] * b
                    tok = lane.inner.submit_batch(items)
                    lane.inner.collect_batch(tok, wait=True)
                    self._note_lane_shape(lane, self._cache_bucket(1, b))
                warmed = warmed or want
        self._bucketed = any(lane.bucketed for lane in self.lanes)
        return warmed

    def pin(self) -> None:
        super().pin()
        for lane in self.lanes[self.n_local:]:
            client = _service_client(lane.inner)
            if client is not None:
                client.pin()

    # --- reporting ------------------------------------------------------

    def federation_state(self) -> dict:
        remote = self.lanes[self.n_local:]
        return {
            "remote_lanes": len(remote),
            "steals": self.stats["steals"],
            "stolen_items": self.stats["stolen_items"],
            "remote_breakers_open": sum(
                1 for l in remote
                if l.breaker_state() not in (None, "closed")),
            "ship_ms_p95": (round(percentile(list(self._ship_ms), 0.95), 3)
                            if self._ship_ms else 0.0),
        }

    def device_state(self) -> list[dict]:
        out = super().device_state()
        for lane, d in zip(self.lanes, out):
            if lane.idx >= self.n_local:
                d["remote"] = True
                d["host"] = lane.host
            d["steals_in"] = lane.stats.get("steals_in", 0)
            d["steals_out"] = lane.stats.get("steals_out", 0)
        return out

    def sample_metrics(self, metrics) -> None:
        super().sample_metrics(metrics)
        fed = self.federation_state()
        metrics.add_event(MetricsName.PIPELINE_FED_REMOTE_LANES,
                          fed["remote_lanes"])
        metrics.add_event(MetricsName.PIPELINE_FED_STEALS, fed["steals"])
        metrics.add_event(MetricsName.PIPELINE_FED_STOLEN_ITEMS,
                          fed["stolen_items"])
        metrics.add_event(MetricsName.PIPELINE_FED_REMOTE_BREAKERS_OPEN,
                          fed["remote_breakers_open"])
        metrics.add_event(MetricsName.PIPELINE_FED_SHIP_MS_P95,
                          fed["ship_ms_p95"])

    def summary(self) -> dict:
        out = super().summary()
        out["federation"] = self.federation_state()
        return out


def make_federated_pipeline(config, min_batch: int = 1,
                            supervised: bool = True,
                            hosts: Optional[Sequence[str]] = None,
                            n_devices: Optional[int] = None,
                            devices: Optional[Sequence] = None,
                            **kw) -> FederatedCryptoPipeline:
    """Local per-chip lanes (the make_multidevice_pipeline roster) plus
    one supervised remote lane per rostered crypto host. Each remote's
    supervisor owns an independent breaker whose re-warm hook is the
    client reconnect, so a host that dies mid-run degrades exactly its
    own lane and re-admits on rejoin. `devices` names the local lanes'
    devices (["cpu"] for the plain versions); the default is the card's.
    `min_batch` is the reference's signature: the torch verifier takes
    no minimum (the ring's buckets pad)."""
    from .multihost import crypto_host_roster
    from .pipeline import lane_inners
    from .supervisor import supervise

    if hosts is None:
        hosts = crypto_host_roster(config)
    hosts = [str(h) for h in hosts]
    if n_devices is None:
        n_devices = getattr(config, "PIPELINE_DEVICES", 1)
    inners = lane_inners(n_devices, supervised, devices)
    remote_inners = []
    for j, path in enumerate(hosts):
        client = FederatedEd25519Client(socket_path=path)
        remote_inners.append(
            supervise(client, label=f"remote{j}") if supervised
            else client)
    return FederatedCryptoPipeline(
        ed_inners=inners, remote_inners=remote_inners, hosts=hosts,
        config=config,
        sha_device=kw.pop("sha_device", True),
        sha_min_device=kw.pop("sha_min_device", getattr(
            config, "PIPELINE_SHA_MIN_BATCH", 1024)), **kw)
