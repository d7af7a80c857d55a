"""Deterministic in-process network fabric for multi-node simulation.

Reference behavior: plenum/test/simulation/sim_network.py:98 — peers are
ExternalBus instances wired through a rule chain; each rule can Discard (with
probability), Stash, or Deliver (with random delay) messages matched by
predicate. All delays go through the TimerService, all randomness through
SimRandom, so a whole pool run is replayable from a seed. Messages make a
round trip through the real wire serializer so schema bugs surface in sims.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, NamedTuple, Optional, Union

from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.message_base import MessageBase, message_from_dict
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.common.timer import TimerService

from .sim_random import SimRandom


class Discard(NamedTuple):
    probability: float = 1.0


class Deliver(NamedTuple):
    min_delay: float = 0.0
    max_delay: float = 0.0


class Stash(NamedTuple):
    pass


class Mutate(NamedTuple):
    """Byzantine fault injection: transform the message before delivery
    (the transform returns the replacement message, or None to drop).
    Mutated traffic still pays the normal wire roundtrip, so a mutation
    that breaks the message SCHEMA surfaces as a parse reject at the
    receiver — exactly like a real byzantine peer's frame would."""
    transform: Callable[[Any], Any]
    probability: float = 1.0


Action = Union[Discard, Deliver, Stash, Mutate]
Selector = Callable[[Any, str, str], bool]   # (msg, frm, dst) -> bool


class LinkProfile(NamedTuple):
    """One directed link's WAN character. All fields are sim seconds /
    probabilities / bytes-per-second; every random draw they imply goes
    through the fabric's SimRandom, so a profiled run replays from its
    seed exactly like a flat one."""
    base_delay: float = 0.01     # one-way propagation latency
    jitter: float = 0.0          # uniform extra delay in [0, jitter]
    loss: float = 0.0            # per-message drop probability
    bandwidth: float = 0.0       # serialization cap (bytes/s); 0 = infinite


class Topology:
    """Named regions + per-(region, region) directed LinkProfiles.

    Asymmetry is first-class: the (frm_region, dst_region) key is
    directed, so an asymmetric route (fat down-link, thin up-link) is two
    entries. Lookup order: exact directed pair -> ("*", dst) -> (frm, "*")
    -> default. Peers created after construction (membership churn) are
    auto-assigned round-robin over the region list so a joining node gets
    a deterministic placement."""

    def __init__(self, regions: Iterable[str],
                 links: Optional[dict] = None,
                 default: Optional[LinkProfile] = None):
        self.regions = list(regions) or ["region0"]
        self.links: dict[tuple[str, str], LinkProfile] = dict(links or {})
        self.default = default or LinkProfile()
        self._assignment: dict[str, str] = {}
        self._auto_idx = 0

    def assign(self, name: str, region: Optional[str] = None) -> str:
        if region is None:
            region = self.regions[self._auto_idx % len(self.regions)]
            self._auto_idx += 1
        self._assignment[name] = region
        return region

    def assign_round_robin(self, names: Iterable[str]) -> None:
        for name in names:
            self.assign(name)

    def region_of(self, name: str) -> str:
        got = self._assignment.get(name)
        if got is None:
            got = self.assign(name)
        return got

    def set_link(self, frm_region: str, dst_region: str,
                 profile: LinkProfile) -> None:
        self.links[(frm_region, dst_region)] = profile

    def profile(self, frm: str, dst: str) -> LinkProfile:
        a, b = self.region_of(frm), self.region_of(dst)
        for key in ((a, b), ("*", b), (a, "*")):
            got = self.links.get(key)
            if got is not None:
                return got
        return self.default


def make_topology(preset: str, names: Iterable[str],
                  n_regions: int = 3) -> Topology:
    """Region presets for bench/fuzz configs.

    - ``lan``: one region, sub-millisecond, lossless, effectively
      unbounded bandwidth — the flat fabric restated as a profile.
    - ``geo3``: `n_regions` geo regions; fast clean intra-region links,
      40-90 ms inter-region propagation with mild jitter and a 100 Mbit/s
      serialization cap.
    - ``lossy_wan``: geo3 degraded — inter-region links lose 3% of
      messages, jitter widens to 80 ms, bandwidth drops to 20 Mbit/s.
      This is the profile the churn/view-change hardening is judged
      under (a view change that only completes on a clean LAN is not a
      view change).
    """
    names = list(names)
    if preset == "lan":
        topo = Topology(["lan"], default=LinkProfile(
            base_delay=0.0002, jitter=0.0003, loss=0.0, bandwidth=125e6))
        topo.assign_round_robin(names)
        return topo
    if preset not in ("geo3", "lossy_wan"):
        raise ValueError(f"unknown topology preset {preset!r}")
    regions = [f"geo{i}" for i in range(max(2, n_regions))]
    intra = LinkProfile(base_delay=0.001, jitter=0.002, loss=0.0,
                        bandwidth=125e6)
    if preset == "geo3":
        inter = LinkProfile(base_delay=0.04, jitter=0.03, loss=0.0,
                            bandwidth=12.5e6)
    else:
        inter = LinkProfile(base_delay=0.06, jitter=0.08, loss=0.03,
                            bandwidth=2.5e6)
    links = {}
    for i, a in enumerate(regions):
        for j, b in enumerate(regions):
            if i == j:
                links[(a, b)] = intra
            else:
                # deterministic mild asymmetry: the "far" direction pays
                # ~25% more propagation (uplink-shaped routes)
                stretch = 1.0 + 0.25 * ((i + j) % 2 if i < j else 0)
                links[(a, b)] = inter._replace(
                    base_delay=inter.base_delay * stretch)
    topo = Topology(regions, links=links, default=intra)
    topo.assign_round_robin(names)
    return topo


class Rule(NamedTuple):
    action: Action
    selectors: tuple


def match_frm(frm: Union[str, Iterable[str]]) -> Selector:
    names = {frm} if isinstance(frm, str) else set(frm)
    return lambda _msg, f, _dst: f in names


def match_dst(dst: Union[str, Iterable[str]]) -> Selector:
    names = {dst} if isinstance(dst, str) else set(dst)
    return lambda _msg, _frm, d: d in names


def match_type(t: Union[type, Iterable[type]]) -> Selector:
    types = t if isinstance(t, type) else tuple(t)
    return lambda msg, _frm, _dst: isinstance(msg, types)


class SimNetwork:
    """Full-mesh fabric: every peer's ExternalBus sends into the rule chain;
    surviving messages are scheduled for delivery on the shared timer."""

    def __init__(self, timer: TimerService, random: Optional[SimRandom] = None,
                 wire_roundtrip: bool = True,
                 topology: Optional[Topology] = None):
        self._timer = timer
        self._random = random or SimRandom()
        self._wire_roundtrip = wire_roundtrip
        self._peers: dict[str, ExternalBus] = {}
        self._rules: list[Rule] = []
        self._stashed: list[tuple[Any, str, str]] = []
        self.min_latency = 0.01
        self.max_latency = 0.5
        # topology-aware fault model: when set, the default delivery path
        # derives per-message delay/loss/serialization from the directed
        # (frm, dst) LinkProfile instead of the flat uniform latency.
        # Explicit Deliver/Discard rules still win (last-added-rule-first),
        # so targeted scenario faults compose ON TOP of the WAN character.
        self._topology = topology
        # directed link -> sim time the link's serializer is busy until
        # (bandwidth cap: frames queue behind each other, a burst pays
        # its own transmission time, not just propagation)
        self._link_busy: dict[tuple[str, str], float] = {}
        self.sent_count = 0
        self.delivered_count = 0
        self.lost_count = 0          # topology-loss drops (rule Discards
        #                              are scenario faults, counted apart)
        # per-message-type [count, bytes] over every scheduled delivery —
        # the sim twin of TcpStack.stats["tx_msgs"], so wire-cost claims
        # (digest-gossip) are measurable on the deterministic fabric too
        self.tx_msgs: dict[str, list] = {}

    def bytes_summary(self) -> dict:
        total = sum(c[1] for c in self.tx_msgs.values())
        return {"total_bytes": total,
                "by_type": {op: {"count": c[0], "bytes": c[1]}
                            for op, c in sorted(self.tx_msgs.items())}}

    # --- peers -----------------------------------------------------------

    def create_peer(self, name: str,
                    send_handler: Optional[Callable] = None) -> ExternalBus:
        if name in self._peers:
            raise ValueError(f"peer {name!r} already exists")
        handler = send_handler or (lambda msg, dst, frm=name: self._send(frm, msg, dst))
        bus = ExternalBus(handler)
        self._peers[name] = bus
        return bus

    def remove_peer(self, name: str) -> None:
        self._peers.pop(name, None)
        self._refresh_connecteds()

    @property
    def peer_names(self) -> list[str]:
        return list(self._peers)

    def connect_all(self) -> None:
        self._refresh_connecteds()

    def _refresh_connecteds(self) -> None:
        all_names = set(self._peers)
        for name, bus in self._peers.items():
            bus.update_connecteds(all_names - {name})

    # --- rules -----------------------------------------------------------

    def add_rule(self, action: Action, *selectors: Selector) -> Rule:
        rule = Rule(action=action, selectors=selectors)
        self._rules.append(rule)
        return rule

    def remove_rule(self, rule: Rule) -> None:
        if rule in self._rules:
            self._rules.remove(rule)
            self._replay_stashed()

    def set_latency(self, min_value: float, max_value: float) -> None:
        self.min_latency = min_value
        self.max_latency = max_value

    def set_topology(self, topology: Optional[Topology]) -> None:
        self._topology = topology
        self._link_busy.clear()

    @property
    def topology(self) -> Optional[Topology]:
        return self._topology

    def _replay_stashed(self) -> None:
        stashed, self._stashed = self._stashed, []
        for msg, frm, dst in stashed:
            self._route(msg, frm, dst)

    # --- transmission ----------------------------------------------------

    def _send(self, frm: str, msg: Any, dst) -> None:
        if dst is None:
            targets = [n for n in self._peers if n != frm]
        elif isinstance(dst, str):
            # a bare name must address ONE peer — iterating a string
            # would silently split it into characters and drop the send
            targets = [dst]
        else:
            targets = [d for d in dst]
        # pack-once broadcast: one wire serialization shared by every
        # target of this send (a real transport packs a broadcast frame
        # once too). Keyed by object identity, and the cache value PINS
        # the message object: a Mutate rule's per-destination replacement
        # may be garbage-collected as soon as its _route returns, and a
        # later replacement allocated at the recycled address would
        # otherwise hit the dead entry and deliver the previous
        # mutation's bytes. Holding the reference (and re-checking `is`)
        # makes identity-keying sound for the send's lifetime.
        pack_cache: dict[int, tuple[Any, dict, bytes]] = {}
        for d in targets:
            self.sent_count += 1
            self._route(msg, frm, d, pack_cache)

    def _route(self, msg: Any, frm: str, dst: str,
               pack_cache: Optional[dict] = None) -> None:
        # Last-added rule wins, like a filter stack.
        for rule in reversed(self._rules):
            if not all(sel(msg, frm, dst) for sel in rule.selectors):
                continue
            if isinstance(rule.action, Discard):
                if self._random.float(0.0, 1.0) <= rule.action.probability:
                    return
                continue
            if isinstance(rule.action, Stash):
                self._stashed.append((msg, frm, dst))
                return
            if isinstance(rule.action, Mutate):
                if self._random.float(0.0, 1.0) <= rule.action.probability:
                    msg = rule.action.transform(msg)
                    if msg is None:
                        return
                continue        # mutated message keeps flowing down the chain
            if isinstance(rule.action, Deliver):
                delay = self._random.float(rule.action.min_delay, rule.action.max_delay)
                self._schedule(delay, msg, frm, dst, pack_cache)
                return
        topo = self._topology
        if topo is not None:
            prof = topo.profile(frm, dst)
            if prof.loss and self._random.float(0.0, 1.0) <= prof.loss:
                self.lost_count += 1
                return
            delay = prof.base_delay
            if prof.jitter:
                delay += self._random.float(0.0, prof.jitter)
            self._schedule(delay, msg, frm, dst, pack_cache, profile=prof)
            return
        delay = self._random.float(self.min_latency, self.max_latency)
        self._schedule(delay, msg, frm, dst, pack_cache)

    def _tx_time(self, profile: LinkProfile, frm: str, dst: str,
                 nbytes: int) -> float:
        """Serialization + queueing on the directed link's bandwidth cap:
        a frame starts transmitting when the link frees up, so a burst
        spreads out instead of all arriving one propagation delay later."""
        if not profile.bandwidth or nbytes <= 0:
            return 0.0
        ser = nbytes / profile.bandwidth
        now = self._timer.get_current_time()
        start = max(now, self._link_busy.get((frm, dst), now))
        self._link_busy[(frm, dst)] = start + ser
        return (start - now) + ser

    def _schedule(self, delay: float, msg: Any, frm: str, dst: str,
                  pack_cache: Optional[dict] = None,
                  profile: Optional[LinkProfile] = None) -> None:
        if self._wire_roundtrip and isinstance(msg, MessageBase):
            # Serialize now (sender's view), deserialize at delivery — exactly
            # what a real wire does, so schema violations fail loudly in sims.
            cached = pack_cache.get(id(msg)) if pack_cache is not None else None
            if cached is None or cached[0] is not msg:
                d = msg.to_dict()
                cached = (msg, d, pack(d))
                if pack_cache is not None:
                    pack_cache[id(msg)] = cached
            _, d, data = cached
            row = self.tx_msgs.setdefault(d.get("op", "?"), [0, 0])
            row[0] += 1
            row[1] += len(data)
            if profile is not None:
                delay += self._tx_time(profile, frm, dst, len(data))
            deliver = lambda: self._deliver_wire(data, frm, dst)
        else:
            deliver = lambda: self._deliver(msg, frm, dst)
        self._timer.schedule(delay, deliver)

    def _deliver_wire(self, data: bytes, frm: str, dst: str) -> None:
        self._deliver(message_from_dict(unpack(data)), frm, dst)

    def _deliver(self, msg: Any, frm: str, dst: str) -> None:
        bus = self._peers.get(dst)
        if bus is None:
            return
        self.delivered_count += 1
        bus.process_incoming(msg, frm)
