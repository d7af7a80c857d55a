"""Autopilot: the control plane that closes telemetry -> actuation.

Every control signal and every actuator already exists on the fabric —
the aggregator's health scores, SLO burn pages and imbalance index;
``ReshardManager.maybe_split``; pipeline lane placement and breakers;
read-only degradation — but until now a human or a test had to connect
them. The :class:`Autopilot` rides the :class:`FleetAggregator`'s
once-per-interval cadence and *actuates* instead of alerting, through
four policies, each with cooldown + flap hysteresis (the circuit-breaker
pattern lifted to fleet scale):

1. **Live shard split/merge.** A SUSTAINED imbalance flag (N consecutive
   pool-interval judgments, ``aggregator.sustained``) drives
   ``ReshardManager.maybe_split``; a sustained under-load judgment (only
   ever noted while NO shard is hot) merges the cold shard into its
   range-adjacent neighbor. One pool-wide reshard cooldown — layered on
   the manager's own ``cooldown_until`` guard — means a reshard can
   never chase its own transient.
2. **Pipeline lane re-placement.** A chip whose lane breaker stays open
   across the sustain window gets its pinned shards re-pinned to the
   least-backlogged healthy lane (``healthy_lane``); after the breaker
   stays CLOSED for the (longer) recovery window and the cooldown has
   expired, the pins restore. Re-pinning changes only FUTURE
   submissions — the ring itself never reshuffles in-flight waves.
3. **Observer fan-out.** Regional read-latency burn (the observer
   fleet's ``("reads", region)`` trackers, the same multi-window
   burn-rate rule as every other SLO) spawns observers up to a bound;
   sustained-clear burn plus measured demand headroom retires them.
4. **Orchestrated degradation.** When SLO burn persists for twice the
   sustain window DESPITE policies 1–3, the pool steps down a
   documented ladder — level 1: every front door's shed watermark
   clamps harder; level 2: pool-wide read-only — and steps back up one
   level at a time on sustained recovery. A catchup-diverged node's
   read-only is never touched (``Node.set_read_only`` refuses).

Every decision is an ordered transaction on the reserved
``CONTROL_LEDGER_ID``: action, attributed evidence snapshot, pre/post
state, cooldown stamp, and — for every undo — the seq of the action it
reverts. The autopilot's history is replayable and auditable
(tools/control_audit.py), never an operator mutation. All timing rides
the injectable timer, and decisions fire only when snapshot arrivals
advance the aggregator's fleet clock past the next interval mark — so a
recorded run replays byte-identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from plenum_tpu_torch.common.metrics import MetricsName

# Reserved ledger id for control transactions — outside VALID_LEDGER_IDS
# like MAPPING_LEDGER_ID (100): the control history is fabric-scoped
# bookkeeping with ledger DISCIPLINE (ordered, append-only, auditable),
# not a consensus ledger nodes replicate.
CONTROL_LEDGER_ID = 101

# forward action -> the undo that must cite it (the audit contract)
REVERT_OF = {"unpin": "repin",
             "observer_retire": "observer_spawn",
             "recover": "degrade"}

# the documented degradation ladder, in descending order of service
LADDER = ("normal", "shed_harder", "read_only")


@dataclass
class ControlRecord:
    """One ordered control transaction."""
    seq: int
    t: float
    policy: str                  # "reshard" | "lane" | "observer" | "ladder"
    action: str                  # "split"/"merge"/"repin"/"unpin"/...
    subject: str
    evidence: dict = field(default_factory=dict)
    pre: dict = field(default_factory=dict)
    post: dict = field(default_factory=dict)
    cooldown_until: float = 0.0
    cites: Optional[int] = None  # seq of the action an undo reverts

    def to_dict(self) -> dict:
        return {"ledger_id": CONTROL_LEDGER_ID, "seq": self.seq,
                "t": round(self.t, 6), "policy": self.policy,
                "action": self.action, "subject": self.subject,
                "evidence": self.evidence, "pre": self.pre,
                "post": self.post,
                "cooldown_until": round(self.cooldown_until, 6),
                "cites": self.cites}


class ControlLedger:
    """Ordered, append-only record of every autopilot decision."""

    def __init__(self, now: Callable[[], float]):
        self.now = now
        self.records: list[ControlRecord] = []

    def append(self, **kw) -> ControlRecord:
        rec = ControlRecord(seq=len(self.records) + 1,
                            t=kw.pop("t", None) or self.now(), **kw)
        self.records.append(rec)
        return rec

    def to_dicts(self) -> list[dict]:
        return [r.to_dict() for r in self.records]

    def __len__(self) -> int:
        return len(self.records)


class Autopilot:
    """Drive with ``service()`` from the fabric's prod loop."""

    SLO_KINDS = ("slo_burn.ingress", "slo_burn.batch", "slo_burn.reads")

    def __init__(self, fabric):
        self.fabric = fabric
        self.config = fabric.config
        self.agg = fabric.aggregator
        self.ledger = ControlLedger(now=lambda: self.agg.now)
        cfg = self.config
        self._interval = getattr(cfg, "AUTOPILOT_INTERVAL", 1.0)
        self._sustain = getattr(cfg, "AUTOPILOT_SUSTAIN", 3)
        self._recover = getattr(cfg, "AUTOPILOT_RECOVER_SUSTAIN", 5)
        self._cooldown = getattr(cfg, "AUTOPILOT_COOLDOWN", 30.0)
        self._min_shards = getattr(cfg, "AUTOPILOT_MIN_SHARDS", 2)
        self._obs_min = getattr(cfg, "AUTOPILOT_OBSERVER_MIN", 1)
        self._obs_max = getattr(cfg, "AUTOPILOT_OBSERVER_MAX", 4)
        self._edge_absorb = getattr(cfg, "AUTOPILOT_EDGE_ABSORB", 0.95)
        self._shed_factor = getattr(cfg, "AUTOPILOT_SHED_FACTOR", 4)
        self._next_eval = 0.0
        # (policy, subject) -> timestamp before which the policy may not
        # touch the subject again (INCLUDING undoing itself: an
        # action/undo pair can never fit inside one cooldown window)
        self._cooldowns: dict[tuple[str, str], float] = {}
        # one hold record per blocked episode, not one per tick
        self._held: dict[tuple[str, str, str], float] = {}
        # sid -> {"prev": lane, "sick": lane, "seq": n} while re-pinned
        self._repins: dict[int, dict] = {}
        # region -> stack of observer_spawn seqs awaiting retire-cite
        self._spawns: dict[str, list[int]] = {}
        self.level = 0
        self._ladder_seqs: list[int] = []
        self.counts = {"decisions": 0, "actions": 0, "reverts": 0,
                       "holds": 0}

    # --- cadence -----------------------------------------------------------

    def service(self) -> None:
        """Evaluate once per AUTOPILOT_INTERVAL of the AGGREGATOR's
        fleet clock — it only advances on snapshot arrivals, so every
        decision fires on an aggregator-interval boundary and a
        replayed snapshot stream reproduces the decision stream."""
        t = self.agg.now
        if t < self._next_eval:
            return
        self._next_eval = t + self._interval
        self.counts["decisions"] += 1
        self.fabric.metrics.add_event(MetricsName.AUTOPILOT_DECISIONS)
        self._policy_lanes(t)
        self._policy_reshard(t)
        self._policy_observers(t)
        self._policy_ladder(t)
        self.agg.autopilot = self.summary()

    # --- bookkeeping helpers ------------------------------------------------

    def _cooled(self, policy: str, subject: str, t: float) -> bool:
        return t >= self._cooldowns.get((policy, subject), 0.0)

    def _stamp(self, policy: str, subject: str, until: float) -> None:
        self._cooldowns[(policy, subject)] = until

    def _record(self, t: float, policy: str, action: str, subject: str,
                evidence: dict, pre: dict, post: dict,
                cooldown_until: float = 0.0,
                cites: Optional[int] = None) -> int:
        rec = self.ledger.append(
            t=t, policy=policy, action=action, subject=subject,
            evidence=evidence, pre=pre, post=post,
            cooldown_until=cooldown_until, cites=cites)
        metrics = self.fabric.metrics
        if action == "hold":
            self.counts["holds"] += 1
            metrics.add_event(MetricsName.AUTOPILOT_HOLDS)
        elif action in REVERT_OF:
            self.counts["reverts"] += 1
            metrics.add_event(MetricsName.AUTOPILOT_REVERTS)
        else:
            self.counts["actions"] += 1
            metrics.add_event(MetricsName.AUTOPILOT_ACTIONS)
        tracer = self.fabric.fabric_tracer
        if tracer is not None and tracer.enabled:
            tracer.anomaly(f"autopilot.{action}", rec.to_dict())
        return rec.seq

    def _hold(self, t: float, policy: str, wanted: str, subject: str,
              evidence: dict, cd_subject: Optional[str] = None) -> None:
        """Record that a sustained signal wanted `wanted` but cooldown/
        busy state blocked it — once per blocked episode (one record per
        distinct cooldown stamp, not one per tick; a fresh action
        re-stamps, opening a new episode)."""
        until = self._cooldowns.get((policy, cd_subject or subject), 0.0)
        key = (policy, subject, wanted)
        if self._held.get(key) == until:
            return
        self._held[key] = until
        self._record(t, policy, "hold", subject,
                     {"wanted": wanted, "blocked_until": round(until, 3),
                      **evidence}, pre={}, post={})

    def _shard_state(self) -> dict:
        return {"shards": sorted(self.fabric.shards),
                "epoch": self.fabric.mapping.epoch}

    # --- policy 1: live shard split / merge ---------------------------------

    def _policy_reshard(self, t: float) -> None:
        rm = self.fabric.reshard
        if self.agg.sustained("shard.imbalance", self._sustain):
            index, hot = self.agg.load_imbalance()
            if hot is None:
                return
            subject = f"shard{hot}"
            if not self._cooled("reshard", "pool", t) or not rm.can_start():
                self._hold(t, "reshard", "split", subject,
                           {"index": index, "busy": rm.busy},
                           cd_subject="pool")
                return
            pre = self._shard_state()
            mig = rm.maybe_split()
            if mig is None:
                return          # thin load sample / hot shard vanished
            cd = t + self._cooldown
            self._stamp("reshard", "pool", cd)
            self._record(
                t, "reshard", "split", subject,
                {"index": index, "hot_shard": hot,
                 "streak": self.agg._streaks.get(
                     ("shard.imbalance", "pool"), 0)},
                pre=pre, post=self._shard_state(), cooldown_until=cd)
            return
        if not self.agg.sustained("shard.underload", self._sustain):
            return
        rates = self.agg.ordered_rates()
        cold = self.agg.cold_shard(rates)
        if cold is None or cold not in self.fabric.shards \
                or len(self.fabric.shards) <= self._min_shards:
            return
        subject = f"shard{cold}"
        if not self._cooled("reshard", "pool", t) or not rm.can_start():
            self._hold(t, "reshard", "merge", subject, {"busy": rm.busy},
                       cd_subject="pool")
            return
        partner = self._adjacent_shard(cold)
        if partner is None:
            return
        pre = self._shard_state()
        rm.merge(cold, partner)
        cd = t + self._cooldown
        self._stamp("reshard", "pool", cd)
        self._record(
            t, "reshard", "merge", subject,
            {"cold_shard": cold, "into": partner,
             "rates": {str(k): round(v, 2) for k, v in sorted(
                 rates.items())}},
            pre=pre, post=self._shard_state(), cooldown_until=cd)

    def _adjacent_shard(self, sid: int) -> Optional[int]:
        """The live shard whose key range abuts `sid`'s (merge targets
        must be range-adjacent or the mapping ratchet can't fold them)."""
        from plenum_tpu_torch.shards import mapping as mapping_lib
        mine = None
        for d in self.fabric.mapping.descriptors:
            if d.shard_id == sid:
                mine = d
        if mine is None:
            return None
        for d in sorted(self.fabric.mapping.descriptors,
                        key=lambda d: d.lo):
            if d.shard_id == sid or d.shard_id not in self.fabric.shards:
                continue
            if mapping_lib.ranges_adjacent(mine, d) or \
                    mapping_lib.ranges_adjacent(d, mine):
                return d.shard_id
        return None

    # --- policy 2: pipeline lane re-placement -------------------------------

    def _policy_lanes(self, t: float) -> None:
        pipe = self.fabric.pipeline
        lanes = getattr(pipe, "lanes", None)
        if pipe is None or lanes is None:
            return
        for lane in lanes:
            subject = str(lane.idx)
            if not self.agg.sustained("pipeline.lane", self._sustain,
                                      subject=subject):
                continue
            pinned = [sid for sid, l in sorted(
                self.fabric.lane_pins.items())
                if l == lane.idx and sid in self.fabric.shards
                and sid not in self._repins]
            if not pinned:
                continue
            if not self._cooled("lane", subject, t):
                self._hold(t, "lane", "repin", subject,
                           {"breaker": lane.breaker_state()})
                continue
            target = pipe.healthy_lane(exclude=(lane.idx,))
            if target is None:
                continue        # nowhere healthier to go
            cd = t + self._cooldown
            self._stamp("lane", subject, cd)
            for sid in pinned:
                prev = self.fabric.repin_shard_lane(sid, target)
                seq = self._record(
                    t, "lane", "repin", f"shard{sid}",
                    {"sick_lane": lane.idx,
                     "breaker": lane.breaker_state()},
                    pre={"lane": prev}, post={"lane": target},
                    cooldown_until=cd)
                self._repins[sid] = {"prev": prev, "sick": lane.idx,
                                     "seq": seq}
        # restore pins after a stable re-warm: the sick lane's breaker
        # held CLOSED for the (longer) recovery window AND the cooldown
        # stamped at re-pin time has expired — never both sides of a
        # flap inside one window
        for sid, info in sorted(self._repins.items()):
            subject = str(info["sick"])
            if not self.agg.sustained_clear("pipeline.lane", self._recover,
                                            subject=subject):
                continue
            if not self._cooled("lane", subject, t):
                continue
            if sid not in self.fabric.shards:
                del self._repins[sid]
                continue
            cur = self.fabric.lane_pins.get(sid)
            self.fabric.repin_shard_lane(sid, info["prev"])
            cd = t + self._cooldown
            self._stamp("lane", subject, cd)
            self._record(
                t, "lane", "unpin", f"shard{sid}",
                {"healed_lane": info["sick"],
                 "clear_streak": self.agg._clear_streaks.get(
                     ("pipeline.lane", subject), 0)},
                pre={"lane": cur}, post={"lane": info["prev"]},
                cooldown_until=cd, cites=info["seq"])
            del self._repins[sid]

    # --- policy 3: observer fan-out per region ------------------------------

    def _policy_observers(self, t: float) -> None:
        fleet = getattr(self.fabric, "observers", None)
        if fleet is None:
            return
        for region in sorted(fleet.regions):
            n = fleet.count(region)
            if self.agg.sustained("slo_burn.reads", self._sustain,
                                  subject=region):
                burn = self.agg.burn.get(("reads", region))
                evidence = {"region": region, "observers": n,
                            **(burn.summary(t) if burn else {})}
                # the Proof-CDN signal (aggregator.note_edge): when the
                # region's edges already absorb nearly every verified
                # read, more observer capacity can't move the burn —
                # hold with the hit-rate as evidence instead of
                # spawning. No edge fleet -> no signal -> policy as
                # before (the observer fuzz pins that identity).
                rate_fn = getattr(self.agg, "edge_hit_rate", None)
                rate = rate_fn(region) if callable(rate_fn) else None
                if rate is not None:
                    evidence["edge_hit_rate"] = round(rate, 4)
                    if rate >= self._edge_absorb:
                        self._hold(t, "observer", "observer_spawn",
                                   region,
                                   {**evidence, "edge_absorbing": True})
                        continue
                if n >= self._obs_max:
                    # capacity exhausted: the ladder's cue, not ours
                    self._hold(t, "observer", "observer_spawn", region,
                               {**evidence, "at_max": True})
                    continue
                if not self._cooled("observer", region, t):
                    self._hold(t, "observer", "observer_spawn", region,
                               evidence)
                    continue
                name = fleet.spawn(region)
                cd = t + self._cooldown
                self._stamp("observer", region, cd)
                seq = self._record(
                    t, "observer", "observer_spawn", region, evidence,
                    pre={"observers": n}, post={"observers": n + 1,
                                                "spawned": name},
                    cooldown_until=cd)
                self._spawns.setdefault(region, []).append(seq)
            elif (self._spawns.get(region)
                  and n > self._obs_min
                  and self.agg.sustained_clear("slo_burn.reads",
                                               self._recover,
                                               subject=region)
                  and fleet.scale_in_safe(region)
                  and self._cooled("observer", region, t)):
                name = fleet.retire(region)
                if name is None:
                    continue
                cd = t + self._cooldown
                self._stamp("observer", region, cd)
                self._record(
                    t, "observer", "observer_retire", region,
                    {"region": region,
                     "demand": fleet._last_served.get(region, 0),
                     "capacity": fleet.capacity * (n - 1)},
                    pre={"observers": n},
                    post={"observers": n - 1, "retired": name},
                    cooldown_until=cd,
                    cites=self._spawns[region].pop())

    # --- policy 4: the degradation ladder -----------------------------------

    def _burning(self) -> list[list]:
        """(kind, subject) pairs whose burn judgment has been ACTIVE for
        2x the sustain window — burn that persisted despite policies
        1-3 having had a full window to act."""
        out = []
        for kind in self.SLO_KINDS:
            for s in self.agg.sustained_subjects(kind, 2 * self._sustain):
                out.append([kind, s])
        return out

    def _policy_ladder(self, t: float) -> None:
        burning = self._burning()
        if burning and self.level < len(LADDER) - 1:
            if not self._cooled("ladder", "pool", t):
                self._hold(t, "ladder", "degrade", "pool",
                           {"burning": burning})
                return
            pre = {"level": self.level, "state": LADDER[self.level]}
            self.level += 1
            self._apply_level()
            cd = t + self._cooldown
            self._stamp("ladder", "pool", cd)
            seq = self._record(
                t, "ladder", "degrade", LADDER[self.level],
                {"burning": burning},
                pre=pre, post={"level": self.level,
                               "state": LADDER[self.level]},
                cooldown_until=cd)
            self._ladder_seqs.append(seq)
        elif (self.level > 0 and not burning
              and all(self.agg.sustained_clear(kind, self._recover)
                      for kind in self.SLO_KINDS)
              and self._cooled("ladder", "pool", t)):
            pre = {"level": self.level, "state": LADDER[self.level]}
            left = LADDER[self.level]
            self.level -= 1
            self._apply_level()
            cd = t + self._cooldown
            self._stamp("ladder", "pool", cd)
            self._record(
                t, "ladder", "recover", left,
                {"clear_for": self._recover},
                pre=pre, post={"level": self.level,
                               "state": LADDER[self.level]},
                cooldown_until=cd,
                cites=self._ladder_seqs.pop())

    def _apply_level(self) -> None:
        """Make the fabric match self.level. Idempotent — applying the
        same level twice is a no-op at every actuator."""
        shed = self.level >= 1
        for plane in getattr(self.fabric, "ingress_planes", []):
            if shed:
                base = self.config.INGRESS_HIGH_WATERMARK
                plane.force_shed_watermark(
                    max(1, base // self._shed_factor))
            else:
                plane.force_shed_watermark(None)
        read_only = self.level >= 2
        for node in self.fabric.nodes.values():
            node.set_read_only(read_only, reason="autopilot")

    # --- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        return {"level": self.level, "state": LADDER[self.level],
                "records": len(self.ledger),
                "repins": {sid: info["sick"] for sid, info in
                           sorted(self._repins.items())},
                **self.counts}


def make_autopilot(fabric) -> Optional[Autopilot]:
    """Config-gated construction seam: ``AUTOPILOT=False`` (the
    default) returns None and the fabric pays one ``is None`` check per
    prod — today's behavior exactly, identity-pinned by test."""
    if not getattr(fabric.config, "AUTOPILOT", False):
        return None
    return Autopilot(fabric)
