"""Live shard split/merge: resharding as a mapping-ledger transaction.

PR 10 made the shard map *provable* and gave it an epoch ratchet built
"precisely so stale maps fail closed mid-reshard"; PR 11 built the shard
load-imbalance index "the input live split/merge consumes". This module
cashes both in: adding capacity is no longer a redeploy but a LEDGER
TRANSACTION that migrates a key range between sub-pools under traffic
without dropping or duplicating an admitted write.

One migration runs at a time, as a three-phase state machine driven from
the fabric's prod loop:

1. **COPY** — the target sub-pool is booted (split) or already live
   (merge) and the copy cursor walks the source shard's domain ledger in
   order, replaying every txn whose routing key falls in the moving
   range into the target's ordering via ``submit_preverified`` (the
   write was client-auth-verified when first admitted; the ledger
   envelope carries no signature to re-check). Replays are keyed by
   payload digest, and the target's own seq-no-DB dedup makes a replay
   racing the client's re-submission settle on ONE ordering. The
   mapping is UNCHANGED throughout: the source still owns the range,
   new writes keep routing to it, and the cursor keeps draining until
   it reaches the source tip with every replay ordered at the target.
   A copy that cannot complete within ``RESHARD_COPY_TIMEOUT`` ABORTS
   fail-closed: descriptors untouched, source keeps serving, the
   half-copied target retires (split) or just keeps its own keys
   (merge).

2. **HANDOFF** — the commit point: ``MappingLedger.reshard`` publishes
   the new descriptors under a bumped epoch. From this instant routers
   resolving the live map send moving-range writes to the new owner,
   and every ratcheted verifier rejects proofs minted under the old
   map (``stale_map``). For the bounded dual-ownership window
   (``RESHARD_HANDOFF_WINDOW``) the OLD owner forwards any
   stale-routed write for the moved range to the new owner — the old
   owner forwards, the new owner orders — while the cursor drains the
   source's last in-pipeline orderings across. The window extends
   while such a tail is still draining (dual ownership ends only when
   nothing is left in flight), then:

3. **DONE** — past the window a stale-epoch write for a moved range is
   NACKed fail-closed with a retryable refresh hint, never silently
   double-owned; reads at the old owner already fail closed through
   the ownership proof (``wrong_shard`` under the new map).

The imbalance-driven entry point is :meth:`ReshardManager.maybe_split`:
when the PR 11 aggregator flags a hot shard past
``SHARD_IMBALANCE_THRESHOLD``, the hot range splits at its midpoint
onto a freshly booted sub-pool.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution import txn as txn_lib

from . import mapping as mapping_lib
from .mapping import ShardDescriptor, range_midpoint

COPYING = "copying"
HANDOFF = "handoff"
DONE = "done"
ABORTED = "aborted"

STALE_WRITE_NACK = "resharded: owning shard changed, refresh mapping"


class Migration:
    """One live key-range migration [lo, hi): source -> target."""

    def __init__(self, source: int, target: int, lo: str,
                 hi: Optional[str], merge: bool, started_t: float):
        self.source = source
        self.target = target
        self.lo = lo
        self.hi = hi
        self.merge = merge
        self.phase = COPYING
        self.started_t = started_t
        self.ratchet_t: Optional[float] = None
        self.handoff_deadline: Optional[float] = None
        self.drain_until: Optional[float] = None
        self.cursor = 1              # source ledger seq scanned (1 = genesis)
        # payload digest -> reconstructed Request replayed to the target
        # but not yet seen ordered there
        self.pending: dict[str, Request] = {}
        self.copied = 0
        self.forwarded = 0
        self.stale_nacked = 0
        self.unsettled = 0           # replays abandoned at the hard cap

    def covers(self, point: str) -> bool:
        return self.lo <= point and (self.hi is None or point < self.hi)

    def progress(self, source_size: int) -> float:
        if self.phase in (DONE, ABORTED):
            return 1.0
        scanned = self.cursor / max(1, source_size)
        if self.pending:
            scanned = min(scanned, 0.99)
        return round(min(1.0, scanned), 3)

    def to_dict(self) -> dict:
        return {"source": self.source, "target": self.target,
                "lo": self.lo[:8], "hi": self.hi[:8] if self.hi else None,
                "merge": self.merge, "phase": self.phase,
                "copied": self.copied, "forwarded": self.forwarded,
                "stale_nacked": self.stale_nacked,
                "unsettled": self.unsettled,
                "pending": len(self.pending)}


class ReshardManager:
    """Owns the fabric's migrations; drive with ``service()`` each tick.

    The guard seam (``guard``) sits in front of every shard intake: a
    write arriving at a shard that no longer owns its key (a stale
    routing decision racing the ratchet) is forwarded to the new owner
    inside the handoff window and NACKed fail-closed after it.
    """

    def __init__(self, fabric):
        self.fabric = fabric
        self.config = fabric.config
        self.active: Optional[Migration] = None
        self.history: list[Migration] = []
        self._in_service = False
        # stamped when a migration finishes (DONE or ABORTED): the
        # idempotent entry guard below refuses a fresh `maybe_split`
        # until it expires, so a reshard never chases its own transient
        self.cooldown_until = 0.0

    # --- planning ----------------------------------------------------------

    @property
    def busy(self) -> bool:
        return self.active is not None

    def can_start(self) -> bool:
        """The idempotent entry guard: a second caller during an
        in-flight migration, or any caller inside the post-migration
        cooldown, gets a clean no-op instead of the double-entry
        assert — external discipline is no longer what prevents it."""
        return self.active is None and self._now() >= self.cooldown_until

    def maybe_split(self, nodes_per_shard: Optional[int] = None
                    ) -> Optional[Migration]:
        """The imbalance-driven entry point: when the aggregator flags a
        hot shard, split its range at the MEDIAN OF ITS OBSERVED LOAD
        (the recent ledger's routing-key points) onto a new sub-pool —
        a geometric midpoint would halve the keyspace, not the traffic,
        and a skewed key population would stay flagged after the split."""
        if not self.can_start():
            return None
        _index, hot = self.fabric.aggregator.load_imbalance()
        if hot is None or hot not in self.fabric.shards:
            return None
        return self.split(hot, point=self._load_median(hot),
                          nodes_per_shard=nodes_per_shard)

    def _load_median(self, sid: int, window: int = 256
                     ) -> Optional[str]:
        """The median routing-key point of the shard's trailing ledger
        window — the split point that halves recent TRAFFIC. None (->
        range midpoint) when the sample is too thin to trust."""
        desc = self._descriptor(sid)
        ledger = self._shard_ledger(sid)
        points = []
        for seq in range(max(2, ledger.size - window + 1),
                         ledger.size + 1):
            txn = ledger.get_by_seq_no(seq)
            data = txn_lib.txn_data(txn)
            meta = txn.get("txn", {}).get("metadata", {})
            try:
                key = mapping_lib.routing_key(data, meta.get("from"))
            except ValueError:
                continue
            point = mapping_lib.key_point(key)
            if desc.owns_point(point):
                points.append(point)
        if len(points) < 8:
            return None
        points.sort()
        median = points[len(points) // 2]
        if not (desc.lo < median and
                (desc.hi is None or median < desc.hi)):
            return None
        return median

    def split(self, sid: int, point: Optional[str] = None,
              nodes_per_shard: Optional[int] = None) -> Migration:
        """Boot a new sub-pool and start migrating [point, hi) to it."""
        assert self.active is None, "one migration at a time"
        desc = self._descriptor(sid)
        point = point or range_midpoint(desc.lo, desc.hi)
        assert desc.lo < point and (desc.hi is None or point < desc.hi), \
            "split point outside the shard's range"
        # retired sids count too: reusing a merged-away shard's id
        # would recreate its node NAMES (and name-seeded keys) and
        # conflate two distinct sub-pools everywhere downstream
        new_sid = max(list(self.fabric.shards)
                      + list(self.fabric.retired)) + 1
        self.fabric.add_shard(new_sid, nodes_per_shard=nodes_per_shard)
        self.active = Migration(sid, new_sid, point, desc.hi, merge=False,
                                started_t=self._now())
        self.fabric.metrics.add_event(MetricsName.RESHARD_MIGRATIONS)
        return self.active

    def merge(self, source_sid: int, into_sid: int) -> Migration:
        """Migrate ALL of source's range into an adjacent shard; the
        source sub-pool retires once the handoff window closes."""
        assert self.active is None, "one migration at a time"
        src = self._descriptor(source_sid)
        dst = self._descriptor(into_sid)
        assert mapping_lib.ranges_adjacent(src, dst) or \
            mapping_lib.ranges_adjacent(dst, src), \
            "merge requires adjacent key ranges"
        self.active = Migration(source_sid, into_sid, src.lo, src.hi,
                                merge=True, started_t=self._now())
        self.fabric.metrics.add_event(MetricsName.RESHARD_MIGRATIONS)
        return self.active

    # --- the state machine -------------------------------------------------

    def service(self) -> None:
        m = self.active
        if m is None or self._in_service:
            return
        self._in_service = True
        try:
            if m.phase == COPYING:
                self._service_copy(m)
            if m.phase == HANDOFF:
                self._service_handoff(m)
        finally:
            self._in_service = False

    def _service_copy(self, m: Migration) -> None:
        self._scan_source(m)
        self._settle_pending(m)
        at_tip = m.cursor >= self._source_ledger(m).size
        if at_tip and not m.pending:
            self._ratchet(m)
        elif self._now() - m.started_t > \
                getattr(self.config, "RESHARD_COPY_TIMEOUT", 120.0):
            self._abort(m)

    def _service_handoff(self, m: Migration) -> None:
        # the source may still be ordering writes that were in its
        # pipeline at the ratchet instant: keep draining them across
        self._scan_source(m)
        self._settle_pending(m)
        now = self._now()
        window = getattr(self.config, "RESHARD_HANDOFF_WINDOW", 10.0)
        draining = m.pending or m.cursor < self._source_ledger(m).size
        if now >= m.handoff_deadline + 5 * window and m.pending:
            # hard cap: a replay the target will never order (it has
            # been refusing it for five windows) must not leave the
            # fabric in dual-ownership forever — complete the
            # migration, surface the unsettled count loudly, keep
            # failing closed at the guard. The fuzz pins this at zero.
            m.unsettled = len(m.pending)
            self.fabric.metrics.add_event(MetricsName.RESHARD_UNSETTLED,
                                          m.unsettled)
            m.pending.clear()
            draining = False
        elif now < m.handoff_deadline or draining:
            return
        m.phase = DONE
        m.drain_until = now
        if m.merge:
            self.fabric.retire_shard(m.source)
        self.history.append(m)
        self.active = None
        self.cooldown_until = now + getattr(self.config,
                                            "RESHARD_COOLDOWN", 30.0)

    def _ratchet(self, m: Migration) -> None:
        """The commit point: publish the new map under a bumped epoch."""
        fab = self.fabric
        descriptors = []
        from plenum_tpu_torch.tools.local_pool import pool_bls_keys
        for d in fab.mapping.descriptors:
            if d.shard_id == m.source and not m.merge:
                # split: source keeps [lo, point)
                descriptors.append(ShardDescriptor(
                    d.shard_id, d.lo, m.lo, d.nodes, d.bls_keys))
            elif d.shard_id == m.source and m.merge:
                continue                  # merged away
            elif d.shard_id == m.target and m.merge:
                lo = min(d.lo, m.lo)
                hi = d.hi if (m.hi is not None and d.hi is not None
                              and d.hi > m.hi) else m.hi
                if d.hi is None or m.hi is None:
                    hi = None
                descriptors.append(ShardDescriptor(
                    d.shard_id, lo, hi, d.nodes, d.bls_keys))
            else:
                descriptors.append(ShardDescriptor(
                    d.shard_id, d.lo, d.hi, d.nodes, d.bls_keys))
        if not m.merge:
            names = fab.shards[m.target].names
            descriptors.append(ShardDescriptor(
                m.target, m.lo, m.hi, names, pool_bls_keys(names)))
        descriptors.sort(key=lambda d: d.lo)
        fab.mapping.reshard(descriptors)
        m.phase = HANDOFF
        m.ratchet_t = self._now()
        m.handoff_deadline = m.ratchet_t + \
            getattr(self.config, "RESHARD_HANDOFF_WINDOW", 10.0)

    def _abort(self, m: Migration) -> None:
        """Fail closed: descriptors untouched, the source keeps serving;
        a half-booted split target retires empty."""
        m.phase = ABORTED
        if not m.merge:
            self.fabric.retire_shard(m.target)
        self.history.append(m)
        self.active = None
        self.cooldown_until = self._now() + getattr(
            self.config, "RESHARD_COOLDOWN", 30.0)

    # --- the copy cursor ---------------------------------------------------

    def _scan_source(self, m: Migration) -> None:
        ledger = self._source_ledger(m)
        budget = getattr(self.config, "RESHARD_COPY_BATCH", 64)
        while m.cursor < ledger.size and budget > 0:
            m.cursor += 1
            budget -= 1
            txn = ledger.get_by_seq_no(m.cursor)
            req = self._replayable(txn, m)
            if req is None:
                continue
            if req.payload_digest in m.pending:
                continue
            m.pending[req.payload_digest] = req
            for node in self.fabric.shards[m.target].nodes.values():
                node.submit_preverified(req, "reshard")
            self.fabric.metrics.add_event(MetricsName.RESHARD_COPIED)

    def _replayable(self, txn: dict, m: Migration) -> Optional[Request]:
        """Reconstruct the admitted write a ledger txn records, iff its
        routing key lies in the moving range. The envelope carries no
        signature (it was verified at admission) — the replay rides the
        preverified seam, and the preserved identifier/reqId/operation
        keep the payload digest stable so dedup holds end to end."""
        ttype = txn_lib.txn_type_of(txn)
        if ttype not in (txn_lib.NYM, txn_lib.ATTRIB):
            return None
        data = dict(txn_lib.txn_data(txn))
        meta = txn.get("txn", {}).get("metadata", {})
        identifier = meta.get("from")
        req_id = meta.get("reqId")
        if not identifier or req_id is None:
            return None                   # genesis rows carry no author
        try:
            key = mapping_lib.routing_key(data, identifier)
        except ValueError:
            return None
        if not m.covers(mapping_lib.key_point(key)):
            return None
        operation = {"type": ttype, **data}
        return Request(identifier, req_id, operation,
                       protocol_version=txn.get("txn", {})
                       .get("protocolVersion", 2))

    def _settle_pending(self, m: Migration) -> None:
        if not m.pending:
            return
        # ANY member's seq-no DB settles a replay: a member that was
        # partitioned through the ordering and rejoined via catchup
        # also records it (write_manager.apply_committed_txn), but the
        # quorum that ordered is the authoritative witness either way
        nodes = list(self.fabric.shards[m.target].nodes.values())
        settled = [d for d, req in m.pending.items()
                   if any(n._executed_txn(req) is not None
                          for n in nodes)]
        for d in settled:
            del m.pending[d]
            m.copied += 1

    # --- the intake guard ---------------------------------------------------

    def guard(self, sid: int, request: Request, frm: str) -> Optional[str]:
        """Called by a shard's intake for every arriving write. Returns
        None (deliver to `sid` normally), "forwarded" (delivered to the
        new owner inside the handoff window), or "stale" (fail-closed
        NACK: the caller must surface STALE_WRITE_NACK, retryable after
        a map refresh)."""
        if self.active is None and not self.history:
            # steady state on a never-resharded fabric: the map has
            # never moved, so no routing decision can be stale — skip
            # the key re-derivation entirely (the routers' hot path).
            # Once ANY migration happened the guard stays on forever:
            # a stale route to an old owner is double-ownership.
            return None
        try:
            key = mapping_lib.routing_key(request.operation,
                                          request.identifier)
        except ValueError:
            return None
        point = mapping_lib.key_point(key)
        owner = self._owner_of(point)
        if owner is None or owner == sid:
            return None                   # sid still owns it: deliver
        # a stale routing decision: the map moved this key off `sid` —
        # forwarded while the migration is still in its handoff window,
        # failed closed (explicit retryable NACK) after it
        m = self.active
        if m is not None and m.source == sid and m.phase == HANDOFF \
                and m.covers(point):
            m.forwarded += 1
            self.fabric.metrics.add_event(MetricsName.RESHARD_FORWARDED)
            self.fabric.deliver_to_shard(m.target, request, frm)
            return "forwarded"
        self.fabric.metrics.add_event(MetricsName.RESHARD_STALE_NACKS)
        if self.active is not None and self.active.source == sid:
            self.active.stale_nacked += 1
        elif self.history:
            self.history[-1].stale_nacked += 1
        return "stale"

    # --- telemetry ----------------------------------------------------------

    def state_for(self, sid: int) -> dict:
        """The `shard_map` telemetry state section for a node of shard
        `sid`: the mapping epoch its pool serves under, plus live
        migration role/progress while this shard is involved — the
        columns the fleet console renders so an operator can watch a
        reshard converge."""
        out = {"epoch": self.fabric.mapping.epoch}
        m = self.active
        if m is not None and sid in (m.source, m.target):
            out["migration"] = {
                "role": "source" if sid == m.source else "target",
                "phase": m.phase,
                "progress": m.progress(self._source_ledger(m).size),
            }
        return out

    def summary(self) -> dict:
        out = {"epoch": self.fabric.mapping.epoch,
               "migrations": len(self.history)
               + (1 if self.active else 0),
               "cooldown_until": round(self.cooldown_until, 3)}
        if self.active is not None:
            out["active"] = self.active.to_dict()
        if self.history:
            out["last"] = self.history[-1].to_dict()
        return out

    # --- helpers ------------------------------------------------------------

    def _now(self) -> float:
        return self.fabric.timer.get_current_time()

    def _descriptor(self, sid: int) -> ShardDescriptor:
        for d in self.fabric.mapping.descriptors:
            if d.shard_id == sid:
                return d
        raise LookupError(f"shard {sid} not in the map")

    def _owner_of(self, point: str) -> Optional[int]:
        for d in self.fabric.mapping.descriptors:
            if d.owns_point(point):
                return d.shard_id
        return None

    def _source_ledger(self, m: Migration):
        return self._shard_ledger(m.source)

    def _shard_ledger(self, sid: int):
        shard = self.fabric.shards.get(sid) or self.fabric.retired.get(sid)
        node = next(iter(shard.nodes.values()))
        return node.c.db.get_ledger(DOMAIN_LEDGER_ID)
