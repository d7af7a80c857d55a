"""Proof CDN: the untrusted edge-cache tier for verified reads.

The verified reads made one VALIDATOR's read reply trustworthy (the
proof is anchored to a BLS multi-signed root), and the observer tier
(ingress/observer_reads.py) moved serving onto replicas outside the
consensus quorum. This module pushes the trust boundary to its endpoint:
an edge node holds NO signing keys, NO replicated state, and NO verified
anchor — it is a pure content-addressed cache of proof envelopes, and
every byte it serves is checked by the CLIENT's ``_verify_anchor`` path
(reads/proofs.py). The trust model is **deny-but-never-forge**:

  * A Byzantine edge can refuse, delay, or serve garbage — all of which
    the verifying client converts into one rung of ladder failover
    (reads/client.py). It can NEVER make a client accept a forged or
    over-stale result, because acceptance requires a proof that verifies
    against the pool BLS keys inside the client's freshness bound.
  * Because verification is client-side, the cache needs no integrity of
    its own: poisoned entries, poisoned invalidation hints, or a hostile
    operator degrade hit rate and latency (a DoS, bounded by failover),
    never correctness. The ``lying_edge`` fuzz kind pins this.

Three classes:

``EdgeCache``
    The bounded envelope cache. Entries are content-addressed by
    ``(anchor root, operation digest)`` — the same key discipline as the
    server-side ReadPlane — and carry the anchor timestamp parsed from
    their OWN envelope. Invalidation is anchor-advance fan-out: the
    validators' ``BatchCommitted`` push stream (the same stream observers
    replicate from) marks entries under a superseded root **stale**.
    Stale entries inside the ``DEFAULT_FRESHNESS_S`` bound are served
    stale-while-revalidate (the client's freshness check still passes;
    the origin refetch rides the same call); beyond the bound they are
    misses. Negative results (absence proofs — ``data: None`` under a
    real envelope) cache exactly like positive ones. Proofless origin
    results are passed through UNCACHED: an unverifiable byte is not
    worth storing.

    Push hints are adopted per (ledger, root) only at an f+1 vote of
    DISTINCT pushers, so f Byzantine validators cannot even churn the
    advisory anchor. The hint stays advisory either way: it only decides
    hit-vs-revalidate, never what the client accepts.

``SimEdge``
    The in-process edge node for SimNetwork pools: registers for pushes
    under ``edge:<name>`` over the SAME ``OBSERVER_REGISTER`` client
    plane observers use (the Observable push path doesn't care who
    listens), duck-types ``deliver_push`` so the test ingress router
    (route_pushes) drives it unchanged, and serves reads through the
    node-shaped ``handle_client_message``.

``EdgeFleet``
    Region-scoped edge placement over a ShardedSimFabric (the
    ObserverFleet analog): spawn/retire, a ``service()`` pump draining
    the push outboxes, and a per-window roll publishing each region's
    edge hit-rate into ``FleetAggregator.note_edge`` — the signal the
    autopilot's observer fan-out policy counts as absorbed capacity
    before spawning more observers (control/autopilot.py).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Callable, Mapping, Optional

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.node_messages import (BatchCommitted, Reply,
                                             RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack
from plenum_tpu_torch.crypto.multi_signature import MultiSignature

from . import proofs

# per-asker overlay fields: stripped before caching so one core entry
# serves every client, re-applied at serve time. NOT proofs.result_core
# (that strips the envelope too — the envelope IS the cached product).
_PERSONAL = ("identifier", "reqId")

# the serving NACK an edge returns for anything it cannot answer from
# cache or origin (writes, malformed queries, proofless origin misses):
# an explicit refusal the client ladder converts into failover
EDGE_CANNOT_SERVE = "edge cannot serve"


def _strip(result: Mapping) -> dict:
    return {k: v for k, v in result.items() if k not in _PERSONAL}


def _personalize(core: Mapping, request: Request) -> dict:
    out = dict(core)
    out["identifier"] = request.identifier
    out["reqId"] = request.req_id
    return out


def op_digest(request: Request) -> str:
    """The operation content address — same derivation as the server
    ReadPlane's cache key, so edge and origin dedup identically."""
    return hashlib.sha256(pack(request.operation)).hexdigest()


class _Entry:
    """One cached core result + the anchor coordinates parsed from its
    OWN envelope (never from a push: the entry's staleness story must
    come from the bytes the client will verify)."""

    __slots__ = ("core", "lid", "root_hex", "ts", "stale", "nbytes",
                 "negative")

    def __init__(self, core: dict, lid: int, root_hex: str,
                 ts: Optional[float], nbytes: int, negative: bool):
        self.core = core
        self.lid = lid
        self.root_hex = root_hex
        self.ts = ts
        self.stale = False
        self.nbytes = nbytes
        self.negative = negative


class EdgeCache:
    """Keyless, bounded, anchor-epoch-keyed envelope cache.

    origin(request) -> a result dict carrying a proof envelope (or None
    / proofless when the origin cannot serve). The cache NEVER inspects
    proof validity — it parses the envelope's multi-sig value purely for
    the (ledger, root, timestamp) coordinates that drive invalidation
    and the stale-while-revalidate window.
    """

    CACHE_MAX = 4096
    VOTES_MAX = 1024

    def __init__(self, origin: Callable[[Request], Optional[Mapping]],
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 now: Optional[Callable[[], float]] = None,
                 f: int = 1, cache_max: Optional[int] = None,
                 metrics: Optional[MetricsCollector] = None):
        import time as _time
        self._origin = origin
        self.freshness_s = freshness_s
        self._now = now or _time.time
        self.f = f
        self.cache_max = cache_max or self.CACHE_MAX
        self.metrics = metrics or MetricsCollector()
        # op digest -> entry (LRU); ledger id -> digests, for O(entries
        # of that ledger) invalidation on an anchor advance
        self._by_op: OrderedDict[str, _Entry] = OrderedDict()
        self._by_ledger: dict[int, set] = {}
        # advisory anchor per ledger: (root_hex, ts or None), adopted at
        # an f+1 vote of distinct pushers — a poisoned hint costs cache
        # churn, never a forged acceptance (the client verifies)
        self._advisory: dict[int, tuple] = {}
        self._votes: dict[tuple, set] = {}
        self.stats = {"queries": 0, "hits": 0, "misses": 0,
                      "stale_served": 0, "revalidations": 0,
                      "invalidations": 0, "negative_hits": 0,
                      "bytes_served": 0, "pushes": 0, "origin_fetches": 0,
                      "origin_proofless": 0}

    # --- invalidation: anchor-advance fan-out ----------------------------

    def on_push(self, lid: int, root_hex: str, ts: Optional[float],
                frm: str) -> bool:
        """One validator's anchor-advance hint; -> True when adopted
        (f+1 distinct pushers agreed on (ledger, root) and it is not a
        replay of the current advisory anchor)."""
        self.stats["pushes"] += 1
        if not root_hex:
            return False
        cur = self._advisory.get(lid)
        if cur is not None and cur[0] == root_hex:
            return False                  # replayed current anchor
        key = (lid, root_hex)
        votes = self._votes.setdefault(key, set())
        votes.add(frm)
        if len(self._votes) > self.VOTES_MAX:
            self._votes = {key: votes}
        if len(votes) < self.f + 1:
            return False
        # never move the advisory clock backwards: a lagging (or lying)
        # pusher quorum replaying an old root would otherwise flap every
        # fresh entry back to stale
        if cur is not None and cur[1] is not None and ts is not None \
                and ts < cur[1]:
            return False
        self._advisory[lid] = (root_hex, ts)
        del self._votes[key]
        self._invalidate(lid, root_hex)
        return True

    def _invalidate(self, lid: int, root_hex: str) -> None:
        for digest in self._by_ledger.get(lid, ()):
            entry = self._by_op.get(digest)
            if entry is not None and not entry.stale \
                    and entry.root_hex != root_hex:
                entry.stale = True
                self.stats["invalidations"] += 1
                self.metrics.add_event(MetricsName.EDGE_INVALIDATIONS)

    # --- serving ----------------------------------------------------------

    def serve(self, request: Request) -> Optional[dict]:
        """-> the personalized result (cache or origin), or None when
        neither can answer (the caller NACKs; the client fails over)."""
        self.stats["queries"] += 1
        self.metrics.add_event(MetricsName.EDGE_QUERIES)
        digest = op_digest(request)
        entry = self._by_op.get(digest)
        if entry is not None:
            # the ONE staleness clock that matters is the client's
            # freshness bound on the entry's own anchor timestamp: bytes
            # past it would be REJECTED (and read as a lying edge), so
            # they are never served — fresh-hit or superseded alike
            within = entry.ts is not None and \
                abs(self._now() - entry.ts) <= self.freshness_s
            if not entry.stale and within:
                return self._serve_entry(digest, entry, request)
            if within:
                # stale-while-revalidate: the superseded anchor is still
                # inside the client's freshness bound, so the old bytes
                # VERIFY — serve them and refresh from origin in the
                # same call (the sim twin of an async revalidation)
                out = self._serve_entry(digest, entry, request,
                                        stale=True)
                self._revalidate(digest, request)
                return out
            self._drop(digest, entry)     # past the bound: a dead entry
        self.stats["misses"] += 1
        self.metrics.add_event(MetricsName.EDGE_MISSES)
        fetched = self._fetch(request)
        if fetched is None:
            return None
        stored = self._store(digest, fetched)
        if stored is None:                # proofless: pass through uncached
            return _personalize(fetched, request)
        self.stats["bytes_served"] += stored.nbytes
        self.metrics.add_event(MetricsName.EDGE_BYTES_SERVED,
                               stored.nbytes)
        return _personalize(stored.core, request)

    def _serve_entry(self, digest: str, entry: _Entry, request: Request,
                     stale: bool = False) -> dict:
        self._by_op.move_to_end(digest)
        self.stats["hits"] += 1
        self.metrics.add_event(MetricsName.EDGE_HITS)
        if stale:
            self.stats["stale_served"] += 1
        if entry.negative:
            self.stats["negative_hits"] += 1
            self.metrics.add_event(MetricsName.EDGE_NEGATIVE_HITS)
        self.stats["bytes_served"] += entry.nbytes
        self.metrics.add_event(MetricsName.EDGE_BYTES_SERVED,
                               entry.nbytes)
        return _personalize(entry.core, request)

    def _revalidate(self, digest: str, request: Request) -> None:
        self.stats["revalidations"] += 1
        self.metrics.add_event(MetricsName.EDGE_REVALIDATIONS)
        fetched = self._fetch(request)
        if fetched is None or self._store(digest, fetched) is None:
            # origin down or proofless: the stale copy already went out;
            # drop it so the next read retries origin instead of serving
            # the same superseded bytes until the bound expires
            entry = self._by_op.get(digest)
            if entry is not None:
                self._drop(digest, entry)

    def _fetch(self, request: Request) -> Optional[dict]:
        self.stats["origin_fetches"] += 1
        try:
            result = self._origin(request)
        except Exception:
            return None
        return _strip(result) if isinstance(result, Mapping) else None

    # --- storage ----------------------------------------------------------

    def _store(self, digest: str, core: dict) -> Optional[_Entry]:
        coords = self._anchor_coords(core)
        if coords is None:
            self.stats["origin_proofless"] += 1
            return None
        lid, root_hex, ts = coords
        entry = _Entry(core, lid, root_hex, ts, nbytes=len(pack(core)),
                       negative=core.get("data") is None)
        advisory = self._advisory.get(lid)
        if advisory is not None and advisory[0] != root_hex:
            entry.stale = True            # born superseded: SWR material
        old = self._by_op.get(digest)
        if old is not None:
            self._by_ledger.get(old.lid, set()).discard(digest)
        self._by_op[digest] = entry
        self._by_op.move_to_end(digest)
        self._by_ledger.setdefault(lid, set()).add(digest)
        while len(self._by_op) > self.cache_max:
            victim, vent = self._by_op.popitem(last=False)
            self._by_ledger.get(vent.lid, set()).discard(victim)
        return entry

    def _drop(self, digest: str, entry: _Entry) -> None:
        self._by_op.pop(digest, None)
        self._by_ledger.get(entry.lid, set()).discard(digest)

    @staticmethod
    def _anchor_coords(core: Mapping) -> Optional[tuple]:
        """(ledger_id, state_root_hex, anchor timestamp) parsed from the
        entry's own envelope — the one layout authority is
        MultiSignature, never raw wire indexing. None = proofless."""
        env = core.get(proofs.READ_PROOF)
        if not isinstance(env, Mapping):
            return None
        try:
            value = MultiSignature.from_list(
                list(env["multi_signature"])).value
            return (int(value.ledger_id), str(value.state_root_hash),
                    float(value.timestamp))
        except Exception:
            return None

    def __len__(self) -> int:
        return len(self._by_op)


class SimEdge:
    """In-process edge node: push-fed cache + node-shaped client API."""

    def __init__(self, name: str,
                 origin: Callable[[Request], Optional[Mapping]],
                 now: Callable[[], float],
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 f: int = 1,
                 send: Optional[Callable] = None,
                 metrics: Optional[MetricsCollector] = None):
        self.name = name
        self.client_id = f"edge:{name}"
        self.cache = EdgeCache(origin, freshness_s=freshness_s, now=now,
                               f=f, metrics=metrics)
        self.sent: list = []              # (msg, client) when no send given
        self._send = send or (lambda msg, client: self.sent.append(
            (msg, client)))

    # --- invalidation feed (the observer push path, reused verbatim) ------

    def register(self, submit: Callable[[str, dict], None],
                 validator_names) -> None:
        """submit(validator_name, msg_dict): subscribe this edge's client
        id to BatchCommitted pushes — the SAME Observable registration
        observers use; the push path doesn't care that this listener
        holds no state and no keys."""
        for v in validator_names:
            submit(v, {"op": "OBSERVER_REGISTER"})

    def deliver_push(self, batch, frm: str) -> bool:
        """One validator's push -> True when it advanced the advisory
        anchor. Route-compatible with SimObserver.deliver_push, so the
        test ingress router drives edges and observers identically."""
        if isinstance(batch, dict):
            try:
                batch = BatchCommitted.from_dict(batch)
            except Exception:
                return False
        if not isinstance(batch, BatchCommitted):
            return False
        lid, root, ts = batch.ledger_id, batch.state_root, None
        if batch.multi_sig:
            try:
                value = MultiSignature.from_list(
                    list(batch.multi_sig)).value
                lid, root = int(value.ledger_id), str(value.state_root_hash)
                ts = float(value.timestamp)
            except Exception:
                pass                      # fall back to the batch fields
        return self.cache.on_push(lid, root, ts, frm)

    # --- read serving (node-shaped client API) ----------------------------

    def serve(self, msg: dict):
        try:
            request = Request.from_dict(msg)
        except Exception:
            return RequestNack(identifier=str(msg.get("identifier")),
                               req_id=msg.get("reqId") or 0,
                               reason="malformed request")
        result = self.cache.serve(request)
        if result is None:
            # writes, origin outages, proofless misses: one explicit
            # refusal; the verifying client's ladder falls over
            return RequestNack(identifier=request.identifier,
                               req_id=request.req_id,
                               reason=EDGE_CANNOT_SERVE)
        return Reply(result=result)

    def handle_client_message(self, msg: dict, frm: str) -> None:
        self._send(self.serve(msg), frm)


class EdgeFleet:
    """Region-scoped Proof-CDN placement over a ShardedSimFabric.

    The ObserverFleet analog one tier further out: each region holds a
    stack of SimEdges whose origin is the anchored shard's validator
    read planes (round-robin — every origin fetch IS pool read load,
    which is exactly what the edge tier exists to keep near zero).
    ``service()`` (fabric prod loop) drains the push outboxes into every
    member cache and rolls each region's per-window (hits, served,
    bytes) ledger into ``FleetAggregator.note_edge`` — the per-region
    hit-rate signal the autopilot's observer policy reads as absorbed
    capacity.
    """

    def __init__(self, fabric, regions=("r0",), sid: int = 0,
                 per_region: int = 1, f: int = 1,
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S):
        self.fabric = fabric
        self.sid = sid
        self.f = f
        self.freshness_s = freshness_s
        self.regions: dict[str, list[SimEdge]] = {r: [] for r in regions}
        self._interval = getattr(fabric.config, "TELEMETRY_INTERVAL", 1.0)
        self._window_start = fabric.timer.get_current_time()
        self._rr = {r: 0 for r in regions}
        self._origin_rr = 0
        self._retired_ids: set = set()
        self._n = 0
        # last cumulative (hits, queries, bytes) folded per region, so
        # each window's note_edge carries DELTAS, not lifetime totals
        self._last_fold: dict[str, tuple] = {r: (0, 0, 0) for r in regions}
        self.stats = {"spawned": 0, "retired": 0, "reads": 0,
                      "verify_failures": 0}
        for r in regions:
            for _ in range(per_region):
                self.spawn(r)

    def _shard(self):
        return self.fabric.shards[self.sid]

    def _origin(self):
        """One origin fetch = one pool read: round-robin the shard's
        validator read planes (the same anchored planes validators serve
        clients from)."""
        def fetch(request: Request):
            shard = self._shard()
            name = shard.names[self._origin_rr % len(shard.names)]
            self._origin_rr += 1
            return shard.nodes[name].read_plane.answer(request)
        return fetch

    # --- the spawn/retire seam --------------------------------------------

    def spawn(self, region: str) -> str:
        shard = self._shard()
        self._n += 1
        name = f"{region}-edge{self._n}"
        edge = SimEdge(name, self._origin(),
                       now=self.fabric.timer.get_current_time,
                       freshness_s=self.freshness_s, f=self.f,
                       metrics=self.fabric.metrics)
        edge.register(lambda v, msg: shard.nodes[v]
                      .handle_client_message(msg, edge.client_id),
                      shard.names)
        self.regions[region].append(edge)
        self.stats["spawned"] += 1
        return name

    def retire(self, region: str) -> Optional[str]:
        group = self.regions[region]
        if len(group) <= 1:
            return None
        edge = group.pop()
        self._retired_ids.add(edge.client_id)
        for node in self._shard().nodes.values():
            observable = getattr(node, "observable", None)
            if observable is not None:
                observable.remove_observer(edge.client_id)
        self.stats["retired"] += 1
        return edge.name

    def count(self, region: str) -> int:
        return len(self.regions[region])

    # --- the pump ----------------------------------------------------------

    def service(self) -> None:
        shard = self._shard()
        by_id = {e.client_id: e
                 for group in self.regions.values() for e in group}
        for v in shard.names:
            msgs = shard.client_msgs[v]
            keep = []
            for m, cid in msgs:
                edge = by_id.get(cid)
                if edge is not None:
                    if isinstance(m, BatchCommitted):
                        edge.deliver_push(m, v)
                elif cid not in self._retired_ids:
                    keep.append((m, cid))
            shard.client_msgs[v] = keep
        self._roll_window()

    def _fold(self, region: str) -> tuple:
        hits = queries = nbytes = entries = 0
        for edge in self.regions[region]:
            s = edge.cache.stats
            hits += s["hits"]
            queries += s["queries"]
            nbytes += s["bytes_served"]
            entries += len(edge.cache)
        return hits, queries, nbytes, entries

    def _roll_window(self) -> None:
        now = self.fabric.timer.get_current_time()
        if now - self._window_start < self._interval:
            return
        self._window_start = now
        agg = self.fabric.aggregator
        note = getattr(agg, "note_edge", None)
        for region in self.regions:
            hits, queries, nbytes, entries = self._fold(region)
            lh, lq, lb = self._last_fold[region]
            self._last_fold[region] = (hits, queries, nbytes)
            if queries - lq and callable(note):
                note(region, hits - lh, queries - lq,
                     edges=len(self.regions[region]),
                     bytes_served=nbytes - lb, now=now,
                     cache_entries=entries)

    # --- read serving -------------------------------------------------------

    def serve_read(self, region: str, msg: dict):
        group = self.regions[region]
        i = self._rr[region] % len(group)
        self._rr[region] = i + 1
        self.stats["reads"] += 1
        return group[i].serve(msg)

    def note_verify_failure(self, region: str) -> None:
        """A verifying client rejected an edge-served reply — the ONE
        signal only the client holds (the keyless edge cannot judge its
        own bytes); wired back here so the fleet's metrics carry it."""
        self.stats["verify_failures"] += 1
        self.fabric.metrics.add_event(MetricsName.EDGE_VERIFY_FAILURES)

    def summary(self) -> dict:
        per_region = {}
        for r in sorted(self.regions):
            hits, queries, nbytes, entries = self._fold(r)
            per_region[r] = {
                "edges": len(self.regions[r]), "queries": queries,
                "hits": hits, "bytes": nbytes, "cache_entries": entries,
                "hit_rate": round(hits / queries, 4) if queries else None}
        origin = sum(e.cache.stats["origin_fetches"]
                     for g in self.regions.values() for e in g)
        return {"regions": per_region, "origin_fetches": origin,
                **self.stats}
