"""Client half of the verified read plane.

`ReadCheck` is the verification core both drivers share: given a request
and one node's reply, it verifies the proof envelope (proofs.py) against
the pool's BLS keys and a freshness bound, timing every check.

`VerifyingReadClient` is the TCP client: each read goes to ONE node; a
verified reply ends the read (fanout 1 request + 1 reply). The failover
ladder walks the remaining nodes on forged/stale/missing-data replies and
per-node timeouts; only when replies carry NO proof at all (a pool that
cannot anchor one yet) does it escalate to the legacy f+1 broadcast of
PoolClient.submit.

`SimReadDriver` runs the same ladder over an in-process sim pool
(tests/test_reads.py, test_sim_fuzz.py lying_reader, the read-heavy bench
config) where transport is `node.handle_client_message` + a reply sink.
"""
from __future__ import annotations

import time
from typing import Callable, Mapping, Optional, Sequence

from plenum_tpu_torch.common.metrics import percentile
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack
from plenum_tpu_torch.client.client import PoolClient

from . import proofs


class ReadClientStats:
    """Counters + verify-latency samples for one client instance."""

    def __init__(self):
        self.reads = 0
        self.single_reply_ok = 0
        self.failovers = 0
        self.fallbacks = 0
        self.verify_failures = 0
        self.timeouts = 0
        self.msgs_sent = 0
        self.replies_seen = 0
        # observer tier (ingress/observer_reads.py): reads served by an
        # observer rung, and proofless observer replies that escalated
        # the ladder to a validator (anchor lag / unanchorable replica)
        self.observer_ok = 0
        self.observer_escalations = 0
        # edge tier (reads/edge.py): reads served by a keyless Proof-CDN
        # cache rung, proofless edge replies that escalated, and edge
        # replies the client REJECTED (forged/over-stale — the deny-but-
        # never-forge ledger the lying_edge fuzz pins)
        self.edge_ok = 0
        self.edge_escalations = 0
        self.edge_verify_failures = 0
        # sharded-plane ladder: reads that refreshed the client's map
        # view and retried once against the new epoch (a healthy reshard
        # in flight must not surface as a client error)
        self.map_retries = 0
        self.verify_s: list[float] = []

    def note_verify(self, dt: float) -> None:
        if len(self.verify_s) < 65536:
            self.verify_s.append(dt)

    def summary(self) -> dict:
        out = {"reads": self.reads,
               "single_reply_ok": self.single_reply_ok,
               "failovers": self.failovers,
               "fallbacks": self.fallbacks,
               "verify_failures": self.verify_failures,
               "timeouts": self.timeouts,
               "msgs_sent": self.msgs_sent,
               "replies_seen": self.replies_seen}
        if self.observer_ok or self.observer_escalations:
            out["observer_ok"] = self.observer_ok
            out["observer_escalations"] = self.observer_escalations
        if self.edge_ok or self.edge_escalations \
                or self.edge_verify_failures:
            out["edge_ok"] = self.edge_ok
            out["edge_escalations"] = self.edge_escalations
            out["edge_verify_failures"] = self.edge_verify_failures
        if self.map_retries:
            out["map_retries"] = self.map_retries
        if self.reads:
            out["fanout"] = round(
                (self.msgs_sent + self.replies_seen) / self.reads, 2)
        if self.verify_s:
            out["verify_ms_p50"] = round(
                percentile(self.verify_s, 0.5) * 1000, 3)
            out["verify_ms_p95"] = round(
                percentile(self.verify_s, 0.95) * 1000, 3)
        return out


class ReadCheck:
    """Shared verification core: pool BLS keys + freshness policy."""

    def __init__(self, bls_keys: Mapping[str, str],
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 now: Optional[Callable[[], float]] = None,
                 n_nodes: Optional[int] = None,
                 stats: Optional[ReadClientStats] = None):
        self.bls_keys = dict(bls_keys)
        self.freshness_s = freshness_s
        self.now = now
        self.n_nodes = n_nodes
        self.stats = stats or ReadClientStats()
        # verified-multi-sig memo: one 2-pairing check per anchor, not
        # per read (verify_read_proof ms_cache contract)
        self._ms_cache: dict = {}

    def check(self, request: Request, result: Mapping) -> tuple[bool, str]:
        t0 = time.perf_counter()
        ok, reason = proofs.verify_read_proof(
            request.txn_type, request.operation, result,
            self.bls_keys, freshness_s=self.freshness_s, now=self.now,
            n_nodes=self.n_nodes, ms_cache=self._ms_cache)
        self.stats.note_verify(time.perf_counter() - t0)
        if not ok and reason != proofs.NO_PROOF:
            self.stats.verify_failures += 1
        return ok, reason


def ladder_order(names: Sequence[str], request: Request) -> list[str]:
    """Per-read node rotation: spread load across the pool while keeping
    the order deterministic per request (replayable sims)."""
    names = list(names)
    if not names:
        return names
    start = sum(request.digest.encode()) % len(names)
    return names[start:] + names[:start]


class VerifyingReadClient(PoolClient):
    """One proof-verified reply per read, over the node client ports.

    With `observer_addrs`, reads try the OBSERVER tier first (verified
    reads scale horizontally off the pool — ingress/observer_reads.py)
    and fail over to validators on forgery, timeout, or a proofless
    observer reply (anchor lag escalates, it never breaks the ladder);
    only a proofless VALIDATOR reply means the pool cannot anchor yet
    and escalates to the legacy f+1 broadcast — which never includes
    observers (f counts validators; the quorum stays a validator quorum).

    With `edge_addrs`, the keyless Proof-CDN tier (reads/edge.py) rides
    a rung BEFORE the observers: an edge holds no keys and no state, so
    a tampered, stale, or refused edge reply is just one more failover
    (deny-but-never-forge — the client's verify gate is the only trust
    anchor), and edges never join the escalation broadcast either.
    """

    def __init__(self, node_addrs: dict, f: int,
                 bls_keys: Mapping[str, str],
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 now: Optional[Callable[[], float]] = None,
                 observer_addrs: Optional[dict] = None,
                 checker=None,
                 shard_resolver: Optional[Callable[[Request],
                                                   Optional[Sequence[str]]]]
                 = None,
                 map_refresh: Optional[Callable[[], bool]] = None,
                 edge_addrs: Optional[dict] = None):
        super().__init__(node_addrs, f)
        self.observer_addrs = dict(observer_addrs or {})
        self.edge_addrs = dict(edge_addrs or {})
        self._all_addrs = {**self.edge_addrs, **self.observer_addrs,
                          **self.node_addrs}
        # checker: injectable verification core — the sharded plane's
        # CrossShardReadCheck (mapping-ownership proof + the OWNING
        # shard's BLS keys) rides the same ladder as the flat ReadCheck
        self.checker = checker if checker is not None else ReadCheck(
            bls_keys, freshness_s=freshness_s, now=now,
            n_nodes=len(node_addrs))
        # shard_resolver(request) -> the owning shard's node names (or
        # None: flat pool). The failover ladder AND the escalation
        # broadcast stay inside the owning shard: a foreign shard's
        # nodes don't hold the key and a "verified" answer from one
        # (absence against ITS root) would be a wrong-shard lie
        self.shard_resolver = shard_resolver
        # map_refresh() -> True when the client's shard map view
        # advanced to a newer epoch. A read that fails with a stale_map
        # verdict (or exhausts its ladder) refreshes and retries ONCE
        # against the new routing — a healthy reshard in flight must
        # not surface as a terminal read failure.
        self.map_refresh = map_refresh
        self.stats = self.checker.stats

    def _addr_of(self, name: str) -> tuple:
        # the read ladder also dials observers; the broadcast fallback
        # (PoolClient.submit) still iterates node_addrs only
        return self._all_addrs[name]

    async def submit_read(self, request: Request, timeout: float = 30.0,
                          per_node_timeout: float = 5.0) -> dict:
        """-> the verified REPLY dict (or the legacy f+1-agreed reply
        after escalation). Raises TimeoutError when every rung fails."""
        self.stats.reads += 1
        for attempt in (0, 1):
            msg = await self._walk_ladder(request, per_node_timeout)
            if msg is not None:
                return msg
            # ladder exhausted (or cut short by a stale_map verdict):
            # refresh the map view and retry ONCE iff the epoch moved —
            # the owning shard may have changed under a live reshard
            if attempt or self.map_refresh is None or \
                    not self.map_refresh():
                break
            self.stats.map_retries += 1
        shard_nodes = self._shard_ladder(request)
        # escalation: the legacy f+1 matching-reply broadcast — reached
        # when the pool cannot anchor proofs yet or every proof-bearing
        # rung lied/timed out; either way the quorum path stays sound
        # (f+1 CONTENT-matching replies). A sharded read broadcasts to
        # the OWNING shard only — its quorum lives there
        self.stats.fallbacks += 1
        if shard_nodes is not None and not shard_nodes:
            # the owning shard is known but none of its nodes are
            # dialable: broadcasting to FOREIGN nodes could only "agree"
            # on absence against the wrong root — fail closed instead
            raise TimeoutError("no reachable node of the owning shard")
        targets = list(shard_nodes) if shard_nodes else list(self.node_addrs)
        msg = await self.submit(request, timeout, to=targets)
        self.stats.msgs_sent += len(targets)
        self.stats.replies_seen += len(targets)
        return msg

    def _shard_ladder(self, request: Request) -> Optional[list]:
        shard_nodes = self.shard_resolver(request) \
            if self.shard_resolver is not None else None
        if shard_nodes is None:
            return None
        return [n for n in shard_nodes if n in self.node_addrs]

    async def _walk_ladder(self, request: Request,
                           per_node_timeout: float) -> Optional[dict]:
        """One pass down the failover ladder; -> the verified reply, or
        None when every rung failed (caller refreshes/escalates)."""
        data = pack(request.to_dict())
        req_key = (request.identifier, request.req_id)
        shard_nodes = self._shard_ladder(request)
        if shard_nodes is not None:
            # owning-shard ladder: fail over WITHIN the shard first; the
            # edge/observer tiers are skipped (both anchor one flat pool)
            ladder = ladder_order(shard_nodes, request)
        else:
            ladder = (ladder_order(list(self.edge_addrs), request)
                      + ladder_order(list(self.observer_addrs), request)
                      + ladder_order(list(self.node_addrs), request))
        for rung, name in enumerate(ladder):
            if rung:
                self.stats.failovers += 1
            await self._send_one(name, data)
            self.stats.msgs_sent += 1
            msg = await self._read_until_reply(name, req_key,
                                               per_node_timeout)
            if msg is None:
                self.stats.timeouts += 1
                continue
            self.stats.replies_seen += 1
            if msg.get("op") != "REPLY":
                continue                 # a lone NACK is unverifiable
            ok, reason = self.checker.check(request, msg.get("result", {}))
            if ok:
                self.stats.single_reply_ok += 1
                if name in self.edge_addrs:
                    self.stats.edge_ok += 1
                elif name in self.observer_addrs:
                    self.stats.observer_ok += 1
                return msg
            if name in self.edge_addrs and reason != proofs.NO_PROOF:
                # a rejected edge reply (forgery/over-stale cache): the
                # deny-but-never-forge ledger; the ladder falls over
                self.stats.edge_verify_failures += 1
            if reason == "stale_map" and self.map_refresh is not None:
                # the answering node served a superseded map: cut
                # straight to the refresh-and-retry path. WITHOUT a
                # refresh hook, keep walking — another rung of the same
                # shard may already serve the current epoch, and a
                # verified single reply beats the broadcast fallback
                return None
            if reason == proofs.NO_PROOF:
                if name in self.edge_addrs:
                    # a proofless edge reply (pass-through miss): the
                    # next rung can still prove — never break the ladder
                    self.stats.edge_escalations += 1
                    continue
                if name in self.observer_addrs:
                    # anchor-lagged observer escalates to the next rung
                    # (a validator CAN prove); never straight to broadcast
                    self.stats.observer_escalations += 1
                    continue
                break                    # pool can't prove: broadcast
        return None


class SimReadDriver:
    """The same ladder over an in-process pool.

    submit(node_name, request): deliver the query to that node only.
    collect(node_name): -> list of reply DICTS that node sent this driver
        since the last collect (drained).
    pump(seconds): run the pool loop.
    """

    def __init__(self, submit: Callable[[str, Request], None],
                 collect: Callable[[str], list],
                 pump: Callable[[float], None],
                 node_names: Sequence[str],
                 bls_keys: Mapping[str, str],
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 now: Optional[Callable[[], float]] = None,
                 observer_names: Optional[Sequence[str]] = None,
                 checker=None,
                 shard_resolver: Optional[Callable[[Request],
                                                   Optional[Sequence[str]]]]
                 = None,
                 map_refresh: Optional[Callable[[], bool]] = None,
                 edge_names: Optional[Sequence[str]] = None,
                 on_edge_verify_failure: Optional[Callable[[str], None]]
                 = None):
        self._submit = submit
        self._collect = collect
        self._pump = pump
        self.node_names = list(node_names)
        # observer tier, tried BEFORE validators (same escalation rules
        # as VerifyingReadClient: observer proofless -> next rung)
        self.observer_names = list(observer_names or [])
        # edge tier (reads/edge.py), tried BEFORE observers: a keyless
        # cache rung whose failures are always just failover. The
        # optional on_edge_verify_failure(name) hook reports a rejected
        # edge reply back to the serving fleet (only the client can
        # judge the cache's bytes — EdgeFleet.note_verify_failure)
        self.edge_names = list(edge_names or [])
        self.on_edge_verify_failure = on_edge_verify_failure
        # injectable verification core + owning-shard ladder, exactly as
        # on VerifyingReadClient (the TCP twin documents the contract)
        self.checker = checker if checker is not None else ReadCheck(
            bls_keys, freshness_s=freshness_s, now=now,
            n_nodes=len(node_names))
        self.shard_resolver = shard_resolver
        # stale_map / exhausted ladder -> refresh the map view and retry
        # once against the new epoch (VerifyingReadClient documents the
        # contract): a healthy reshard must not error client reads
        self.map_refresh = map_refresh
        self.stats = self.checker.stats

    def read(self, request: Request, per_node_s: float = 1.0,
             step_s: float = 0.05, order: Optional[Sequence[str]] = None
             ) -> Optional[dict]:
        """-> the verified result dict, or None when every rung failed
        (caller escalates to its own broadcast path)."""
        self.stats.reads += 1
        for attempt in (0, 1):
            result = self._walk_ladder(request, per_node_s, step_s,
                                       order if attempt == 0 else None)
            if result is not None:
                return result
            # an explicit caller-built order is the caller's routing
            # decision — never second-guessed by a refresh
            if attempt or order is not None or self.map_refresh is None \
                    or not self.map_refresh():
                break
            self.stats.map_retries += 1
        self.stats.fallbacks += 1
        return None

    def _walk_ladder(self, request: Request, per_node_s: float,
                     step_s: float, order: Optional[Sequence[str]]
                     ) -> Optional[dict]:
        if order is None:
            shard_nodes = self.shard_resolver(request) \
                if self.shard_resolver is not None else None
            if shard_nodes is not None:
                # fail over within the owning shard before anything
                # else; an owning shard with NO reachable node leaves
                # the ladder empty -> the read fails closed (None),
                # never consults a foreign shard
                order = ladder_order(
                    [n for n in shard_nodes if n in self.node_names],
                    request)
            else:
                order = (ladder_order(self.edge_names, request)
                         + ladder_order(self.observer_names, request)
                         + ladder_order(self.node_names, request))
        observers = set(self.observer_names)
        edges = set(self.edge_names)
        for rung, name in enumerate(order):
            if rung:
                self.stats.failovers += 1
            self._submit(name, request)
            self.stats.msgs_sent += 1
            result = self._await_reply(name, request, per_node_s, step_s)
            if result is None:
                self.stats.timeouts += 1
                continue
            self.stats.replies_seen += 1
            ok, reason = self.checker.check(request, result)
            if ok:
                self.stats.single_reply_ok += 1
                if name in edges:
                    self.stats.edge_ok += 1
                elif name in observers:
                    self.stats.observer_ok += 1
                return result
            if name in edges and reason != proofs.NO_PROOF:
                # rejected edge bytes: deny-but-never-forge in action —
                # count it, tell the fleet, keep walking the ladder
                self.stats.edge_verify_failures += 1
                if self.on_edge_verify_failure is not None:
                    self.on_edge_verify_failure(name)
            if reason == "stale_map" and self.map_refresh is not None:
                # the answering node served a superseded map: cut to
                # the refresh-and-retry path. Without a refresh hook,
                # keep walking — another rung may serve the current
                # epoch (VerifyingReadClient documents the contract)
                return None
            if reason == proofs.NO_PROOF:
                if name in edges:
                    self.stats.edge_escalations += 1
                    continue             # deeper rungs can still prove
                if name in observers:
                    self.stats.observer_escalations += 1
                    continue             # a validator can still prove
                break
        return None

    def _await_reply(self, name: str, request: Request, per_node_s: float,
                     step_s: float) -> Optional[dict]:
        waited = 0.0
        while True:
            for result in self._collect(name):
                if not isinstance(result, dict):
                    continue
                if (result.get("identifier"), result.get("reqId")) == \
                        (request.identifier, request.req_id):
                    return result
            if waited >= per_node_s:
                return None
            self._pump(step_s)
            waited += step_s
