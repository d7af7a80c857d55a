"""Observer-served verified reads: horizontal read fan-out.

PR 4's read plane made one VALIDATOR's answer trustworthy: the proof is
anchored to a BLS multi-signed root, so trust rides the signature, not
the server. That property is exactly what lets reads leave the pool
entirely — ANY replica holding the multi-signed root can serve millions
of verified reads without touching a consensus quorum (ROADMAP item 3).

``ObserverReadGate`` is the read-serving core an observer wires over its
replicated components:

  * **Anchor adoption is verification-gated.** Validators attach their
    newest ``MultiSignature`` to every ``BatchCommitted`` push
    (Node._reply_batch); the gate verifies it against the pool BLS keys
    (distinct participants, n-f quorum, pairing —
    ``MultiSignature.verify``) BEFORE handing it to the ReadPlane. A
    Byzantine pusher can therefore stall an observer's anchor but never
    move it to an unsigned root. Verification is memoized per signature,
    so steady traffic pays one pairing per anchor advance.
  * **Anchor lag escalates, never serves stale.** When the newest
    verified anchor is older than ``OBSERVER_ANCHOR_LAG_MAX`` (an
    observer cut off from pushes keeps its last root forever), replies
    ship PROOFLESS — the verifying client fails over to a validator —
    instead of shipping a proof the client's freshness bound would
    reject anyway (and that a lenient client might wrongly trust).

``SimObserver`` composes the gate with ``NodeObserver`` (f+1
content-quorum push application) into a full in-process observer node
for SimNetwork pools — the unit the 10k-client bench config and the
observer read tests drive. The TCP twin lives in
``node/observer_node.py`` (ObserverNode with a client listener).
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.node_messages import (BatchCommitted,
                                             DOMAIN_LEDGER_ID, Reply,
                                             RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.multi_signature import MultiSignature
from plenum_tpu_torch.reads import READ_PROOF, ReadPlane


# default sentinel: resolve the lag bound from Config at construction
# (None is a MEANINGFUL value — "never suppress" — so it can't be the
# marker for "not given")
FROM_CONFIG = object()


def _resolve_lag(anchor_lag_max) -> Optional[float]:
    if anchor_lag_max is FROM_CONFIG:
        from plenum_tpu_torch.config import Config
        return Config().OBSERVER_ANCHOR_LAG_MAX
    return anchor_lag_max


class ObserverReadGate:
    """Read plane + verified anchor intake for one observer replica."""

    def __init__(self, components, bls_keys: Mapping[str, str],
                 n_nodes: int, now: Callable[[], float],
                 anchor_lag_max=FROM_CONFIG,
                 metrics: Optional[MetricsCollector] = None,
                 tracer=None):
        anchor_lag_max = _resolve_lag(anchor_lag_max)
        self.c = components
        self.bls_keys = dict(bls_keys)
        self.n_nodes = n_nodes
        self.now = now
        self.anchor_lag_max = anchor_lag_max
        self.metrics = metrics or MetricsCollector()
        domain = components.db.get_ledger(DOMAIN_LEDGER_ID)
        self.read_plane = ReadPlane(
            components.db, components.read_manager, metrics=self.metrics,
            hasher=domain.hasher if domain is not None else None,
            tracer=tracer)
        # (signature, participants, value) -> verdict: one pairing per
        # distinct multi-sig, not one per push (n validators push the
        # same anchor epoch)
        self._ms_memo: dict = {}
        self.stats = {"pushes": 0, "ms_adopted": 0, "ms_rejected": 0,
                      "stale_suppressed": 0}

    # --- anchor intake (push path) ---------------------------------------

    def on_push(self, batch: BatchCommitted, applied: bool) -> None:
        """Every push lands here; `applied` = NodeObserver committed it.
        Applied batches record their txn root's tree size and invalidate
        the ledger's read cache; any push's multi-sig (applied or not —
        the f redundant quorum copies still carry fresh anchors) is
        adopted once it VERIFIES against the pool keys."""
        self.stats["pushes"] += 1
        self.metrics.add_event(MetricsName.OBSERVER_PUSHES)
        if applied:
            self.read_plane.on_batch_committed(
                batch.ledger_id, batch.state_root, batch.txn_root)
        if batch.multi_sig:
            ms = self._verified_ms(batch.multi_sig)
            if ms is not None:
                self.read_plane.on_multi_sig(ms)

    def _verified_ms(self, raw) -> Optional[MultiSignature]:
        try:
            ms = MultiSignature.from_list(list(raw))
        except Exception:
            self.stats["ms_rejected"] += 1
            self.metrics.add_event(MetricsName.OBSERVER_MS_REJECTED)
            return None
        key = (ms.signature, ms.participants, ms.value)
        verdict = self._ms_memo.get(key)
        if verdict is None:
            verdict = ms.verify(self.bls_keys, n=self.n_nodes)
            if len(self._ms_memo) >= 1024:
                self._ms_memo.clear()
            self._ms_memo[key] = verdict
            if verdict:
                self.stats["ms_adopted"] += 1
                self.metrics.add_event(MetricsName.OBSERVER_MS_ADOPTED)
            else:
                self.stats["ms_rejected"] += 1
                self.metrics.add_event(MetricsName.OBSERVER_MS_REJECTED)
        return ms if verdict else None

    # --- read serving -----------------------------------------------------

    def serve(self, msg: dict):
        """One raw client message dict -> the reply message (Reply or
        RequestNack). THE one serving path both observer fronts share —
        the TCP listener (ObserverNode._serve_client) and the in-process
        twin (SimObserver) must never diverge on nack reasons or
        escalation semantics."""
        try:
            request = Request.from_dict(msg)
        except Exception:
            return RequestNack(identifier=str(msg.get("identifier")),
                               req_id=msg.get("reqId") or 0,
                               reason="malformed request")
        if not self.c.read_manager.is_query_type(request.txn_type):
            # an observer holds no pool connection to forward writes;
            # a client that wants consensus dials the pool
            return RequestNack(identifier=request.identifier,
                               req_id=request.req_id,
                               reason="observers serve reads only")
        out = self.answer_batch([request])[0]
        if isinstance(out, Exception):
            return RequestNack(identifier=request.identifier,
                               req_id=request.req_id,
                               reason=getattr(out, "reason",
                                              "malformed query"))
        return Reply(result=out)

    def answer_batch(self, requests: Sequence[Request]) -> list:
        """ReadPlane.answer_batch + the anchor-lag escalation: envelopes
        anchored beyond the lag bound are STRIPPED so the client fails
        over to a validator instead of receiving a stale proof."""
        outcomes = self.read_plane.answer_batch(requests)
        if self.anchor_lag_max is None:
            return outcomes
        now = self.now()
        for out in outcomes:
            if not isinstance(out, dict):
                continue
            env = out.get(READ_PROOF)
            if not isinstance(env, dict):
                continue
            try:
                # the one layout authority — never index the wire shape
                ts = MultiSignature.from_list(
                    list(env["multi_signature"])).value.timestamp
            except Exception:
                ts = None
            if ts is None or now - ts > self.anchor_lag_max:
                out.pop(READ_PROOF, None)
                self.stats["stale_suppressed"] += 1
                self.metrics.add_event(
                    MetricsName.OBSERVER_STALE_SUPPRESSED)
        return outcomes


class SimObserver:
    """In-process observer node for SimNetwork pools.

    Register with every validator over the client plane
    (OBSERVER_REGISTER), feed the resulting BatchCommitted pushes through
    ``deliver_push`` (f+1 content-identical quorum via NodeObserver — the
    multi-sig field is excluded from the quorum content), and serve
    verified reads through the node-shaped ``handle_client_message``.
    Build BEFORE traffic flows: pushes only cover live batches, and the
    in-process twin has no GET_TXN gap-fill transport of its own.
    crypto_backend: the components' backend, the card unless asked for
    "cpu" or "torch".
    """

    def __init__(self, name: str, genesis: dict, validator_names,
                 bls_keys: Mapping[str, str],
                 now: Callable[[], float], f: int = 1,
                 anchor_lag_max=FROM_CONFIG,
                 send: Optional[Callable] = None,
                 metrics: Optional[MetricsCollector] = None,
                 tracer=None, state_commitment: str = "mpt",
                 state_commitment_per_ledger: Optional[dict] = None,
                 verkle_width: Optional[int] = None,
                 crypto_backend: str = "cuda"):
        from plenum_tpu_torch.node.bootstrap import NodeBootstrap
        from plenum_tpu_torch.node.observer import NodeObserver
        self.name = name
        self.client_id = f"obs:{name}"
        self.validator_names = list(validator_names)
        # the observer's replicated state MUST use the validators' scheme
        # — its roots have to land on the multi-signed anchors, or every
        # read it serves degrades to proofless escalation
        components = NodeBootstrap(
            name, genesis_txns=genesis, crypto_backend=crypto_backend,
            state_commitment=state_commitment,
            state_commitment_per_ledger=state_commitment_per_ledger,
            verkle_width=verkle_width).build()
        self.c = components
        self.observer = NodeObserver(components, f=f)
        self.gate = ObserverReadGate(
            components, bls_keys, n_nodes=len(self.validator_names),
            now=now, anchor_lag_max=anchor_lag_max, metrics=metrics,
            tracer=tracer)
        self.sent: list = []            # (msg, client) when no send given
        self._send = send or (lambda msg, client: self.sent.append(
            (msg, client)))
        self.batches_applied = 0

    # --- replication ------------------------------------------------------

    def register(self, submit: Callable[[str, dict], None]) -> None:
        """submit(validator_name, msg_dict): subscribe this observer's
        client id to BatchCommitted pushes on every validator."""
        for v in self.validator_names:
            submit(v, {"op": "OBSERVER_REGISTER"})

    def deliver_push(self, batch, frm: str) -> bool:
        """One validator's push (BatchCommitted or its dict); -> applied."""
        if isinstance(batch, dict):
            try:
                batch = BatchCommitted.from_dict(batch)
            except Exception:
                return False
        if not isinstance(batch, BatchCommitted):
            return False
        applied = self.observer.process_batch(batch, frm=frm)
        if applied:
            self.batches_applied += 1
        self.gate.on_push(batch, applied)
        return applied

    # --- read serving (node-shaped client API) ----------------------------

    def handle_client_message(self, msg: dict, frm: str) -> None:
        self._send(self.gate.serve(msg), frm)


class ObserverFleet:
    """Region-scoped observer read fan-out with a SPAWN/RETIRE seam.

    Observers were statically placed (build once, before traffic); the
    fleet makes placement an actuator: ``spawn(region)`` boots a fresh
    ``SimObserver`` over one shard's validator set mid-run and registers
    it for pushes, ``retire(region)`` deregisters the newest one. The
    autopilot (control/autopilot.py) drives both from read-latency burn.

    The capacity model is deliberately explicit: each observer serves
    ``capacity`` reads per telemetry interval; reads beyond the region's
    pooled capacity count as read-SLO violations. ``service()`` (called
    from the fabric's prod loop) drains the validators' push outboxes
    into the member observers and rolls each region's (violations, total)
    ledger into the aggregator's ``("reads", region)`` burn tracker — so
    regional read burn rides the SAME multi-window burn-rate rule as the
    ingress/batch SLOs and is visible to ``sustained()``.
    """

    def __init__(self, fabric, regions=("r0",), sid: int = 0,
                 per_region: int = 1, capacity: float = 64.0, f: int = 1):
        self.fabric = fabric
        self.sid = sid
        self.capacity = float(capacity)
        self.f = f
        self.regions: dict[str, list[SimObserver]] = \
            {r: [] for r in regions}
        self._interval = getattr(fabric.config, "TELEMETRY_INTERVAL", 1.0)
        self._window_start = fabric.timer.get_current_time()
        self._served = {r: 0 for r in regions}
        self._viol = {r: 0 for r in regions}
        self._last_served = {r: 0 for r in regions}
        self._rr = {r: 0 for r in regions}
        self._retired_ids: set = set()
        self._n = 0
        self.stats = {"spawned": 0, "retired": 0, "reads": 0,
                      "violations": 0}
        for r in regions:
            for _ in range(per_region):
                self.spawn(r)

    def _shard(self):
        return self.fabric.shards[self.sid]

    # --- the spawn/retire seam --------------------------------------------

    def spawn(self, region: str) -> str:
        """Boot one more observer for `region` over the anchored shard's
        validators; it replicates from the NEXT committed batch on (the
        capacity model, not the replicated prefix, is what the read-burn
        policy scales)."""
        from plenum_tpu_torch.tools.local_pool import pool_bls_keys
        shard = self._shard()
        self._n += 1
        name = f"{region}-obs{self._n}"
        obs = SimObserver(
            name, shard.genesis, shard.names, pool_bls_keys(shard.names),
            now=self.fabric.timer.get_current_time, f=self.f,
            anchor_lag_max=None,
            crypto_backend=self.fabric.config.crypto_backend)
        obs.register(lambda v, msg: shard.nodes[v]
                     .handle_client_message(msg, obs.client_id))
        self.regions[region].append(obs)
        self.stats["spawned"] += 1
        return name

    def retire(self, region: str) -> Optional[str]:
        """Deregister the newest observer of `region` (LIFO — the
        longest-lived replica keeps serving); never below one."""
        group = self.regions[region]
        if len(group) <= 1:
            return None
        obs = group.pop()
        self._retired_ids.add(obs.client_id)
        for node in self._shard().nodes.values():
            observable = getattr(node, "observable", None)
            if observable is not None:
                observable.remove_observer(obs.client_id)
        self.stats["retired"] += 1
        return obs.name

    def count(self, region: str) -> int:
        return len(self.regions[region])

    # --- the pump ----------------------------------------------------------

    def service(self) -> None:
        """Drain validator push outboxes into member observers, drop
        retired observers' in-flight pushes, roll the read-SLO window."""
        shard = self._shard()
        by_id = {obs.client_id: obs
                 for group in self.regions.values() for obs in group}
        for v in shard.names:
            msgs = shard.client_msgs[v]
            keep = []
            for m, cid in msgs:
                obs = by_id.get(cid)
                if obs is not None:
                    if isinstance(m, BatchCommitted):
                        obs.deliver_push(m, v)
                    # non-push traffic to an observer (OBSERVER_ACK)
                    # just drains
                elif cid not in self._retired_ids:
                    keep.append((m, cid))
            shard.client_msgs[v] = keep
        self._roll_window()

    def _roll_window(self) -> None:
        now = self.fabric.timer.get_current_time()
        if now - self._window_start < self._interval:
            return
        self._window_start = now
        agg = self.fabric.aggregator
        for region in self.regions:
            n = self._served[region]
            self._last_served[region] = n
            if n:
                agg.tracker("reads", region).note(
                    now, self._viol[region], n)
            self._served[region] = 0
            self._viol[region] = 0

    # --- read serving -------------------------------------------------------

    def serve_read(self, region: str, msg: dict):
        """One client read through the region's pool: round-robin over
        members, over-capacity reads ledger an SLO violation."""
        group = self.regions[region]
        i = self._rr[region] % len(group)
        self._rr[region] = i + 1
        self._served[region] += 1
        self.stats["reads"] += 1
        if self._served[region] > self.capacity * len(group):
            self._viol[region] += 1
            self.stats["violations"] += 1
        return group[i].gate.serve(msg)

    def scale_in_safe(self, region: str, margin: float = 0.5) -> bool:
        """True when the last completed window's demand fits in the
        region MINUS one observer with 1/margin headroom — the guard
        that keeps a retire from immediately re-triggering read burn."""
        group = self.regions[region]
        if len(group) <= 1:
            return False
        return self._last_served.get(region, 0) <= \
            margin * self.capacity * (len(group) - 1)

    def summary(self) -> dict:
        return {"regions": {r: len(g) for r, g in
                            sorted(self.regions.items())},
                **self.stats}
