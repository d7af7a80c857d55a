"""N sharded sub-pools in one process, on one shared seeded timer.

Each shard is a full RBFT ordering instance — its own node set, its own
SimNetwork fabric (so partitions/WAN faults can be confined to one
shard), its own genesis and domain ledger/state trie — all driven by the
ONE timer, so fuzz scenarios compose per-shard and across shards and a
whole multi-shard run replays from its seed. The fabric owns:

- the **mapping ledger** (mapping.py) and the directory committee that
  signs it;
- the **ShardRouter** behind the ingress seam (router.py): writes pay
  admission + ONE batched auth at an entry front door, then fan to the
  owning shard's `submit_preverified`; raw bench submission routes to
  the owning shard's client inboxes instead (every shard node pays its
  own auth — the load shape the single-pool baseline pays too);
- per-shard **read gates**: a read reply leaving a shard is decorated
  with the mapping-ownership proof (`shard_proof`) exactly as the
  shard's nodes would attach it — the seam the cross-shard fuzz rungs
  wrap to serve forged/stale maps;
- an optional SHARED CryptoPipeline (parallel/pipeline.py): co-hosted
  shards feed one submission ring, so auth/commit/Merkle batching
  amortizes across shard boundaries exactly as it does across co-hosted
  nodes of one pool.

Timer model: pass a MockTimer for deterministic sim-time runs
(`run(seconds)` advances it) or a QueueTimer over perf_counter for
real-time benches (`run` then spins the wall clock).
"""
from __future__ import annotations

from typing import Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, Reply
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import MockTimer
from plenum_tpu_torch.common.tracing import Tracer

from . import mapping as mapping_lib
from .mapping import MappingLedger, ShardDescriptor, equal_ranges
from .read_client import CrossShardReadCheck, ShardMapView
from .router import ShardRouter

DIRECTORY_NAMES = ("Dir1", "Dir2", "Dir3", "Dir4")


def shard_node_names(shard_id: int, n_nodes: int) -> list[str]:
    return [f"S{shard_id}N{i + 1}" for i in range(n_nodes)]


class SimShard:
    """One sub-pool: nodes over an own SimNetwork on the shared timer."""

    def __init__(self, shard_id: int, names: Sequence[str], timer, seed: int,
                 config, pipeline=None, tracing: bool = False,
                 verifier=None, pipeline_lane=None):
        from plenum_tpu_torch.network import SimNetwork, SimRandom
        from plenum_tpu_torch.node import Node, NodeBootstrap
        from plenum_tpu_torch.tools.local_pool import build_genesis

        self.shard_id = shard_id
        self.names = list(names)
        self.timer = timer
        self.net = SimNetwork(timer, SimRandom(seed))
        self.genesis, self.trustee = build_genesis(self.names)
        self.client_msgs: dict[str, list] = {n: [] for n in self.names}
        self.nodes: dict = {}
        for name in self.names:
            bus = self.net.create_peer(name)
            components = NodeBootstrap(
                name, genesis_txns=self.genesis,
                crypto_backend=config.crypto_backend,
                verifier=verifier,
                pipeline=pipeline,
                pipeline_lane=pipeline_lane,
                state_commitment=config.STATE_COMMITMENT,
                state_commitment_per_ledger=(
                    config.STATE_COMMITMENT_PER_LEDGER),
                verkle_width=config.VERKLE_WIDTH).build()
            tracer = Tracer(name, timer.get_current_time,
                            clock_domain="shared",
                            tags={"shard": shard_id}) if tracing else None
            self.nodes[name] = Node(
                name, timer, bus, components,
                client_send=lambda msg, client, n=name:
                    self.client_msgs[n].append((msg, client)),
                config=config, tracer=tracer)
        self.net.connect_all()

    def prod(self) -> None:
        for node in self.nodes.values():
            node.prod()

    def submit(self, request: Request, client: str = "cli",
               to: Optional[Sequence[str]] = None) -> None:
        for name in (to or self.names):
            self.nodes[name].handle_client_message(request.to_dict(), client)

    def replies(self, name: str, msg_type=Reply) -> list:
        return [m for m, _ in self.client_msgs[name]
                if isinstance(m, msg_type)]

    def domain_sizes(self) -> set[int]:
        return {node.c.db.get_ledger(DOMAIN_LEDGER_ID).size
                for node in self.nodes.values()}

    def ordered_count(self) -> int:
        """Txns ordered beyond genesis, by the shard's first node."""
        node = self.nodes[self.names[0]]
        return node.c.db.get_ledger(DOMAIN_LEDGER_ID).size - 1


class ShardReadGate:
    """Server-side decoration seam: attach the shard's mapping-ownership
    proof to every read reply leaving this shard — the in-process twin
    of a shard node consulting its local mapping-ledger copy. Fuzz rungs
    subclass/wrap `decorate` to serve forged or stale maps."""

    def __init__(self, mapping: MappingLedger):
        self.mapping = mapping

    def decorate(self, result: dict, key: bytes) -> dict:
        try:
            result[mapping_lib.SHARD_PROOF] = \
                self.mapping.ownership_proof(key)
        except Exception:
            pass            # unroutable key: ship undominated, client
            #                 fails closed on the missing proof
        return result


class ShardedSimFabric:
    def __init__(self, n_shards: int = 2, nodes_per_shard: int = 4,
                 seed: int = 1, config=None, timer=None,
                 share_pipeline: bool = False, tracing: bool = False,
                 latency: Optional[tuple[float, float]] = None,
                 shard_verifiers: Optional[dict] = None,
                 pipeline=None):
        from plenum_tpu_torch.config import Config

        self.timer = timer if timer is not None else MockTimer()
        self.config = config or Config(Max3PCBatchWait=0.05)
        self.metrics = MetricsCollector()
        # live-reshard bookkeeping: the boot parameters a split-off
        # shard is built with, and where merged-away sub-pools go
        self.seed = seed
        self.nodes_per_shard = nodes_per_shard
        self.latency = latency
        self.tracing = tracing
        self.retired: dict[int, SimShard] = {}
        self.pipeline = pipeline
        if share_pipeline and self.pipeline is None:
            # ONE submission ring for every co-hosted shard: client-auth
            # Ed25519, BLS batch checks, and Merkle hashing coalesce and
            # dedup ACROSS shard boundaries (PR 8's pipeline, wider)
            from plenum_tpu_torch.crypto.ed25519 import CpuEd25519Verifier
            from plenum_tpu_torch.parallel.pipeline import CryptoPipeline
            self.pipeline = CryptoPipeline(ed_inner=CpuEd25519Verifier(),
                                           config=self.config)
        self.shards: dict[int, SimShard] = {}
        # shard id -> current pipeline lane pin (the autopilot's lane
        # re-placement reads and rewrites these through repin_shard_lane)
        self.lane_pins: dict[int, Optional[int]] = {}
        # kept for live splits: a pre-registered verifier for a future
        # shard id (add_shard looks the new sid up here, so a split
        # target can join the same faultable crypto plane)
        self.shard_verifiers = dict(shard_verifiers or {})
        for sid in range(n_shards):
            # shard_verifiers: {sid: shared crypto plane} — the seam the
            # shard-confined device_flap fuzz faults ONE shard through
            self.lane_pins[sid] = self._shard_lane(sid)
            shard = SimShard(sid, shard_node_names(sid, nodes_per_shard),
                             self.timer, seed * 1009 + sid * 7919 + 3,
                             self.config, pipeline=self.pipeline,
                             tracing=tracing,
                             verifier=self.shard_verifiers.get(sid),
                             pipeline_lane=self.lane_pins[sid])
            if latency is not None:
                shard.net.set_latency(*latency)
            self.shards[sid] = shard
        self.trustee = self.shards[0].trustee    # one trustee, all shards
        self.node_shard = {n: sid for sid, s in self.shards.items()
                           for n in s.names}

        # the provable map: equal static key ranges, directory-signed
        from plenum_tpu_torch.tools.local_pool import pool_bls_keys
        self.directory = mapping_lib.directory_bls_signers(DIRECTORY_NAMES)
        descriptors = []
        for sid, (lo, hi) in enumerate(equal_ranges(n_shards)):
            names = self.shards[sid].names
            descriptors.append(ShardDescriptor(
                sid, lo, hi, names, pool_bls_keys(names), epoch=0))
        self.mapping = MappingLedger(descriptors, self.directory,
                                     now=self.timer.get_current_time)
        self.gates: dict[int, ShardReadGate] = {
            sid: ShardReadGate(self.mapping) for sid in self.shards}

        self.fabric_tracer = Tracer(
            "fabric", self.timer.get_current_time,
            clock_domain="shared") if tracing else None
        # live fleet telemetry: ONE aggregator composes every shard
        # node's snapshot stream into the pool-wide view — per-shard
        # health, the load-imbalance index (the input live split/merge
        # will consume), burn rates. Shard tags ride each node's emitter
        # so the aggregator can group by shard; alerts land in the
        # fabric tracer's ring when tracing is on.
        from plenum_tpu_torch.observability import FleetAggregator
        self.aggregator = FleetAggregator(
            config=self.config, tracer=self.fabric_tracer,
            metrics=self.metrics)
        for sid, shard in self.shards.items():
            self._wire_shard_telemetry(sid, shard)
        # raw router (bench/sim writes -> owning shard's client inboxes;
        # every shard node pays its own auth, like the flat baseline) and
        # the behind-ingress router (one front-door auth -> fan to the
        # owning shard's submit_preverified seam)
        floor = getattr(self.config, "HEALTH_ALERT_FLOOR", 0.5)
        self.router = ShardRouter(
            self.mapping,
            {sid: self._raw_sink(sid) for sid in self.shards},
            metrics=self.metrics, tracer=self.fabric_tracer,
            health_provider=self.aggregator.shard_health,
            degraded_floor=floor)
        self.ingress_router = ShardRouter(
            self.mapping,
            {sid: self._preverified_sink(sid) for sid in self.shards},
            metrics=self.metrics, tracer=self.fabric_tracer,
            health_provider=self.aggregator.shard_health,
            degraded_floor=floor)
        # reply key -> routing key, so read gates know what to prove
        # (re-registered per ladder rung, popped as each reply drains)
        self._pending_keys: dict[tuple, bytes] = {}
        self._ordered_emitted: dict[int, int] = {}
        # live split/merge (reshard.py): migrations run as mapping-ledger
        # transactions driven from the prod loop; every shard intake is
        # guarded so a stale routing decision racing the ratchet is
        # forwarded (inside the handoff window) or NACKed fail-closed
        from .reshard import ReshardManager
        self.reshard = ReshardManager(self)
        self.stale_nacks: list = []
        self._xsw = None
        # every front door built through ingress_plane(), so the
        # autopilot's degradation ladder can clamp them all; the
        # optional region-scoped observer fleet (attach_observer_fleet)
        self.ingress_planes: list = []
        self.observers = None
        # the optional Proof-CDN edge tier (attach_edge_fleet): keyless
        # caches one rung OUTSIDE the observers, serviced from the same
        # prod loop
        self.edges = None
        # the autopilot control plane (control/autopilot.py): None
        # unless AUTOPILOT=True — the disabled cost is one `is None`
        # check per prod, pinned by the identity test
        from plenum_tpu_torch.control import make_autopilot
        self.autopilot = make_autopilot(self)

    @property
    def nodes(self) -> dict:
        """Flat {name: node} over every shard — the shape the fuzz
        harness's flight-artifact dumper walks."""
        return {n: s.nodes[n] for s in self.shards.values()
                for n in s.nodes}

    # --- sinks ------------------------------------------------------------

    def _shard_of(self, sid: int) -> "SimShard":
        shard = self.shards.get(sid)
        return shard if shard is not None else self.retired[sid]

    def _guarded(self, sid: int, request: Request, frm: str) -> bool:
        """The reshard intake guard: True = the caller should deliver to
        `sid`; False = the guard already forwarded the write to its new
        owner or NACKed it fail-closed (shards/reshard.py)."""
        reshard = getattr(self, "reshard", None)
        if reshard is None:
            return True
        verdict = reshard.guard(sid, request, frm)
        if verdict == "stale":
            self._nack_stale(request, frm)
        return verdict is None

    def _nack_stale(self, request: Request, frm: str) -> None:
        """A stale-epoch write past the handoff window: an explicit
        retryable refusal (the sim twin of the front door's NACK) —
        recorded on the fabric, never a silent drop."""
        from plenum_tpu_torch.common.node_messages import RequestNack
        from .reshard import STALE_WRITE_NACK
        self.stale_nacks.append(
            RequestNack(identifier=request.identifier,
                        req_id=request.req_id,
                        reason=STALE_WRITE_NACK))

    def deliver_to_shard(self, sid: int, request: Request,
                         frm: str) -> None:
        """Raw delivery used by the handoff forwarder — bypasses the
        guard (the target IS the new owner)."""
        self._shard_of(sid).submit(request, client=frm)

    def _raw_sink(self, sid: int):
        def sink(request: Request, frm: str) -> None:
            if self._guarded(sid, request, frm):
                self._shard_of(sid).submit(request, client=frm)
        return sink

    def _preverified_sink(self, sid: int):
        def sink(request: Request, frm: str) -> None:
            if not self._guarded(sid, request, frm):
                return
            shard = self._shard_of(sid)
            for name in shard.names:
                shard.nodes[name].submit_preverified(request, frm)
        return sink

    # --- elastic membership (reshard.py drives these) -----------------------

    def _shard_lane(self, sid: int):
        """Placement policy: co-hosted sub-pool shards pin to DISTINCT
        chips of a multi-device pipeline (shard count then scales crypto
        throughput instead of queueing every shard's waves on one
        device). Single-device/absent pipelines place nothing."""
        if self.pipeline is None:
            return None
        return self.pipeline.place(sid)

    def repin_shard_lane(self, sid: int, lane) -> Optional[int]:
        """Move shard `sid`'s pipeline pin to `lane` on every member
        node's verifier — the autopilot's lane re-placement actuator.
        In-flight waves finish where they were staged; only future
        submissions land on the new chip. Returns the previous pin."""
        prev = self.lane_pins.get(sid)
        self.lane_pins[sid] = lane
        shard = self.shards.get(sid)
        if shard is None:
            return prev
        for node in shard.nodes.values():
            verifier = getattr(node.c.authenticator.core_authenticator,
                               "verifier", None)
            repin = getattr(verifier, "repin", None)
            if callable(repin):
                repin(lane)
        return prev

    def attach_observer_fleet(self, regions=("r0",), **kw):
        """Build the region-scoped observer fleet (spawn/retire seam,
        ingress/observer_reads.py) and service it from the prod loop;
        the autopilot's read-burn policy scales it per region."""
        from plenum_tpu_torch.ingress import ObserverFleet
        self.observers = ObserverFleet(self, regions=regions, **kw)
        return self.observers

    def attach_edge_fleet(self, regions=("r0",), **kw):
        """Build the region-scoped Proof-CDN edge fleet (reads/edge.py):
        keyless envelope caches fed by the validators' BatchCommitted
        push stream, serviced from the prod loop; their per-region
        hit-rate feeds the aggregator so the autopilot's observer
        policy counts absorbed read capacity."""
        from plenum_tpu_torch.reads.edge import EdgeFleet
        self.edges = EdgeFleet(self, regions=regions, **kw)
        return self.edges

    def _wire_shard_telemetry(self, sid: int, shard: "SimShard") -> None:
        for node in shard.nodes.values():
            if node.telemetry.enabled:
                node.telemetry.tags = {"shard": sid}
                node.telemetry.add_sink(self.aggregator.ingest)
                # the per-shard mapping-epoch + migration-progress state
                # section the fleet console renders (satellite: watch a
                # reshard converge live)
                node.telemetry.add_source(
                    "shard_map",
                    lambda s=sid: self.reshard.state_for(s)
                    if getattr(self, "reshard", None) is not None else {})

    def add_shard(self, sid: int,
                  nodes_per_shard: Optional[int] = None,
                  verifier=None) -> "SimShard":
        """Boot a fresh sub-pool mid-run (the split target). It joins
        the fabric's routers and telemetry immediately; it joins the
        MAP only when the migration ratchets the epoch. The new shard
        shares the fabric's pipeline and any verifier pre-registered
        for its sid in `shard_verifiers` (or passed here), so a split
        target is not silently outside the configured crypto plane."""
        n = nodes_per_shard or self.nodes_per_shard
        self.lane_pins[sid] = self._shard_lane(sid)
        shard = SimShard(sid, shard_node_names(sid, n), self.timer,
                         self.seed * 1009 + sid * 7919 + 3, self.config,
                         pipeline=self.pipeline, tracing=self.tracing,
                         verifier=verifier
                         or self.shard_verifiers.get(sid),
                         pipeline_lane=self.lane_pins[sid])
        if self.latency is not None:
            shard.net.set_latency(*self.latency)
        self.shards[sid] = shard
        for name in shard.names:
            self.node_shard[name] = sid
        self.gates[sid] = ShardReadGate(self.mapping)
        self._wire_shard_telemetry(sid, shard)
        self.router.add_sink(sid, self._raw_sink(sid))
        self.ingress_router.add_sink(sid, self._preverified_sink(sid))
        return shard

    def retire_shard(self, sid: int) -> None:
        """Decommission a merged-away (or abandoned split) sub-pool: it
        stops being prodded, leaves both routers, and is FORGOTTEN by
        the aggregator — a decommissioned node must read as gone, not
        as a 0.0-health page."""
        shard = self.shards.pop(sid, None)
        if shard is None:
            return
        self.retired[sid] = shard
        self.lane_pins.pop(sid, None)
        self.router.remove_sink(sid)
        self.ingress_router.remove_sink(sid)
        for name, node in shard.nodes.items():
            if node.telemetry.enabled:
                node.telemetry.stop()
            self.aggregator.forget_node(name)

    def ingress_plane(self, entry_node: str, **kw):
        """An entry front door whose verified writes route ACROSS shards
        instead of into the entry node's own pipeline. A write whose
        owning shard scores 0.0 health (DOWN by the aggregator's
        staleness rule) is fast-NACKed with a retryable LoadShed hint
        instead of timing out against a dead sub-pool."""
        from plenum_tpu_torch.common.node_messages import LoadShed, RequestNack
        from plenum_tpu_torch.ingress import IngressPlane
        node = self.shards[self.node_shard[entry_node]].nodes[entry_node]

        def shard_down(request: Request, frm: str, sid: int) -> None:
            # passed PER CALL so every front door answers through ITS
            # OWN client channel — several planes share one router
            node._client_send(LoadShed(
                identifier=request.identifier, req_id=request.req_id,
                reason=f"owning shard {sid} unavailable",
                retry_after=self.config.INGRESS_TICK_INTERVAL * 10), frm)

        def sink(request: Request, frm: str) -> None:
            # an admitted, auth-verified write the map cannot place
            # NACKs through the front door, never black-holes — the
            # client must not wait out its reply timeout (router.py)
            if self.ingress_router.route(
                    request, frm, on_shard_down=shard_down) is None and \
                    self.ingress_router.shard_of(request) is None:
                node._client_send(RequestNack(
                    identifier=request.identifier, req_id=request.req_id,
                    reason="no shard owns this key"), frm)

        plane = IngressPlane(node, sink=sink, **kw)
        self.ingress_planes.append(plane)
        return plane

    def cross_writes(self):
        """The fabric's proof-carrying cross-shard write manager
        (shards/cross_write.py), created on first use."""
        if self._xsw is None:
            from .cross_write import CrossShardWrites
            self._xsw = CrossShardWrites(self)
        return self._xsw

    # --- driving ----------------------------------------------------------

    def prod_all(self) -> None:
        self.timer.service()
        self.reshard.service()
        if self.observers is not None:
            self.observers.service()
        if self.edges is not None:
            self.edges.service()
        if self.autopilot is not None:
            self.autopilot.service()
        for shard in list(self.shards.values()):
            shard.prod()

    def run(self, seconds: float = 5.0, step: float = 0.1) -> None:
        """Sim-time drive (MockTimer). Real-time timers should loop
        `prod_all` against the wall clock instead (bench_configs)."""
        elapsed = 0.0
        while elapsed < seconds:
            self.reshard.service()
            if self.observers is not None:
                self.observers.service()
            if self.edges is not None:
                self.edges.service()
            if self.autopilot is not None:
                self.autopilot.service()
            for shard in list(self.shards.values()):
                shard.prod()
            self.timer.advance(step)
            elapsed += step

    def submit_write(self, request: Request, frm: str = "bench"
                     ) -> Optional[int]:
        return self.router.route(request, frm)

    def ordered_counts(self) -> dict[int, int]:
        """-> cumulative ordered txns per shard; emits the DELTA since
        the previous call per shard, so the metric folds stay honest
        under repeated polling (sum = total ordered, mean = mean
        per-shard increment per snapshot)."""
        counts = {sid: s.ordered_count() for sid, s in self.shards.items()}
        for sid, n in counts.items():
            delta = n - self._ordered_emitted.get(sid, 0)
            if delta > 0:
                self.metrics.add_event(MetricsName.SHARD_ORDERED_BATCHES,
                                       delta)
            self._ordered_emitted[sid] = n
        # per-shard health + imbalance gauges ride the same poll, so the
        # `shards` metrics section visibly flags a degraded/hot shard
        # (signal only — routing policy is unchanged)
        for health in self.aggregator.shard_health().values():
            self.metrics.add_event(MetricsName.SHARD_HEALTH, health)
        index, _hot = self.aggregator.load_imbalance()
        if index is not None:
            self.metrics.add_event(MetricsName.SHARD_IMBALANCE, index)
        return counts

    # --- cross-shard reads ------------------------------------------------

    def map_view(self) -> ShardMapView:
        return ShardMapView.from_ledger(self.mapping)

    def read_driver(self, client: str = "xs",
                    freshness_s: float = 1e12,
                    map_freshness_s: float =
                    mapping_lib.DEFAULT_MAP_FRESHNESS_S,
                    view: Optional[ShardMapView] = None,
                    pump=None):
        """A shard-aware SimReadDriver: routing by the client's map view,
        failover INSIDE the owning shard, verification by the composed
        cross-shard check (ownership proof + shard-anchored read proof)."""
        from plenum_tpu_torch.reads import SimReadDriver

        view = view or self.map_view()
        checker = CrossShardReadCheck(
            self.mapping.directory_keys, n_directory=len(self.directory),
            freshness_s=freshness_s, map_freshness_s=map_freshness_s,
            now=self.timer.get_current_time, min_epoch=view.min_epoch,
            metrics=self.metrics)

        def submit(name, request):
            try:
                key = mapping_lib.routing_key(request.operation,
                                              request.identifier)
                self._pending_keys[(request.identifier,
                                    request.req_id)] = key
            except ValueError:
                pass
            sid = self.node_shard[name]
            # a retired (merged-away) node still accepts the message but
            # is never prodded: the rung times out and the ladder's map
            # refresh re-routes to the live owner
            self._shard_of(sid).nodes[name].handle_client_message(
                request.to_dict(), client)

        def collect(name):
            sid = self.node_shard[name]
            shard = self._shard_of(sid)
            msgs = shard.client_msgs[name]
            out = []
            keep = []
            for m, c in msgs:
                if isinstance(m, Reply) and c == client:
                    result = dict(m.result)
                    key = self._pending_keys.pop(
                        (result.get("identifier"), result.get("reqId")),
                        None)
                    if key is not None:
                        result = self.gates[sid].decorate(result, key)
                    out.append(result)
                else:
                    keep.append((m, c))
            shard.client_msgs[name] = keep
            return out

        all_names = [n for s in self.shards.values() for n in s.names]
        driver = SimReadDriver(
            submit, collect, pump or self.run, all_names, bls_keys={},
            now=self.timer.get_current_time, checker=checker,
            shard_resolver=view.nodes_for)

        def map_refresh() -> bool:
            """Re-sync the client's routing view from the mapping
            ledger; True when the epoch advanced (the ladder retries
            once against the new owner instead of erroring — clients
            must not fail during a healthy reshard). The node roster
            refreshes too: a split's new sub-pool postdates the driver."""
            before = view.min_epoch
            view.refresh(self.mapping)
            checker.note_epoch(view.min_epoch)
            driver.node_names = [n for s in self.shards.values()
                                 for n in s.names]
            return view.min_epoch > before

        driver.map_refresh = map_refresh
        # expose the aggregator's live per-shard health on the read
        # ladder (signal only — the ladder's failover policy is
        # unchanged): callers can flag reads served from degraded shards
        driver.shard_health = self.aggregator.shard_health
        tracer = self.fabric_tracer
        if tracer is not None and tracer.enabled:
            from plenum_tpu_torch.common import tracing
            inner_read = driver.read

            def traced_read(request, **kw):
                desc = view.descriptor_for(request)
                t0 = self.timer.get_current_time()
                res = inner_read(request, **kw)
                tracer.emit(tracing.CROSS_SHARD, request.digest, {
                    "shard": desc.shard_id if desc is not None else None,
                    "ok": res is not None,
                    "dur": self.timer.get_current_time() - t0})
                return res

            driver.read = traced_read
        return driver

    # --- reporting --------------------------------------------------------

    def tracer_snapshots(self) -> list:
        out = []
        for shard in self.shards.values():
            for node in shard.nodes.values():
                if node.tracer is not None and node.tracer.enabled:
                    out.append(node.tracer.snapshot())
        if self.fabric_tracer is not None:
            out.append(self.fabric_tracer.snapshot())
        return out

    def summary(self) -> dict:
        index, hot = self.aggregator.load_imbalance()
        return {
            "shards": len(self.shards),
            "router": self.router.summary(),
            "ingress_router": self.ingress_router.summary(),
            "ordered_per_shard": {sid: s.ordered_count()
                                  for sid, s in self.shards.items()},
            "shard_health": {sid: round(h, 3) for sid, h in
                             sorted(self.aggregator.shard_health().items())},
            "load_imbalance": index,
            "hot_shard": hot,
            "reshard": self.reshard.summary(),
            "stale_nacks": len(self.stale_nacks),
            **({"autopilot": self.autopilot.summary()}
               if self.autopilot is not None else {}),
            **({"observers": self.observers.summary()}
               if self.observers is not None else {}),
            **({"cross_writes": self._xsw.summary()}
               if self._xsw is not None else {}),
            "alerts": [a.to_dict() for a in self.aggregator.alerts[-20:]],
            **({"pipeline": self.pipeline.summary()}
               if self.pipeline is not None else {}),
        }
