"""Replica: one protocol instance = shared data + the consensus services wired
over a private internal bus.

Reference behavior: plenum/server/replica.py:84 (service wiring :151-171) and
replicas.py:19 (the master + backup collection; RBFT runs f+1 instances and
the monitor compares master vs backup throughput, SURVEY.md §2.3). Event glue
reproduced here: NewViewAccepted → checkpoint reset → NewViewCheckpointsApplied
→ ordering re-orders; CheckpointStabilized → ordering GC.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.internal_messages import (CheckpointStabilized,
                                                 NewViewAccepted,
                                                 NewViewCheckpointsApplied,
                                                 ViewChangeStarted)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import TimerService
from plenum_tpu_torch.config import Config

from .batch_executor import BatchExecutor
from .bls_bft_replica import BlsBftReplica
from .checkpoint_service import CheckpointService
from .consensus_shared_data import ConsensusSharedData, replica_name
from .ordering_service import OrderingService
from .primary_health_service import PrimaryHealthService
from .primary_selector import RoundRobinPrimariesSelector
from .view_change_service import ViewChangeService
from .view_change_trigger_service import ViewChangeTriggerService


class Replica:
    def __init__(self,
                 node_name: str,
                 inst_id: int,
                 validators: list[str],
                 timer: TimerService,
                 network: ExternalBus,
                 executor: Optional[BatchExecutor] = None,
                 bls: Optional[BlsBftReplica] = None,
                 config: Optional[Config] = None,
                 get_request: Optional[Callable[[str], Optional[Request]]] = None,
                 checkpoint_digest_provider=None,
                 instance_count: int = 1,
                 external_internal_bus: Optional[InternalBus] = None,
                 metrics=None,
                 ic_vote_store=None,
                 tracer=None,
                 controller=None,
                 rtt=None):
        self.name = replica_name(node_name, inst_id)
        self.inst_id = inst_id
        self.config = config or Config()
        self.internal_bus = external_internal_bus or InternalBus()
        self.network = network

        self._data = ConsensusSharedData(self.name, validators, inst_id,
                                         is_master=(inst_id == 0))
        selector = RoundRobinPrimariesSelector()
        self._data.primaries = selector.select_primaries(
            0, instance_count, validators)

        self.bls = bls
        if bls is not None:
            bls.set_quorums(self._data.quorums)

        # closed-loop batch controller: a MASTER-instance concern (backup
        # instances shadow-order the same traffic; steering their batching
        # would fight the monitor's master-vs-backup comparison)
        self.batch_controller = controller if self._data.is_master else None
        self.ordering = OrderingService(
            data=self._data, timer=timer, bus=self.internal_bus,
            network=network, executor=executor, bls=bls, config=self.config,
            get_request=get_request, metrics=metrics, tracer=tracer,
            controller=self.batch_controller)
        self.checkpointer = CheckpointService(
            data=self._data, bus=self.internal_bus, network=network,
            config=self.config,
            checkpoint_digest_provider=checkpoint_digest_provider)
        # View change is a NODE-level event driven by the MASTER instance only:
        # ViewChange/ViewChangeAck/NewView/InstanceChange carry no inst_id on
        # the wire (matching the reference), so giving every backup its own
        # view-change machinery on the shared bus makes instances impersonate
        # each other's votes. Backups follow the master's completed view change
        # via Replica.adopt_new_view (driven by the node).
        self.view_changer: Optional[ViewChangeService] = None
        self.vc_trigger: Optional[ViewChangeTriggerService] = None
        self.primary_health: Optional[PrimaryHealthService] = None
        if self._data.is_master:
            self.view_changer = ViewChangeService(
                data=self._data, timer=timer, bus=self.internal_bus,
                network=network, config=self.config, selector=selector,
                instance_count=instance_count, rtt=rtt)
            self.vc_trigger = ViewChangeTriggerService(
                data=self._data, timer=timer, bus=self.internal_bus,
                network=network, config=self.config,
                vote_store=ic_vote_store)
            self.primary_health = PrimaryHealthService(
                data=self._data, timer=timer, bus=self.internal_bus,
                has_pending_work=self.has_unordered_work, config=self.config,
                network=network, rtt=rtt)

        self.internal_bus.subscribe(NewViewAccepted, self._on_new_view_accepted)
        self.internal_bus.subscribe(CheckpointStabilized, self._on_checkpoint_stable)

    def stop(self) -> None:
        """Detach this instance from the shared node buses and timers. A
        replica removed as faulty (node._process_backup_faulty) must become
        inert — a popped-but-subscribed instance would keep processing 3PC
        traffic as a zombie and, once the view change re-creates the id,
        two replicas would speak with one name."""
        self.ordering.stop()
        self.checkpointer.stop()
        if self.primary_health is not None:
            self.primary_health.stop()

    def has_unordered_work(self) -> bool:
        """Finalized requests queued, or batches pre-prepared but unordered.
        preprepared CERTIFICATES survive ordering until checkpoint GC (they
        back view-change proofs), so only batches BEYOND last_ordered count
        as pending — a stabilization-lagged cert must not read as a stalled
        primary."""
        if any(self.ordering.request_queues.values()):
            return True
        last = self._data.last_ordered_3pc
        return any((b.view_no, b.pp_seq_no) > last
                   for b in self._data.preprepared)

    def adopt_new_view(self, view_no: int, primaries: list[str]) -> None:
        """Backup instance follows a master-completed view change: take the
        new view and primaries, drop in-flight 3PC work, and realign the
        batch counter so the instance's new primary continues the sequence
        (ref: node-level primary re-selection on view change; backups restart
        from their own last ordered position)."""
        if self._data.is_master or view_no <= self._data.view_no:
            return
        self._data.view_no = view_no
        self._data.primaries = list(primaries)
        self._data.waiting_for_new_view = False
        self.ordering.process_view_change_started(
            ViewChangeStarted(view_no=view_no))
        # Continue numbering from this instance's own ordered prefix.
        floor = self._data.last_ordered_3pc[1]
        self.ordering.process_new_view_checkpoints_applied(
            NewViewCheckpointsApplied(view_no=view_no,
                                      checkpoint=(0, 0, floor, ""),
                                      batches=()))

    # --- event glue -------------------------------------------------------

    def _on_new_view_accepted(self, msg: NewViewAccepted) -> None:
        self.checkpointer.process_new_view_accepted(msg.checkpoint)
        self.internal_bus.send(NewViewCheckpointsApplied(
            view_no=msg.view_no, checkpoint=msg.checkpoint, batches=msg.batches))

    def _on_checkpoint_stable(self, msg: CheckpointStabilized) -> None:
        self.ordering.gc(msg.last_stable_3pc)

    # --- accessors --------------------------------------------------------

    @property
    def data(self) -> ConsensusSharedData:
        return self._data

    @property
    def is_master(self) -> bool:
        return self._data.is_master

    @property
    def is_primary(self) -> bool:
        return self._data.is_primary

    @property
    def view_no(self) -> int:
        return self._data.view_no

    @property
    def last_ordered_3pc(self) -> tuple[int, int]:
        return self._data.last_ordered_3pc

    def set_validators(self, validators: list[str]) -> None:
        self._data.set_validators(validators)
        if self.bls is not None:
            self.bls.set_quorums(self._data.quorums)

    def service(self) -> None:
        """One prod cycle: primaries flush queued requests into batches."""
        self.ordering.service()


class Replicas:
    """The RBFT instance collection: instance 0 is the master, the rest shadow
    (ref replicas.py:19, adjustReplicas node.py:1260).

    Keyed by inst_id (not list position): removing a faulty backup (ref
    backup_instance_faulty_processor) leaves a GAP, and the surviving
    instances must keep their ids — 3PC messages carry inst_id on the wire.
    `grow_to` fills gaps, which is also how a removed backup is re-added
    fresh at the next view change."""

    def __init__(self, make_replica: Callable[[int], Replica]):
        self._make = make_replica
        self._replicas: dict[int, Replica] = {}

    def grow_to(self, count: int, skip: set[int] = frozenset()) -> None:
        """Create every missing instance below `count`, except ids in
        `skip` (backups removed as faulty stay out until a view change
        clears them)."""
        for inst_id in range(count):
            if inst_id not in self._replicas and inst_id not in skip:
                self._replicas[inst_id] = self._make(inst_id)

    def shrink_to(self, count: int) -> None:
        for inst_id in [i for i in self._replicas if i >= count]:
            self._replicas.pop(inst_id).stop()

    def remove_instance(self, inst_id: int) -> Optional[Replica]:
        """Drop a faulty BACKUP instance (master is never removable). The
        dropped replica is detached (stop()) so it cannot keep processing
        shared-bus traffic as a zombie."""
        if inst_id == 0:
            raise ValueError("the master instance cannot be removed")
        removed = self._replicas.pop(inst_id, None)
        if removed is not None:
            removed.stop()
        return removed

    @property
    def master(self) -> Replica:
        return self._replicas[0]

    @property
    def instance_ids(self) -> list[int]:
        return sorted(self._replicas)

    def __iter__(self):
        return iter(self._replicas[i] for i in sorted(self._replicas))

    def __len__(self):
        return len(self._replicas)

    def __contains__(self, inst_id: int) -> bool:
        return inst_id in self._replicas

    def __getitem__(self, inst_id: int) -> Replica:
        return self._replicas[inst_id]

    def service_all(self) -> None:
        for replica in self:
            replica.service()
