"""Per-replica single source of truth shared by the consensus services.

Reference behavior: plenum/server/consensus/consensus_shared_data.py:19 — one
mutable record per protocol instance holding view state, watermarks, in-flight
batches, checkpoints, and primaries. Services read/write it; the buses carry
the events. Nothing here touches the network.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common.node_messages import Checkpoint, PrePrepare
from plenum_tpu_torch.common.quorums import Quorums

from .batch_id import BatchID


def replica_name(node_name: str, inst_id: int) -> str:
    return f"{node_name}:{inst_id}"


def node_name_of(replica: str) -> str:
    return replica.rsplit(":", 1)[0]


class ConsensusSharedData:
    def __init__(self, name: str, validators: list[str], inst_id: int,
                 is_master: bool = True):
        self.name = name                        # replica name "Node:inst"
        self.inst_id = inst_id
        self.is_master = is_master
        self.view_no = 0
        self.waiting_for_new_view = False
        self.primaries: list[str] = []          # node names, rank == inst_id

        self.legacy_vc_in_progress = False
        self.is_participating = True

        # 3PC log state
        self.low_watermark = 0
        self.log_size = 300
        self.pp_seq_no = 0                      # last pp_seq_no this primary assigned
        self.last_ordered_3pc: tuple[int, int] = (0, 0)
        self.last_batch_timestamp = 0.0

        # In-flight batches (ordered by pp_seq_no)
        self.preprepared: list[BatchID] = []
        self.prepared: list[BatchID] = []

        # Checkpoints. Every node starts with the same virtual checkpoint at
        # seq 0 so the very first view change has a selectable candidate
        # (ref consensus_shared_data initial checkpoint).
        self.stable_checkpoint = 0
        self.checkpoints: list[Checkpoint] = [Checkpoint(
            inst_id=inst_id, view_no=0, seq_no_start=0, seq_no_end=0,
            digest="initial")]
        self.low_watermark = 0

        # View change artifacts
        self.new_view_votes = None
        self.prev_view_prepare_cert: Optional[int] = None

        self._validators: list[str] = []
        self.quorums = Quorums(len(validators) or 1)
        self.set_validators(validators)

    # --- pool membership --------------------------------------------------

    @property
    def validators(self) -> list[str]:
        return self._validators

    def set_validators(self, validators: list[str]) -> None:
        self._validators = list(validators)
        self.quorums = Quorums(len(validators))

    @property
    def total_nodes(self) -> int:
        return len(self._validators)

    @property
    def node_name(self) -> str:
        return node_name_of(self.name)

    # --- primary ----------------------------------------------------------

    @property
    def primary_name(self) -> Optional[str]:
        if self.inst_id < len(self.primaries):
            return self.primaries[self.inst_id]
        return None

    @property
    def is_primary(self) -> bool:
        return self.primary_name == self.node_name

    # --- watermarks -------------------------------------------------------

    @property
    def high_watermark(self) -> int:
        return self.low_watermark + self.log_size

    def is_in_watermarks(self, pp_seq_no: int) -> bool:
        return self.low_watermark < pp_seq_no <= self.high_watermark

    # --- in-flight batch helpers -----------------------------------------

    def preprepare_batch(self, batch_id: BatchID) -> None:
        if batch_id not in self.preprepared:
            self.preprepared.append(batch_id)

    def prepare_batch(self, batch_id: BatchID) -> None:
        if batch_id not in self.prepared:
            self.prepared.append(batch_id)

    def reset_in_flight(self) -> None:
        self.preprepared.clear()
        self.prepared.clear()
