"""Checkpointing: periodic stabilization points that garbage-collect the 3PC
log and bound how far any node can run ahead.

Reference behavior: plenum/server/consensus/checkpoint_service.py:29 — every
CHK_FREQ ordered batches the replica emits a Checkpoint keyed by the audit
ledger root (:147-166); a quorum of n-f-1 matching checkpoints stabilizes it
(_mark_checkpoint_stable :177), advancing the watermark window [h, h+LOG_SIZE]
(set_watermarks :216); a checkpoint quorum the node cannot reach from its own
ordered log triggers catchup (_start_catchup_if_needed :107).
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus, InternalBus
from plenum_tpu_torch.common.internal_messages import (CheckpointStabilized,
                                                 NeedMasterCatchup)
from plenum_tpu_torch.common.node_messages import Checkpoint, Ordered
from plenum_tpu_torch.config import Config

from .consensus_shared_data import ConsensusSharedData


class CheckpointService:
    def __init__(self,
                 data: ConsensusSharedData,
                 bus: InternalBus,
                 network: ExternalBus,
                 config: Optional[Config] = None,
                 checkpoint_digest_provider: Optional[Callable[[int], str]] = None):
        self._data = data
        self._bus = bus
        self._network = network
        self._config = config or Config()
        # Digest of the stabilizable state at a pp_seq_no — the node wires this
        # to the audit ledger's uncommitted root; standalone tests use a stub.
        self._digest_for = checkpoint_digest_provider or (lambda seq: f"chk-{seq}")
        self._data.log_size = self._config.LOG_SIZE
        # (seq_no_end, digest) -> set of voting node names
        self._received: dict[tuple[int, str], set[str]] = {}
        self._own: dict[int, Checkpoint] = {}

        bus.subscribe(Ordered, self.process_ordered)
        self._network_unsub = network.subscribe(Checkpoint,
                                                self.process_checkpoint)

    def stop(self) -> None:
        """Detach from the shared network bus (replica removal)."""
        self._network_unsub()

    @property
    def _chk_freq(self) -> int:
        return self._config.CHK_FREQ

    # --- producing checkpoints -------------------------------------------

    def process_ordered(self, ordered: Ordered) -> None:
        if ordered.inst_id != self._data.inst_id:
            return
        seq_no = ordered.pp_seq_no
        if seq_no % self._chk_freq != 0:
            return
        self._create_checkpoint(seq_no)

    def _create_checkpoint(self, seq_no: int) -> None:
        msg = Checkpoint(inst_id=self._data.inst_id,
                         view_no=self._data.view_no,
                         seq_no_start=self._data.stable_checkpoint + 1,
                         seq_no_end=seq_no,
                         digest=self._digest_for(seq_no))
        self._own[seq_no] = msg
        self._data.checkpoints.append(msg)
        self._network.send(msg)
        self._try_stabilize(seq_no, msg.digest)

    # --- receiving checkpoints -------------------------------------------

    def process_checkpoint(self, msg: Checkpoint, sender: str) -> None:
        if msg.inst_id != self._data.inst_id:
            return
        if msg.seq_no_end <= self._data.stable_checkpoint:
            return
        key = (msg.seq_no_end, msg.digest)
        self._received.setdefault(key, set()).add(sender)
        self._try_stabilize(msg.seq_no_end, msg.digest)
        self._check_if_lagging(msg.seq_no_end, msg.digest)

    def _votes(self, seq_no: int, digest: str) -> int:
        votes = len(self._received.get((seq_no, digest), ()))
        if seq_no in self._own and self._own[seq_no].digest == digest:
            votes += 1
        return votes

    def _try_stabilize(self, seq_no: int, digest: str) -> None:
        if seq_no <= self._data.stable_checkpoint:
            return
        if seq_no not in self._own:
            return                      # can't stabilize what we haven't reached
        if self._own[seq_no].digest != digest:
            return
        if not self._data.quorums.checkpoint.is_reached(self._votes(seq_no, digest)):
            return
        self._mark_stable(seq_no)

    def _mark_stable(self, seq_no: int) -> None:
        self._data.stable_checkpoint = seq_no
        self._data.low_watermark = seq_no
        # Keep the newly-stable checkpoint itself: view changes cite it.
        self._data.checkpoints = [c for c in self._data.checkpoints
                                  if c.seq_no_end >= seq_no]
        self._own = {k: v for k, v in self._own.items() if k > seq_no}
        self._received = {k: v for k, v in self._received.items() if k[0] > seq_no}
        # Prune in-flight batch records below the watermark.
        self._data.preprepared = [b for b in self._data.preprepared
                                  if b.pp_seq_no > seq_no]
        self._data.prepared = [b for b in self._data.prepared
                               if b.pp_seq_no > seq_no]
        self._bus.send(CheckpointStabilized(
            inst_id=self._data.inst_id,
            last_stable_3pc=(self._data.view_no, seq_no)))

    # --- lag detection (ref :107) ----------------------------------------

    def _check_if_lagging(self, seq_no: int, digest: str) -> None:
        votes = len(self._received.get((seq_no, digest), set()))
        if not self._data.quorums.checkpoint.is_reached(votes):
            return
        # A full quorum agrees on a checkpoint we haven't produced ourselves
        # and that is beyond our watermark window: we fell behind.
        lagging = (seq_no not in self._own
                   and seq_no > self._data.last_ordered_3pc[1] + self._chk_freq)
        if lagging and self._data.is_master:
            self._mark_stable_remote(seq_no)
            self._bus.send(NeedMasterCatchup())

    def _mark_stable_remote(self, seq_no: int) -> None:
        """Adopt a remote quorum checkpoint so stashed traffic can unblock
        after catchup."""
        self._data.stable_checkpoint = seq_no
        self._data.low_watermark = seq_no

    # --- view change hooks ------------------------------------------------

    def process_new_view_accepted(self, checkpoint: tuple) -> None:
        """Reset to the checkpoint selected by NewView (ref :304)."""
        view, start, end, digest = checkpoint
        if end > self._data.stable_checkpoint:
            self._data.stable_checkpoint = end
            self._data.low_watermark = end
        self._own = {k: v for k, v in self._own.items() if k > end}
        self._received = {k: v for k, v in self._received.items() if k[0] > end}
        # The adopted checkpoint STAYS in the list: the next view change must
        # have a selectable candidate every node holds, or NewViewBuilder can
        # never reach its strong quorum again and every later view change
        # deadlocks (the same reason every node starts with the virtual
        # checkpoint at seq 0).
        self._data.checkpoints = \
            [Checkpoint(inst_id=self._data.inst_id, view_no=view,
                        seq_no_start=start, seq_no_end=end, digest=digest)] + \
            [c for c in self._data.checkpoints if c.seq_no_end > end]
