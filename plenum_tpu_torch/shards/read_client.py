"""Client half of cross-shard reads: mapping view + proof composition.

A cross-shard read composes TWO proofs, and the client checks both from
trust roots it holds locally (no cross-shard quorum, no extra round
trips):

1. the **ownership proof** (`shard_proof`, mapping.py): the answering
   shard's descriptor is in the directory-signed map AND its key range
   contains the client-re-derived key — verified against the DIRECTORY
   BLS keys and the client's epoch watermark (fail closed on stale maps);
2. the **read proof** (`read_proof`, PR 4 reads/proofs.py): the result
   is anchored to THAT shard's BLS-multi-signed root — verified against
   the BLS key set *taken from the proven descriptor*, at the shard's
   own quorum size.

Order matters: the descriptor is what names the shard's keys, so a
forged map could launder a forged anchor — the ownership proof is
checked first and the read proof is only ever judged against keys the
directory signed for.

`ShardMapView` is the client's ROUTING view (which nodes to ask, epoch
watermark). It is advisory: verification never trusts it — a stale view
mis-routes a read and the server's proof fails closed ("wrong_shard"),
it cannot make a wrong answer verify.
"""
from __future__ import annotations

import time
from typing import Callable, Mapping, Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.reads import proofs
from plenum_tpu_torch.reads.client import ReadClientStats

from . import mapping as mapping_lib
from .mapping import SHARD_PROOF, ShardDescriptor, verify_ownership


class ShardMapView:
    """Client-side map: descriptors for routing + the epoch watermark.

    `note_epoch` ratchets (a client that has SEEN epoch e never accepts
    an epoch < e proof again — the fail-closed half of resharding);
    `refresh` re-syncs descriptors from a mapping ledger, ratcheting to
    its epoch.
    """

    def __init__(self, descriptors: Sequence[ShardDescriptor],
                 epoch: int = 0):
        self.descriptors = list(descriptors)
        self.min_epoch = int(epoch)

    @classmethod
    def from_ledger(cls, ledger: "mapping_lib.MappingLedger"
                    ) -> "ShardMapView":
        return cls([ShardDescriptor.from_dict(d.to_dict())
                    for d in ledger.descriptors], epoch=ledger.epoch)

    def note_epoch(self, epoch: int) -> None:
        self.min_epoch = max(self.min_epoch, int(epoch))

    def refresh(self, ledger: "mapping_lib.MappingLedger") -> None:
        self.descriptors = [ShardDescriptor.from_dict(d.to_dict())
                            for d in ledger.descriptors]
        self.note_epoch(ledger.epoch)

    def descriptor_for(self, request: Request) -> Optional[ShardDescriptor]:
        try:
            key = mapping_lib.routing_key(request.operation,
                                          request.identifier)
        except ValueError:
            return None
        point = mapping_lib.key_point(key)
        for d in self.descriptors:
            if d.owns_point(point):
                return d
        return None

    def nodes_for(self, request: Request) -> Optional[list[str]]:
        """The `shard_resolver` shape reads/client.py ladders expect."""
        d = self.descriptor_for(request)
        return list(d.nodes) if d is not None else None


class CrossShardReadStats(ReadClientStats):
    """Flat read stats + the mapping-proof failure taxonomy."""

    def __init__(self):
        super().__init__()
        self.cross_reads = 0
        self.map_proof_failures = 0
        self.map_failure_reasons: dict[str, int] = {}

    def summary(self) -> dict:
        out = super().summary()
        out["cross_reads"] = self.cross_reads
        out["map_proof_failures"] = self.map_proof_failures
        if self.map_failure_reasons:
            out["map_failure_reasons"] = dict(self.map_failure_reasons)
        return out


class CrossShardReadCheck:
    """Duck-compatible with reads/client.ReadCheck: `.check(request,
    result) -> (ok, reason)` + `.stats` — so both existing ladders
    (SimReadDriver, VerifyingReadClient) take it via `checker=`."""

    def __init__(self, directory_keys: Mapping[str, str],
                 n_directory: Optional[int] = None,
                 freshness_s: float = proofs.DEFAULT_FRESHNESS_S,
                 map_freshness_s: float =
                 mapping_lib.DEFAULT_MAP_FRESHNESS_S,
                 now: Optional[Callable[[], float]] = None,
                 min_epoch: int = 0,
                 metrics: Optional[MetricsCollector] = None):
        self.directory_keys = dict(directory_keys)
        self.n_directory = n_directory
        self.freshness_s = freshness_s
        self.map_freshness_s = map_freshness_s
        self.now = now
        self.min_epoch = min_epoch
        self.metrics = metrics
        self.stats = CrossShardReadStats()
        self._map_ms_cache: dict = {}
        # read-proof verdicts are judged against a DIFFERENT key set per
        # shard, so the memo must be per (shard, epoch): one shard's
        # cached verdict must never answer for another shard's keys
        self._read_ms_caches: dict[tuple[int, int], dict] = {}

    def note_epoch(self, epoch: int) -> None:
        self.min_epoch = max(self.min_epoch, int(epoch))

    def check(self, request: Request, result: Mapping) -> tuple[bool, str]:
        t0 = time.perf_counter()
        ok, reason = self._check(request, result)
        dt = time.perf_counter() - t0
        self.stats.note_verify(dt)
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.SHARD_CROSS_VERIFY_TIME, dt)
            self.metrics.add_event(MetricsName.SHARD_CROSS_READS)
            if ok:
                self.metrics.add_event(MetricsName.SHARD_CROSS_READS_OK)
        if not ok and reason != proofs.NO_PROOF:
            self.stats.verify_failures += 1
        return ok, reason

    def _check(self, request: Request, result: Mapping) -> tuple[bool, str]:
        self.stats.cross_reads += 1
        try:
            key = mapping_lib.routing_key(request.operation,
                                          request.identifier)
        except ValueError:
            return False, "unroutable_query"
        proof = result.get(SHARD_PROOF) if isinstance(result, Mapping) \
            else None
        desc, why = verify_ownership(
            key, proof, self.directory_keys, n_directory=self.n_directory,
            min_epoch=self.min_epoch, freshness_s=self.map_freshness_s,
            now=self.now, ms_cache=self._map_ms_cache)
        if desc is not None and desc.epoch > self.min_epoch:
            # a VERIFIED proof citing a newer epoch ratchets the client:
            # having seen epoch e, it never accepts an older map again
            # (the fail-closed half of resharding, mapping.py)
            self.min_epoch = desc.epoch
        if desc is None:
            # a missing/forged/stale ownership proof is an AFFIRMATIVE
            # failure (fail closed -> fail over within the shard), never
            # NO_PROOF (which would escalate to a broadcast that cannot
            # decide ownership either)
            self.stats.map_proof_failures += 1
            self.stats.map_failure_reasons[why] = \
                self.stats.map_failure_reasons.get(why, 0) + 1
            if self.metrics is not None:
                self.metrics.add_event(MetricsName.SHARD_MAP_PROOF_FAILURES)
            return False, why
        # the read proof is judged against the keys THE DIRECTORY SIGNED
        # for this shard, at the shard's own quorum size
        if len(self._read_ms_caches) > 16:
            self._read_ms_caches.clear()
        cache = self._read_ms_caches.setdefault(
            (desc.shard_id, desc.epoch), {})
        return proofs.verify_read_proof(
            request.txn_type, request.operation, result, desc.bls_keys,
            freshness_s=self.freshness_s, now=self.now,
            n_nodes=len(desc.nodes), ms_cache=cache)
