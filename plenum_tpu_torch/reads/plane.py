"""Server half of the verified read plane.

Owned by the node, in front of the ReadRequestManager. Three jobs:

1. **Envelope** every query result (proofs.py): MPT state proofs at the
   latest BLS-signed state root for trie-backed queries, Merkle inclusion
   at the signed txn root / tree size for GET_TXN. A result whose proof
   cannot be anchored (no multi-sig yet, data fresher than the signed
   root, unplannable query shape) ships WITHOUT an envelope — never with
   a proof that doesn't match the data — and the client escalates.

2. **Cache** results per (signed root, query content): identical queries
   from any client between two batch commits are one proof generation.
   Anchor advance (batch commit landing a new multi-sig) invalidates the
   ledger's entries via the node's commit path.

3. **Batch** the per-tick query set: proof generation runs per prod-cycle
   batch, and the result digests that bind envelope to result are hashed
   through the ledger TreeHasher's batched leaf API — one vectorized
   SHA-256 dispatch per tick on the jax backend instead of a hashlib
   call per query.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsCollector, MetricsName
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.serialization import pack
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.multi_signature import MultiSignature
from plenum_tpu_torch.execution.txn import GET_TXN
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.state.commitment import (BACKEND_VERKLE,
                                         commitment_backend_of)

from . import proofs


class _Anchor:
    """The newest multi-signed root set for one ledger."""

    __slots__ = ("ms", "state_root_hex", "txn_root_hex", "tree_size")

    def __init__(self, ms: MultiSignature, tree_size: int):
        self.ms = ms
        self.state_root_hex = ms.value.state_root_hash
        self.txn_root_hex = ms.value.txn_root_hash
        self.tree_size = tree_size


class ReadPlane:
    CACHE_MAX = 4096
    ROOT_SIZES_MAX = 64

    def __init__(self, db, read_manager,
                 metrics: Optional[MetricsCollector] = None,
                 hasher: Optional[TreeHasher] = None,
                 tracer=None):
        from plenum_tpu_torch.common.tracing import NULL_TRACER
        self._db = db
        self._reads = read_manager
        self.metrics = metrics or MetricsCollector()
        # tracing plane: one read_batch span per tick's query set so read
        # latency shows up in waterfalls/attribution next to the write path
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._hasher = hasher or TreeHasher()
        self._anchors: dict[int, _Anchor] = {}
        # txn_root_hex -> committed tree size, recorded at batch commit so
        # a multi-sig landing later (pending-order retry) still anchors
        self._root_sizes: OrderedDict[str, int] = OrderedDict()
        # per-ledger shards of (anchor_root_hex, query_digest) -> core
        # result dict: invalidation on a ledger's commit is one dict drop,
        # never a scan on the ordering critical path
        self._cache: dict[int, OrderedDict[tuple, dict]] = {}
        self.stats = {"queries": 0, "cache_hits": 0, "proofs_state": 0,
                      "proofs_merkle": 0, "proofs_verkle": 0,
                      "proofless": 0,
                      "anchor_updates": 0, "invalidations": 0}
        # per-kind envelope counters for the 1-in-8 proof-byte sampling
        self._pb_counts: dict[str, int] = {}

    # --- anchor maintenance (called from the node's commit path) ---------

    def on_batch_committed(self, ledger_id: int, state_root_hex: str,
                           txn_root_hex: str) -> None:
        """A 3PC batch for `ledger_id` just committed durably. Remember
        the txn root's tree size; adopt the batch's multi-sig as the
        ledger's anchor if aggregation already produced one. The
        ledger's cached results are invalidated UNCONDITIONALLY: they
        describe superseded state, and when the multi-sig lags (late
        pending-order retry) the anchor — and thus the cache key — would
        otherwise stay put and keep serving pre-commit data from cache
        while fresh queries already see the new state."""
        ledger = self._db.get_ledger(ledger_id)
        if ledger is not None and txn_root_hex:
            self._root_sizes[txn_root_hex] = ledger.size
            while len(self._root_sizes) > self.ROOT_SIZES_MAX:
                self._root_sizes.popitem(last=False)
        self._invalidate(ledger_id)
        bls_store = self._db.bls_store
        if bls_store is not None and state_root_hex:
            ms = bls_store.get(state_root_hex)
            if ms is not None:
                self._adopt(ms)

    def on_multi_sig(self, ms: MultiSignature) -> None:
        """A multi-sig aggregated (possibly late, via the pending-order
        retry). Anchor it once its txn root's size is known."""
        self._adopt(ms)

    def _adopt(self, ms: MultiSignature) -> None:
        size = self._root_sizes.get(ms.value.txn_root_hash)
        if size is None:
            return
        lid = ms.value.ledger_id
        cur = self._anchors.get(lid)
        if cur is not None and cur.ms.value.timestamp > ms.value.timestamp:
            return                       # never move an anchor backwards
        if cur is not None and cur.ms == ms:
            return
        self._anchors[lid] = _Anchor(ms, size)
        self.stats["anchor_updates"] += 1
        self._invalidate(lid)

    def _invalidate(self, ledger_id: int) -> None:
        shard = self._cache.pop(ledger_id, None)
        if shard:
            self.stats["invalidations"] += len(shard)

    def anchor_for(self, ledger_id: int) -> Optional[_Anchor]:
        return self._anchors.get(ledger_id)

    # --- cache shards (key = (ledger_id, anchor_root_hex, op_digest)) ----

    def _cache_get(self, key: tuple) -> Optional[dict]:
        shard = self._cache.get(key[0])
        if shard is None:
            return None
        hit = shard.get(key[1:])
        if hit is not None:
            shard.move_to_end(key[1:])
        return hit

    def _cache_put(self, key: tuple, result: dict) -> None:
        shard = self._cache.setdefault(key[0], OrderedDict())
        shard[key[1:]] = result
        while len(shard) > self.CACHE_MAX:
            shard.popitem(last=False)

    # --- query answering --------------------------------------------------

    def answer_batch(self, requests: Sequence[Request]) -> list:
        """One entry per request: a result dict ready for Reply, or the
        exception (InvalidClientRequest and friends) the caller maps to a
        NACK. Proof generation and digest hashing are batched across the
        whole tick's query set."""
        proof_s = 0.0          # envelope build + digest hash time ONLY
        outcomes: list = [None] * len(requests)
        fresh: list[tuple[int, Request, dict, Optional[dict], int]] = []
        # identical queries WITHIN one tick's batch dedup too: the first
        # occurrence does the work, the rest resolve from the cache after
        # the fresh pass (a read-heavy tick is mostly repeats)
        in_flight: set = set()
        dups: list[tuple[int, Request, tuple]] = []
        for i, request in enumerate(requests):
            self.stats["queries"] += 1
            try:
                self._reads.static_validation(request)
                handler = self._reads._handlers[request.txn_type]
                key = self._cache_key(handler.ledger_id, request)
                cached = self._cache_get(key)
                if cached is not None:
                    self.stats["cache_hits"] += 1
                    outcomes[i] = self._personalize(cached, request)
                    continue
                if key in in_flight:
                    dups.append((i, request, key))
                    continue
                result = self._reads.get_result(request)
                t0 = time.perf_counter()
                env = self._build_envelope(handler.ledger_id, request,
                                           result)
                proof_s += time.perf_counter() - t0
                if env is not None:
                    result[proofs.READ_PROOF] = env
                    self._note_proof_bytes(env)
                else:
                    self.stats["proofless"] += 1
                in_flight.add(key)
                fresh.append((i, request, result, env, key))
            except Exception as e:
                outcomes[i] = e
        if fresh:
            # batched digest stage: one hash_leaves call covers every new
            # envelope this tick (device dispatch on the torch hasher).
            # MUST NOT take the prod loop down: a result one handler made
            # unpackable, or a device-backed hasher failing mid-dispatch,
            # degrades exactly the affected entries to proofless replies.
            with_env = [entry for entry in fresh if entry[3] is not None]
            if with_env:
                t0 = time.perf_counter()
                bound, preimages = [], []
                for entry in with_env:
                    try:
                        preimages.append(
                            proofs.result_digest_preimage(entry[2]))
                        bound.append(entry)
                    except Exception:
                        entry[2].pop(proofs.READ_PROOF, None)
                        self.stats["proofless"] += 1
                try:
                    digests = self._hasher.hash_leaves(preimages)
                except Exception:
                    # CPU re-try; hashlib over already-built preimages
                    # cannot fail, so the fallback never drops envelopes
                    digests = TreeHasher().hash_leaves(preimages)
                for (_, _, res, env, _), dg in zip(bound, digests):
                    env["result_digest"] = dg.hex()
                proof_s += time.perf_counter() - t0
            for i, request, result, env, key in fresh:
                self._cache_put(key, result)
                outcomes[i] = self._personalize(result, request)
        for i, request, key in dups:
            cached = self._cache_get(key)
            if cached is not None:
                self.stats["cache_hits"] += 1
                outcomes[i] = self._personalize(cached, request)
            else:                        # twin's fresh pass failed/evicted
                try:
                    outcomes[i] = self._personalize(
                        self._reads.get_result(request), request)
                except Exception as e:
                    outcomes[i] = e
        # one event per tick batch: the fold's sum IS total queries and
        # its mean IS the mean batch size — no second metric name needed
        self.metrics.add_event(MetricsName.READ_QUERIES, len(requests))
        if fresh:
            # only ticks that actually generated proofs sample the stage
            # timer — all-cache-hit ticks would flood the p50 with zeros
            self.metrics.add_event(MetricsName.READ_PROOF_GEN_TIME,
                                   proof_s)
        if self.tracer.enabled:
            from plenum_tpu_torch.common.tracing import READ_BATCH
            data = {"n": len(requests), "fresh": len(fresh),
                    "hits": len(requests) - len(fresh) - len(dups)}
            if fresh and self.tracer.wall_durations:
                data["proof_dur"] = proof_s
            self.tracer.emit(READ_BATCH, "", data)
        return outcomes

    def answer(self, request: Request) -> dict:
        """Single-query convenience; raises what answer_batch collects."""
        out = self.answer_batch([request])[0]
        if isinstance(out, Exception):
            raise out
        return out

    # --- internals --------------------------------------------------------

    def _cache_key(self, ledger_id: int, request: Request) -> tuple:
        # keyed by the TARGET ledger (GET_TXN names its own), so that
        # ledger's commits/anchor advances invalidate exactly its entries
        lid = self._target_ledger(ledger_id, request)
        anchor = self._anchors.get(lid)
        root = anchor.state_root_hex if anchor is not None else ""
        return (lid, root,
                hashlib.sha256(pack(request.operation)).hexdigest())

    @staticmethod
    def _target_ledger(handler_ledger_id: int, request: Request) -> int:
        if request.txn_type == GET_TXN:
            lid = request.operation.get("ledgerId", handler_ledger_id)
            return lid if isinstance(lid, int) else handler_ledger_id
        return handler_ledger_id

    @staticmethod
    def _personalize(core: dict, request: Request) -> dict:
        """Per-request overlay: echo the asker so transports can match
        read replies to requests (read results carry no txn metadata)."""
        out = dict(core)
        out["identifier"] = request.identifier
        out["reqId"] = request.req_id
        return out

    def _note_proof_bytes(self, env: dict) -> None:
        """Per-kind envelope byte size, sampled into the node metrics —
        the production counter the bytes-per-verified-read A/B reads
        (bench config13), instead of a bench-only tally. Measured at
        build time (before the result_digest lands: a ~70-byte constant
        across kinds, so the comparison is unaffected). Sampled 1-in-8
        per kind (first envelope always): the measurement is a full
        msgpack encode of the envelope, and paying it on EVERY
        cache-miss read would duplicate the transport's serialization
        work on the hot path for a distribution that barely varies."""
        kind = env.get("kind")
        if kind == proofs.KIND_STATE:
            name = (MetricsName.READ_PROOF_BYTES_STATE_MULTI
                    if len(env.get("entries") or ()) > 1
                    else MetricsName.READ_PROOF_BYTES_STATE)
        elif kind == proofs.KIND_MERKLE:
            name = MetricsName.READ_PROOF_BYTES_MERKLE
        elif kind == proofs.KIND_VERKLE:
            name = (MetricsName.READ_PROOF_BYTES_VERKLE_MULTI
                    if len(env.get("entries") or ()) > 1
                    else MetricsName.READ_PROOF_BYTES_VERKLE)
        else:
            return
        n = self._pb_counts.get(name, 0)
        self._pb_counts[name] = n + 1
        if n & 7:
            return
        try:
            self.metrics.add_event(name, len(pack(env)))
        except Exception:
            pass

    def _build_envelope(self, handler_ledger_id: int, request: Request,
                        result: dict) -> Optional[dict]:
        if request.txn_type == GET_TXN:
            return self._merkle_envelope(request, result)
        return self._state_envelope(handler_ledger_id, request, result)

    def _state_envelope(self, ledger_id: int, request: Request,
                        result: dict) -> Optional[dict]:
        plan = proofs.state_read_plan(request.txn_type, request.operation)
        if plan is None:
            return None
        plan_ledger, steps = plan
        anchor = self._anchors.get(plan_ledger)
        state = self._db.get_state(plan_ledger)
        if anchor is None or state is None:
            return None
        # the handler read committed state; the anchor must BE that root,
        # or the proof would disagree with the data (in-flight batch whose
        # multi-sig hasn't landed): ship proofless, client retries/falls
        # back, the window closes at the next anchor adoption
        if state.committed_head_hash.hex() != anchor.state_root_hex:
            return None
        root = state.committed_head_hash
        verkle = commitment_backend_of(state) == BACKEND_VERKLE
        entries: list[tuple[bytes, Optional[bytes], bytes]] = []
        page: list[tuple[bytes, Optional[bytes]]] = []
        values: list[Optional[bytes]] = []
        # resolve incrementally: deref steps need the previous value
        i = 0
        while True:
            keys = proofs.resolve_plan_keys(steps, values)
            if keys is None or i >= len(keys):
                break
            key = keys[i]
            value = state.get(key, committed=True)
            if verkle:
                # per-key proofs wait: the WHOLE page rides one
                # aggregated opening generated after the chain resolves
                page.append((key, value))
            else:
                proof = state.generate_state_proof(key, root_hash=root,
                                                   serialize=True)
                entries.append((key, value, proof))
            values.append(value)
            i += 1
        if verkle:
            if not page:
                return None
            agg = state.batch_open([k for k, _ in page], root_hash=root)
            self.stats["proofs_verkle"] += 1
            return proofs.build_verkle_envelope(
                anchor.ms, plan_ledger, anchor.state_root_hex, page, agg)
        if not entries:
            return None
        self.stats["proofs_state"] += 1
        return proofs.build_state_envelope(anchor.ms, plan_ledger,
                                           anchor.state_root_hex, entries)

    def page_envelope(self, ledger_id: int,
                      keys: Sequence[bytes]) -> Optional[dict]:
        """ONE envelope answering a whole client page of state keys at
        the ledger's anchored root — the multi-key carrier bench
        config13 measures and tests drive (no wire query names a page
        yet; per-request envelopes remain the transport surface).

        Verkle-backed ledgers aggregate the page into one opening;
        MPT-backed ledgers return the honest baseline (a ``state``
        envelope with one sibling chain per key). None when the ledger
        cannot anchor (same proofless contract as per-request reads)."""
        anchor = self._anchors.get(ledger_id)
        state = self._db.get_state(ledger_id)
        if anchor is None or state is None or not keys:
            return None
        if state.committed_head_hash.hex() != anchor.state_root_hex:
            return None
        root = state.committed_head_hash
        if commitment_backend_of(state) == BACKEND_VERKLE:
            page = [(k, state.get(k, committed=True)) for k in keys]
            agg = state.batch_open(list(keys), root_hash=root)
            env = proofs.build_verkle_envelope(
                anchor.ms, ledger_id, anchor.state_root_hex, page, agg)
            self.stats["proofs_verkle"] += 1
        else:
            entries = [(k, state.get(k, committed=True),
                        state.generate_state_proof(k, root_hash=root,
                                                   serialize=True))
                       for k in keys]
            env = proofs.build_state_envelope(
                anchor.ms, ledger_id, anchor.state_root_hex, entries)
            self.stats["proofs_state"] += 1
        self._note_proof_bytes(env)
        return env

    def _merkle_envelope(self, request: Request,
                         result: dict) -> Optional[dict]:
        op = request.operation
        # an omitted ledgerId defaults to DOMAIN, exactly as the handler's
        # get_result resolves it — a sentinel here would route the default
        # case to a ledger that can never anchor
        lid = self._target_ledger(DOMAIN_LEDGER_ID, request)
        anchor = self._anchors.get(lid)
        ledger = self._db.get_ledger(lid)
        if anchor is None or ledger is None:
            return None
        seq_no = op.get("data")
        if not isinstance(seq_no, int) or seq_no < 1:
            return None
        last_leaf = None
        if result.get("data") is None:
            # absence is provable only as beyond-the-signed-tree; the last
            # leaf's inclusion proof at the anchored size binds that size
            # to the signed root (the multi-sig value names no size)
            if seq_no <= anchor.tree_size:
                return None
            path: list[bytes] = []
            if anchor.tree_size > 0:
                from plenum_tpu_torch.ledger.ledger import txn_to_leaf
                last_leaf = txn_to_leaf(
                    ledger.get_by_seq_no(anchor.tree_size))
                path = ledger.tree.inclusion_proof(anchor.tree_size - 1,
                                                   anchor.tree_size)
        else:
            if seq_no > anchor.tree_size:
                return None              # fresher than the signed root
            path = ledger.tree.inclusion_proof(seq_no - 1,
                                               anchor.tree_size)
        self.stats["proofs_merkle"] += 1
        return proofs.build_merkle_envelope(
            anchor.ms, lid, anchor.txn_root_hex, seq_no,
            anchor.tree_size, path, last_leaf=last_leaf)
