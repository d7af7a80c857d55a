"""Write-request manager: typed execution with uncommitted staging.

Reference behavior: plenum/server/request_managers/write_request_manager.py:33
— the single entry point consensus uses to run the execution layer:
static/dynamic validation (:99), apply to uncommitted ledger+state, commit a
batch after ordering (:178), revert on view change/rejection (:195); handler
dispatch by txn type (:113). Batch bookkeeping (the audit snapshot per batch,
ts-store writes, seq-no map) mirrors batch_handlers/audit_batch_handler.py:20
and batch_handlers (ts_store, primary, node_reg rows of SURVEY.md §2).

Design: one manager instance per node; per-batch undo records make
apply→revert exact inverses, which is the property consensus relies on when
re-ordering after a view change (SURVEY.md §7 hard part 4).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

from plenum_tpu_torch.common.metrics import MetricsName

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import canonicalize, pack, unpack
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.database_manager import (DatabaseManager,
                                                         SEQ_NO_DB_LABEL,
                                                         TS_STORE_LABEL)
from plenum_tpu_torch.execution.exceptions import (InvalidClientRequest,
                                                   UnauthorizedClientRequest)
from plenum_tpu_torch.execution.handlers import audit as audit_lib
from plenum_tpu_torch.execution.handlers.base import WriteRequestHandler
from plenum_tpu_torch.execution.handlers.taa import (KEY_AML_LATEST, KEY_LATEST,
                                                     _digest_key)


class ThreePcBatch(NamedTuple):
    """What consensus knows about one ordered batch (ref three_pc_batch.py:7)."""
    ledger_id: int
    view_no: int
    pp_seq_no: int
    pp_time: float
    valid_digests: tuple[str, ...]
    state_root: bytes
    txn_root: bytes
    audit_txn_root: bytes
    primaries: tuple[str, ...] = ()
    node_reg: tuple[str, ...] = ()


class _Undo(NamedTuple):
    ledger_id: int
    n_txns: int
    prev_state_roots: dict[int, bytes]     # uncommitted heads before apply
    pp_seq_no: int


class WriteRequestManager:
    def __init__(self, db: DatabaseManager,
                 primaries_provider: Optional[Callable[[], Sequence[str]]] = None,
                 node_reg_provider: Optional[Callable[[], Sequence[str]]] = None,
                 taa_acceptance_window: float = 2 * 24 * 3600):
        self.db = db
        self._handlers: dict[str, WriteRequestHandler] = {}
        # (txn_type, version) -> handler for version-carrying payloads
        self._versioned: dict[tuple[str, str], WriteRequestHandler] = {}
        self._batches: list[_Undo] = []
        self._primaries_provider = primaries_provider or (lambda: [])
        self._node_reg_provider = node_reg_provider or (lambda: [])
        self._taa_window = taa_acceptance_window
        self.on_batch_committed: list[Callable[[ThreePcBatch, list[dict]], None]] = []
        # node wiring (node/node.py): commit_wave_time samples land here
        self.metrics = None

    # --- registry ---------------------------------------------------------
    #
    # Version-keyed dispatch (ref txn_version_controller.py:1 +
    # write_request_manager.py:113): a handler registered with a version
    # string serves only payloads carrying that version; payloads without
    # one (and versions with no specific registration) fall back to the
    # default handler. This is the seam txn-format evolution builds on —
    # a pool can roll out a v2 payload format handler-first, with no flag
    # day: old-format txns keep applying through the default handler.

    def register_handler(self, handler: WriteRequestHandler,
                         version: Optional[str] = None) -> None:
        if version is None:
            self._handlers[handler.txn_type] = handler
        else:
            self._versioned[(handler.txn_type, str(version))] = handler

    def handler_for(self, txn_type: Optional[str],
                    version: Optional[str] = None) -> WriteRequestHandler:
        if version is not None:
            h = self._versioned.get((txn_type, str(version)))
            if h is not None:
                return h
        if txn_type not in self._handlers:
            raise InvalidClientRequest(reason=f"unknown txn type {txn_type!r}")
        return self._handlers[txn_type]

    @staticmethod
    def request_version(request: Request) -> Optional[str]:
        """Payload format version carried by the request's operation
        (ref get_payload_txn_version; absent means the default format)."""
        ver = request.operation.get("ver")
        return str(ver) if ver is not None else None

    def is_write_type(self, txn_type: Optional[str]) -> bool:
        return txn_type in self._handlers or any(
            t == txn_type for t, _ in self._versioned)

    def ledger_id_for(self, request: Request) -> int:
        return self.handler_for(request.txn_type,
                                self.request_version(request)).ledger_id

    # --- validation -------------------------------------------------------

    def static_validation(self, request: Request) -> None:
        self.handler_for(request.txn_type,
                         self.request_version(request)).static_validation(request)

    def dynamic_validation(self, request: Request, pp_time: Optional[float]) -> None:
        handler = self.handler_for(request.txn_type,
                                   self.request_version(request))
        if handler.ledger_id == DOMAIN_LEDGER_ID:
            self._validate_taa_acceptance(request, pp_time)
        handler.dynamic_validation(request, pp_time)

    def _validate_taa_acceptance(self, request: Request, pp_time) -> None:
        """Domain writes must carry a valid acceptance while a TAA is active
        (reference: TAA validation in dynamic path of the write manager)."""
        config_state = self.db.get_state(CONFIG_LEDGER_ID)
        if config_state is None:
            return
        latest = config_state.get(KEY_LATEST, committed=False)
        acceptance = request.taa_acceptance
        if latest is None:
            if acceptance is not None:
                raise UnauthorizedClientRequest(
                    request.identifier, request.req_id,
                    "taaAcceptance not allowed: no active TAA")
            return
        if acceptance is None:
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                "transaction author agreement acceptance required")
        digest = acceptance.get("taaDigest")
        raw = config_state.get(_digest_key(digest), committed=False) \
            if digest else None
        rec = unpack(raw) if raw is not None else None
        if rec is None:
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                f"unknown TAA digest {digest!r}")
        ret = rec.get("retirement_ts")
        if ret is not None and pp_time is not None and ret <= pp_time:
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id, "TAA version is retired")
        aml_raw = config_state.get(KEY_AML_LATEST, committed=False)
        aml = unpack(aml_raw) if aml_raw is not None else None
        mech = acceptance.get("mechanism")
        if aml is not None and mech not in aml.get("aml", {}):
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                f"unknown acceptance mechanism {mech!r}")
        at = acceptance.get("time")
        if at is None or (pp_time is not None and
                          abs(at - pp_time) > self._taa_window):
            raise UnauthorizedClientRequest(
                request.identifier, request.req_id,
                "acceptance time outside the allowed window")

    # --- apply / revert / commit -----------------------------------------

    def apply_batch(self, ledger_id: int, requests: Sequence[Request],
                    pp_time: float, view_no: int, pp_seq_no: int,
                    primaries: Optional[Sequence[str]] = None
                    ) -> tuple[list[Request], list[tuple[Request, str]], dict]:
        """Dynamic-validate and apply a batch to uncommitted ledger+state.

        view_no/primaries must be the batch's ORIGINAL view and that view's
        primaries: the audit txn snapshots them, and a batch re-ordered after
        a view change must hash to the same audit root it was minted with
        (ref audit_batch_handler original_view_no semantics).

        Returns (valid, [(request, reason) rejected], roots) where roots has
        hex 'state_root', 'txn_root', 'pool_state_root', 'audit_txn_root'.
        """
        # Trie-node writes from update_state go durable as they happen;
        # grouping the whole apply into one batch per store turns the
        # ~per-key flush storm into one append. Atomicity is free here:
        # uncommitted trie nodes are content-addressed — a crashed apply
        # leaves unreferenced nodes at worst, never a broken head.
        with self.db.group_commit():
            return self._apply_batch_grouped(ledger_id, requests, pp_time,
                                             view_no, pp_seq_no, primaries)

    def _apply_batch_grouped(self, ledger_id, requests, pp_time, view_no,
                             pp_seq_no, primaries):
        ledger = self.db.get_ledger(ledger_id)
        state = self.db.get_state(ledger_id)
        prev_roots: dict[int, bytes] = {}
        for lid in self.db.ledger_ids:
            st = self.db.get_state(lid)
            if st is not None:
                prev_roots[lid] = st.head_hash

        valid, rejected, txns = [], [], []
        base_seq = ledger.uncommitted_size    # total incl. staged
        for req in requests:
            try:
                self.dynamic_validation(req, pp_time)
            except (InvalidClientRequest, UnauthorizedClientRequest) as e:
                rejected.append((req, e.reason))
                continue
            version = self.request_version(req)
            handler = self.handler_for(req.txn_type, version)
            txn = handler.gen_txn(req)
            if version is not None and (req.txn_type, version) \
                    in self._versioned:
                # stamp the PAYLOAD format version a versioned handler
                # minted, so catchup/observer replay dispatches to the
                # same handler. This is the payload-level field (ref
                # txn_util.get_payload_txn_version: txn["txn"]["ver"]) —
                # NOT the top-level envelope version, which is "1" on
                # every txn and must never key handler dispatch (a
                # version-"1" registration would otherwise route live
                # ordering and replay differently -> state fork)
                txn["txn"]["ver"] = version
            txn_lib.set_seq_no(txn, base_seq + len(txns) + 1)
            txn_lib.set_txn_time(txn, int(pp_time))
            handler.update_state(txn, is_committed=False)
            # final form: canonicalize ONCE so the merkle leaf, the txn-log
            # write, and the client REPLY all pack without re-walking
            # (serialization.CanonicalDict); mutation past this point
            # raises instead of silently forking the ledger
            txns.append(canonicalize(txn))
            valid.append(req)

        # fused commit wave (parallel/commit_wave.py): resolve every
        # state head + the batch ledger's append as ONE level-synchronized
        # cmt dispatch cadence instead of per-tree inline hashing. Two
        # phases because the audit txn can only be BUILT from the roots
        # phase A mints; phase B drains the audit append on the same
        # wave. Any failure degrades to the lazy host properties below,
        # which recompute the identical roots (byte-identity is the
        # golden-vector contract, so the degrade can never fork state).
        wave = self._commit_wave()
        t_wave = time.perf_counter() if wave is not None else None
        if wave is None:
            ledger.append_txns_to_uncommitted(txns)
        else:
            ledger.append_txns_to_uncommitted(txns, defer_hash=True)
            try:
                for lid in self.db.ledger_ids:
                    st = self.db.get_state(lid)
                    if st is not None and hasattr(st, "recommit_staged"):
                        wave.add("state:%d" % lid, st.recommit_staged())
                wave.add("txn", ledger.uncommitted_root_staged())
                wave.run()
            except Exception:
                wave = None

        audit_ledger = self.db.get_ledger(AUDIT_LEDGER_ID)
        if audit_ledger is not None:
            last = self._last_uncommitted_audit(audit_ledger)
            audit_txn = audit_lib.build_audit_txn(
                self.db, view_no, pp_seq_no, pp_time, ledger_id,
                list(primaries) if primaries is not None
                else self._resolve_primaries(view_no),
                self._node_reg_provider(), last)
            txn_lib.set_seq_no(audit_txn, audit_ledger.uncommitted_size + 1)
            audit_row = [canonicalize(audit_txn)]
            if wave is None:
                audit_ledger.append_txns_to_uncommitted(audit_row)
            else:
                audit_ledger.append_txns_to_uncommitted(audit_row,
                                                        defer_hash=True)
                try:
                    wave.add("audit",
                             audit_ledger.uncommitted_root_staged())
                    wave.run()
                except Exception:
                    wave = None

        self._batches.append(_Undo(ledger_id, len(txns), prev_roots, pp_seq_no))
        pool_state = self.db.get_state(POOL_LEDGER_ID)
        wroots = wave.roots if wave is not None else {}

        def _st_root(lid, st):
            got = wroots.get("state:%d" % lid)
            return got if got is not None else st.head_hash

        roots = {
            "state_root": (_st_root(ledger_id, state).hex()
                           if state is not None else ""),
            "txn_root": (wroots.get("txn")
                         or ledger.uncommitted_root_hash).hex(),
            "pool_state_root": (_st_root(POOL_LEDGER_ID, pool_state).hex()
                                if pool_state is not None else ""),
            "audit_txn_root": ((wroots.get("audit")
                                or audit_ledger.uncommitted_root_hash).hex()
                               if audit_ledger is not None else ""),
        }
        if t_wave is not None and self.metrics is not None:
            self.metrics.add_event(MetricsName.COMMIT_WAVE_TIME,
                                   time.perf_counter() - t_wave)
        return valid, rejected, roots

    def _commit_wave(self):
        """A CommitWave for this drain, or None when the fused path is
        off — no pipeline wired onto the DatabaseManager, or the
        COMMIT_WAVE flag disabled on the pipeline's config."""
        pipe = getattr(self.db, "pipeline", None)
        if pipe is None or not hasattr(pipe, "submit_commitment"):
            return None
        if not getattr(getattr(pipe, "config", None), "COMMIT_WAVE", True):
            return None
        from plenum_tpu_torch.parallel.commit_wave import CommitWave
        return CommitWave(pipe)

    def _resolve_primaries(self, view_no: int) -> list:
        """Primaries the audit txn must snapshot for a batch ORIGINATING in
        view_no. The audit ledger itself is the exact historical record: a
        txn from that view carries the primaries then in force, and a txn
        from an earlier view carries the node registry current at the
        boundary — the round-robin rule over THAT registry reproduces the
        selection every node made, even if membership changed since
        (recomputing over today's validators would desynchronize re-applied
        batches after a view change; audit roots must be reproducible)."""
        audit = self.db.get_ledger(AUDIT_LEDGER_ID)
        if audit is not None:
            from plenum_tpu_torch.execution.handlers.audit import \
                iter_audit_newest_first
            for txn in iter_audit_newest_first(audit, limit=600):
                data = txn_lib.txn_data(txn)
                v = data.get("viewNo", 0)
                if v > view_no:
                    continue
                if v == view_no:
                    return list(data.get("primaries", []))
                node_reg = list(data.get("nodeReg", []))
                count = max(1, len(data.get("primaries", [])))
                if node_reg:
                    return [node_reg[(view_no + i) % len(node_reg)]
                            for i in range(count)]
                break
        # empty audit (the very first batches): round-robin over the current
        # registry — NOT the caller's current primaries, which depend on the
        # caller's view and would desynchronize re-applies after a VC
        reg = sorted(self._node_reg_provider())
        count = max(1, len(self._primaries_provider()))
        if reg:
            return [reg[(view_no + i) % len(reg)] for i in range(count)]
        return self._primaries_provider()

    def apply_committed_txn(self, ledger_id: int, txn: dict,
                            committed: bool = True) -> None:
        """Replay an already-validated committed txn into state (the
        catchup/observer path — no dynamic validation, no audit txn; the
        txn's provenance is the caller's verified ledger transfer)."""
        ver = txn.get("txn", {}).get("ver")     # payload format version
        handler = self._versioned.get((txn_lib.txn_type_of(txn), str(ver))) \
            if ver is not None else None
        if handler is None:
            handler = self._handlers.get(txn_lib.txn_type_of(txn))
        state = self.db.get_state(ledger_id)
        if handler is not None and state is not None:
            handler.update_state(txn, is_committed=committed)
            if committed:
                state.commit(state.head_hash)
        if committed:
            # the ordinary commit path records every txn in the seq-no
            # DB (request dedup / executed-Reply lookup); a txn arriving
            # via catchup must land there too, or the caught-up node
            # NEVER serves dedup replies for it — a client (or a reshard
            # copy cursor) probing that node re-propagates a write the
            # pool already ordered
            seq_no_db = self.db.get_store(SEQ_NO_DB_LABEL)
            pd = txn_lib.txn_payload_digest(txn)
            if seq_no_db is not None and pd and \
                    txn_lib.txn_seq_no(txn) is not None:
                seq_no_db.put(pd.encode(),
                              pack((ledger_id, txn_lib.txn_seq_no(txn),
                                    txn_lib.txn_time(txn))))

    def _last_uncommitted_audit(self, audit_ledger) -> Optional[dict]:
        staged = audit_ledger.uncommitted_txns
        if staged:
            return staged[-1]
        return audit_lib.last_audit_txn(audit_ledger)

    def revert_last_batch(self, ledger_id: int) -> None:
        """Exact inverse of the most recent apply for this ledger."""
        for i in range(len(self._batches) - 1, -1, -1):
            if self._batches[i].ledger_id == ledger_id:
                undo = self._batches.pop(i)
                break
        else:
            raise ValueError(f"no applied batch for ledger {ledger_id}")
        self.db.get_ledger(ledger_id).discard_txns(undo.n_txns)
        audit_ledger = self.db.get_ledger(AUDIT_LEDGER_ID)
        if audit_ledger is not None and audit_ledger.uncommitted_txns:
            audit_ledger.discard_txns(1)
        for lid, root in undo.prev_state_roots.items():
            st = self.db.get_state(lid)
            if st is not None:
                st.revert_to_head(root)

    def commit_batch(self, batch: ThreePcBatch) -> list[dict]:
        """Make the oldest applied batch durable; returns committed txns
        (ref write_request_manager.py:178 + audit/ts batch handlers).

        GROUP COMMIT: the whole durable footprint — ledger txn rows, Merkle
        hash-store rows, trie-node promotion, the audit row, the ts-store
        row, and every seq-no entry — lands inside one group_commit scope:
        one atomic KV batch per store, one flush each, instead of the
        previous interleaved per-row puts across five stores. When the node
        stretches an outer group_commit over several ready batches, this
        inner scope joins it and the flush coalesces further."""
        with self.db.group_commit():
            return self._commit_batch_grouped(batch)

    def _commit_batch_grouped(self, batch: ThreePcBatch) -> list[dict]:
        if not self._batches:
            raise ValueError("commit with no applied batches")
        if self._batches[0].pp_seq_no != batch.pp_seq_no:
            raise ValueError(
                f"commit out of order: oldest applied batch is "
                f"pp_seq_no={self._batches[0].pp_seq_no}, "
                f"got {batch.pp_seq_no}")
        undo = self._batches.pop(0)
        ledger = self.db.get_ledger(undo.ledger_id)
        committed, _ = ledger.commit_txns(undo.n_txns)
        state = self.db.get_state(undo.ledger_id)
        if state is not None:
            state.commit(batch.state_root or None)
        audit_ledger = self.db.get_ledger(AUDIT_LEDGER_ID)
        if audit_ledger is not None and audit_ledger.uncommitted_txns:
            audit_ledger.commit_txns(1)

        # (ledger, ts) -> committed root: powers "state as of time T" reads
        # (ref storage/state_ts_store.py:24 writes keyed by ledger too)
        ts_store = self.db.get_store(TS_STORE_LABEL)
        if ts_store is not None and state is not None:
            ts_store.set(undo.ledger_id, batch.pp_time,
                         state.committed_head_hash)
        seq_no_db = self.db.get_store(SEQ_NO_DB_LABEL)
        if seq_no_db is not None:
            ops = [("put", pd.encode(),
                    pack((undo.ledger_id, txn_lib.txn_seq_no(txn),
                          txn_lib.txn_time(txn))))
                   for txn in committed
                   for pd in (txn_lib.txn_payload_digest(txn),) if pd]
            if ops:
                seq_no_db.do_ops_in_batch(ops)
        for cb in self.on_batch_committed:
            cb(batch, committed)
        return committed

    @property
    def uncommitted_batch_count(self) -> int:
        return len(self._batches)
