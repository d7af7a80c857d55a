"""Proof-carrying cross-shard writes: a fail-closed two-phase protocol.

PR 10 composed cross-shard READS from two proofs checked against local
trust roots. This module extends the same discipline to WRITES that span
two shards — a home-shard write conditioned on (and paired with) state a
REMOTE shard owns — without any new signature machinery: the
committee-anchor argument ("Performance of EdDSA and BLS Signatures in
Committee-Based Consensus", PAPERS.md) is what makes a single
BLS-anchored remote read proof a sufficient lock witness, so every
phase's evidence is an ordinary verified read envelope.

Protocol (coordinator = the home shard's side, participant = remote):

1. **witness** — the coordinator performs a composed verified read of
   the remote dependency (ownership proof + the remote shard's
   BLS-anchored read proof). This envelope IS the lock witness.
2. **prepare** — the coordinator ORDERS a prepare record in its own
   shard carrying the intent, the witness envelope, and the mapping
   epoch it was minted under. The record is an ordinary domain write
   (an ATTRIB on the shard's 2PC anchor DID), so it is multi-signed,
   replayable, and provable like any other state.
3. **lock** — the participant checks the intent fail-closed (current
   mapping epoch, own range ownership, witness verifies against ITS
   trust roots) and orders a lock record in its shard. The coordinator
   then takes the **anchored prepare ack**: a composed verified read
   of that lock record — a BLS-anchored proof the remote shard locked.
4. **commit** — only on an anchored ack, inside the prepare TTL, and
   only if the mapping epoch is UNCHANGED, the coordinator orders the
   decision record ("commit") followed by the home write; the
   participant applies its half on the decision. Any other outcome —
   epoch ratcheted mid-flight, ack timeout, refused prepare, partition
   — orders an "abort" decision instead. No half-commits: the decision
   record is the single commit point both sides converge on.

Failure resolution is proof-carrying too: a participant whose lock TTL
expires resolves by a VERIFIED read of the coordinator's decision
record — applies on a proven commit, releases on a proven abort, and on
a proven ABSENCE past the TTL aborts fail-closed (safe because the
coordinator refuses to order a commit past ``XSW_PREPARE_TTL``, and
``XSW_LOCK_TTL`` comfortably exceeds it). A crashed coordinator is
recovered from its shard's LEDGER (``recover_from_ledger``): prepare
records without a decision past the TTL get an abort decision ordered;
a commit decision without its home write gets the write replayed —
atomicity never rests on the coordinator process surviving.
"""
from __future__ import annotations

import json
from typing import Optional

from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.txn import ATTRIB, GET_ATTR, NYM

from . import mapping as mapping_lib
from .read_client import CrossShardReadCheck

RECORD_PREFIX = "xsw."

# coordinator transaction states
INIT = "init"
PREPARED = "prepared"
LOCKED = "locked"
COMMITTED = "committed"
ABORTED = "aborted"


def record_name(txid: str, label: str) -> str:
    return f"{RECORD_PREFIX}{txid}.{label}"


class _Lock:
    __slots__ = ("txid", "dep_key", "deadline", "epoch", "intent")

    def __init__(self, txid, dep_key, deadline, epoch, intent):
        self.txid = txid
        self.dep_key = dep_key
        self.deadline = deadline
        self.epoch = epoch
        self.intent = intent


class _Tx:
    def __init__(self, txid: str, intent: dict):
        self.txid = txid
        self.intent = intent
        self.state = INIT
        self.witness: Optional[dict] = None
        self.prepare_deadline: Optional[float] = None
        self.abort_reason: Optional[str] = None
        # True once a commit decision was SUBMITTED whose ordering fate
        # is unknown — recovery must defer to the ledger, not race it
        self.decision_submitted = False


class CrossWriteParticipant:
    """The remote shard's half (the in-process twin of its nodes' 2PC
    logic, exactly as ShardReadGate twins their proof decoration)."""

    def __init__(self, xsw: "CrossShardWrites", sid: int):
        self.xsw = xsw
        self.sid = sid
        self.locks: dict[str, _Lock] = {}        # dep key hex -> lock
        # TTL-aborted transactions are tombstoned (intent, grace
        # deadline, next poll time): if the coordinator's commit
        # decision surfaces late (ordered behind a partition that has
        # since healed), the remote half still applies — both sides
        # converge on the ledger's decision, never on who answered a
        # poll first
        self._tombstones: dict[str, tuple[dict, float, float]] = {}
        self._applied_txids: set[str] = set()
        self.stats = {"locked": 0, "refused": {}, "applied": 0,
                      "released": 0, "resolved_aborts": 0,
                      "resolution_retries": 0, "late_commits": 0}

    def _refuse(self, reason: str) -> tuple[bool, str]:
        self.stats["refused"][reason] = \
            self.stats["refused"].get(reason, 0) + 1
        return False, reason

    def handle_prepare(self, txid: str, intent: dict,
                       witness: dict) -> tuple[bool, str]:
        """Fail-closed lock admission; orders the lock record on this
        shard when every check passes."""
        fab = self.xsw.fabric
        if intent.get("epoch") != fab.mapping.epoch:
            return self._refuse("stale_epoch")
        dep_op = intent["dep_op"]
        try:
            key = mapping_lib.routing_key(dep_op)
        except ValueError:
            return self._refuse("unroutable_dep")
        point = mapping_lib.key_point(key)
        mine = next((d for d in fab.mapping.descriptors
                     if d.shard_id == self.sid), None)
        if mine is None or not mine.owns_point(point):
            return self._refuse("wrong_shard")
        ok, why = self._check_witness(intent, witness)
        if not ok:
            return self._refuse(f"bad_witness:{why}")
        if point in self.locks:
            return self._refuse("locked")
        rec = self.xsw._order_record(
            self.sid, txid, "lock",
            {"epoch": intent["epoch"], "dep": dep_op})
        if rec is None:
            return self._refuse("lock_order_timeout")
        ttl = getattr(fab.config, "XSW_LOCK_TTL", 20.0)
        self.locks[point] = _Lock(txid, point,
                                  fab.timer.get_current_time() + ttl,
                                  intent["epoch"], intent)
        self.stats["locked"] += 1
        return True, "ok"

    def _check_witness(self, intent: dict, witness: dict
                       ) -> tuple[bool, str]:
        """The lock witness is an ordinary composed read envelope; the
        participant judges it from its OWN trust roots (directory keys +
        the proven descriptor's BLS keys), never the coordinator's
        say-so."""
        fab = self.xsw.fabric
        if not isinstance(witness, dict):
            return False, "no_witness"
        checker = CrossShardReadCheck(
            fab.mapping.directory_keys,
            n_directory=len(fab.directory),
            freshness_s=1e12, now=fab.timer.get_current_time,
            min_epoch=intent.get("epoch", 0))
        query = Request(witness.get("identifier", "xsw"),
                        witness.get("reqId", 0), intent["dep_op"])
        return checker.check(query, witness.get("result") or {})

    def handle_commit(self, txid: str) -> bool:
        """Apply this shard's half on the coordinator's decision."""
        lock = self._lock_of(txid)
        if lock is None:
            return False
        self._apply(lock)
        return True

    def handle_abort(self, txid: str) -> None:
        lock = self._lock_of(txid)
        if lock is not None:
            del self.locks[lock.dep_key]
            self.stats["released"] += 1

    def service(self) -> None:
        """Expired locks resolve by a VERIFIED read of the coordinator's
        decision record — never by trusting a message, never by waiting
        forever. Call from top level (it pumps the fabric).

        'Unreachable' and 'proven absence' are DIFFERENT verdicts: when
        the home shard cannot be read at all (partition — no verified
        reply on any rung), the lock is retried later, never released;
        only a VERIFIED absence past the TTL aborts (safe: the
        coordinator refuses to start ordering a commit without the full
        ordering budget inside its shorter prepare TTL). TTL-aborted
        transactions stay tombstoned for a grace window so a commit
        decision surfacing later still applies the remote half."""
        fab = self.xsw.fabric
        now = fab.timer.get_current_time()
        for lock in [l for l in self.locks.values() if now >= l.deadline]:
            decision, proven = self.xsw._read_decision(lock.intent,
                                                       lock.txid)
            if decision == "commit":
                self._apply(lock)
            elif not proven:
                # home shard unreachable: releasing here would turn a
                # partition into a unilateral abort racing a durable
                # commit — keep the lock and re-resolve after a backoff
                lock.deadline = now + max(
                    1.0, getattr(fab.config, "XSW_LOCK_TTL", 20.0) / 4)
                self.stats["resolution_retries"] += 1
            else:
                # a proven abort, or a PROVEN ABSENCE past the lock TTL:
                # abort fail-closed, tombstoned against a late decision
                del self.locks[lock.dep_key]
                self.stats["released"] += 1
                self.stats["resolved_aborts"] += 1
                grace = 2 * getattr(fab.config, "XSW_LOCK_TTL", 20.0)
                self._tombstones[lock.txid] = (lock.intent, now + grace,
                                               now)
        # tombstone sweep: a late-surfacing commit decision still
        # converges the remote half (applied at most once). Each
        # tombstone re-polls on a backoff, not every tick — a verified
        # read pumps the whole fabric and decisions rarely change.
        poll_every = max(1.0, getattr(fab.config, "XSW_LOCK_TTL",
                                      20.0) / 4)
        for txid in list(self._tombstones):
            intent, until, next_poll = self._tombstones[txid]
            if now < next_poll:
                continue
            decision, proven = self.xsw._read_decision(intent, txid)
            if decision == "commit":
                del self._tombstones[txid]
                if txid not in self._applied_txids:
                    self._apply_intent(txid, intent)
                    self.stats["late_commits"] += 1
            elif decision == "abort" or now >= until:
                del self._tombstones[txid]
            else:
                self._tombstones[txid] = (intent, until,
                                          now + poll_every)

    def _apply(self, lock: _Lock) -> None:
        self.locks.pop(lock.dep_key, None)
        self._apply_intent(lock.txid, lock.intent)

    def _apply_intent(self, txid: str, intent: dict) -> None:
        if txid in self._applied_txids:
            return
        self._applied_txids.add(txid)
        remote_write = intent.get("remote_write")
        if remote_write is not None:
            self.xsw._order_signed(remote_write, f"xsw-{txid}")
        self.stats["applied"] += 1

    def _lock_of(self, txid: str) -> Optional[_Lock]:
        return next((l for l in self.locks.values() if l.txid == txid),
                    None)


class CrossShardWrites:
    """Coordinator-side manager; one per fabric (``fab.cross_writes()``).

    Drive a transaction with ``step``/``drive``; fault-inject by simply
    not calling the next step (a crashed coordinator) and then running
    ``recover_from_ledger`` / the participant's ``service``.
    """

    def __init__(self, fabric):
        self.fabric = fabric
        self.txs: dict[str, _Tx] = {}
        self.participants: dict[int, CrossWriteParticipant] = {}
        self._anchors: dict[int, Ed25519Signer] = {}
        self._req_id = 5_000_000
        self._n = 0
        # ONE read driver per mapping epoch: its checker memoizes the
        # directory + shard anchor pairings, so the 2PC's verified
        # reads pay the multi-sig check once per anchor, not per read
        self._driver = None
        self._driver_epoch: Optional[int] = None
        self.stats = {"begun": 0, "committed": 0, "aborted": 0}

    # --- public API ---------------------------------------------------------

    def participant(self, sid: int) -> CrossWriteParticipant:
        if sid not in self.participants:
            self.participants[sid] = CrossWriteParticipant(self, sid)
        return self.participants[sid]

    def begin(self, home_sid: int, remote_sid: int, home_write: dict,
              dep_op: dict, remote_write: Optional[dict] = None) -> str:
        """-> txid. `home_write`/`remote_write` are operation dicts
        (signed by the trustee at apply time); `dep_op` is the remote
        read the write depends on (e.g. {"type": GET_NYM, "dest": d})."""
        import hashlib
        self._n += 1
        tag = hashlib.sha256(
            json.dumps(dep_op, sort_keys=True).encode()).hexdigest()[:8]
        txid = f"{self._n}-{tag}"
        self.txs[txid] = _Tx(txid, {
            "txid": txid, "home": home_sid, "remote": remote_sid,
            "epoch": self.fabric.mapping.epoch,
            "home_write": home_write, "remote_write": remote_write,
            "dep_op": dep_op})
        self.stats["begun"] += 1
        self.fabric.metrics.add_event(MetricsName.XSW_BEGUN)
        return txid

    def step(self, txid: str) -> str:
        """Advance one phase; -> the new state. Blocking within a phase
        (pumps the fabric), so call from top level only."""
        tx = self.txs[txid]
        if tx.state == INIT:
            self._step_prepare(tx)
        elif tx.state == PREPARED:
            self._step_lock(tx)
        elif tx.state == LOCKED:
            self._step_commit(tx)
        return tx.state

    def drive(self, txid: str) -> str:
        while self.txs[txid].state not in (COMMITTED, ABORTED):
            self.step(txid)
        return self.txs[txid].state

    def recover_from_ledger(self, home_sid: int) -> dict:
        """Crash recovery from durable state alone: scan the home
        shard's ledger for 2PC records; prepares past TTL with no
        decision get an ABORT decision ordered; a commit decision whose
        home write never landed gets the write replayed."""
        now = self.fabric.timer.get_current_time()
        ttl = getattr(self.fabric.config, "XSW_PREPARE_TTL", 8.0)
        records = self._scan_records(home_sid)
        out = {"aborted": [], "completed": []}
        for txid, recs in sorted(records.items()):
            prep = recs.get("prepare")
            if prep is None or "decision" in recs:
                decision = (recs.get("decision") or {}).get("decision")
                if decision == "commit":
                    intent = (prep or {}).get("intent") or {}
                    if intent.get("home_write") and not self._applied(
                            home_sid, intent["home_write"], txid):
                        self._order_signed(intent["home_write"],
                                           f"xsw-{txid}")
                        out["completed"].append(txid)
                continue
            if now - prep.get("t", now) < ttl:
                continue
            self._order_record(home_sid, txid, "decision",
                               {"decision": "abort",
                                "reason": "recovery_timeout"})
            out["aborted"].append(txid)
            tx = self.txs.get(txid)
            if tx is not None and tx.state not in (COMMITTED, ABORTED):
                self._finish_abort(tx, "recovery_timeout",
                                   decision_ordered=True)
        return out

    def summary(self) -> dict:
        out = dict(self.stats)
        out["participants"] = {
            sid: dict(p.stats, live_locks=len(p.locks))
            for sid, p in sorted(self.participants.items())}
        return out

    # --- phases -------------------------------------------------------------

    def _step_prepare(self, tx: _Tx) -> None:
        intent = tx.intent
        if intent["epoch"] != self.fabric.mapping.epoch:
            self._finish_abort(tx, "epoch_changed")     # nothing ordered yet
            return
        witness = self._read_witness(intent)
        if witness is None:
            self._finish_abort(tx, "witness_unavailable")
            return
        tx.witness = witness
        rec = self._order_record(
            intent["home"], tx.txid, "prepare",
            {"intent": intent, "witness": witness,
             "t": self.fabric.timer.get_current_time()})
        if rec is None:
            self._finish_abort(tx, "prepare_order_timeout")
            return
        tx.prepare_deadline = self.fabric.timer.get_current_time() + \
            getattr(self.fabric.config, "XSW_PREPARE_TTL", 8.0)
        tx.state = PREPARED

    def _step_lock(self, tx: _Tx) -> None:
        intent = tx.intent
        ok, why = self.participant(intent["remote"]).handle_prepare(
            tx.txid, intent, tx.witness)
        if not ok:
            self._abort(tx, f"prepare_refused:{why}")
            return
        # the ANCHORED prepare ack: a composed verified read of the lock
        # record from the remote shard — proof it ordered the lock
        anchor = self._anchor_did(intent["remote"])
        _q, res = self._verified_read({
            "type": GET_ATTR, "dest": anchor,
            "attr_name": record_name(tx.txid, "lock")}, "xsw-ack",
            want_data=True)
        if res is None or not res.get("data"):
            self._abort(tx, "ack_unanchored")
            return
        tx.state = LOCKED

    # a commit decision is only SUBMITTED when at least this much of
    # the prepare TTL remains — the ordering budget must fit INSIDE the
    # TTL, which is what makes the participant's verified-absence abort
    # (at the longer lock TTL) safe against an in-flight commit
    COMMIT_MIN_BUDGET = 2.0

    def _step_commit(self, tx: _Tx) -> None:
        intent = tx.intent
        now = self.fabric.timer.get_current_time()
        if intent["epoch"] != self.fabric.mapping.epoch:
            # the map moved under the transaction: the ownership its
            # witness and lock were judged against is superseded
            # (checked FIRST — an epoch abort names the real cause even
            # when the reshard also outran the prepare TTL)
            self._abort(tx, "epoch_changed")
            return
        budget = (tx.prepare_deadline or 0.0) - now
        if budget < self.COMMIT_MIN_BUDGET:
            self._abort(tx, "prepare_ttl_expired")
            return
        rec = self._order_record(intent["home"], tx.txid, "decision",
                                 {"decision": "commit"}, timeout=budget)
        if rec is None:
            # the decision was SUBMITTED but did not order inside the
            # budget: the outcome is whatever the ledger eventually
            # says — ordering a competing abort here could produce two
            # decisions. Fail the transaction locally WITHOUT a second
            # decision record; recovery + the participant's tombstone
            # sweep converge on the ledger's (first) decision.
            tx.decision_submitted = True
            self._finish_abort(tx, "commit_unresolved")
            return
        if not self._order_signed(intent["home_write"], f"xsw-{tx.txid}"):
            # the decision IS durably committed — the home write just
            # failed to order within budget. Surface it loudly; the
            # ledger recovery path replays it from the durable intent
            # (content-matched, so the replay is idempotent).
            self.stats["home_write_pending"] = \
                self.stats.get("home_write_pending", 0) + 1
        self.participant(intent["remote"]).handle_commit(tx.txid)
        tx.state = COMMITTED
        self.stats["committed"] += 1
        self.fabric.metrics.add_event(MetricsName.XSW_COMMITS)

    def _abort(self, tx: _Tx, reason: str) -> None:
        """Order the abort decision at home (the durable outcome a
        partitioned participant later resolves against), release the
        remote lock best-effort, finish."""
        self._order_record(tx.intent["home"], tx.txid, "decision",
                           {"decision": "abort", "reason": reason})
        self.participant(tx.intent["remote"]).handle_abort(tx.txid)
        self._finish_abort(tx, reason, decision_ordered=True)

    def _finish_abort(self, tx: _Tx, reason: str,
                      decision_ordered: bool = False) -> None:
        tx.state = ABORTED
        tx.abort_reason = reason
        self.stats["aborted"] += 1
        self.fabric.metrics.add_event(MetricsName.XSW_ABORTS)

    # --- reads ---------------------------------------------------------------

    def _verified_read(self, operation: dict, client_tag: str,
                       attempts: int = 4, want_data: bool = False
                       ) -> tuple[Request, Optional[dict]]:
        """A composed verified read with bounded retry over anchor lag:
        a shard that JUST ordered a txn may answer proofless (its BLS
        anchor still aggregating) or serve a VERIFIED ABSENCE at the
        previous anchored root — both mean 'not yet anchored', not a
        refusal. `want_data` retries the verified-absence case too (the
        ack read: the lock is known ordered, only its anchor can lag)."""
        epoch = self.fabric.mapping.epoch
        if self._driver is None or self._driver_epoch != epoch:
            self._driver = self.fabric.read_driver()
            self._driver_epoch = epoch
        q = None
        last = None
        for i in range(attempts):
            q = Request(client_tag, self._next_req_id(), operation)
            res = self._driver.read(q, per_node_s=2.0, step_s=0.1)
            if res is not None:
                last = res
                if res.get("data") or not want_data:
                    return q, res
            if i + 1 < attempts:
                self.fabric.run(1.5)
        return q, last

    def _read_witness(self, intent: dict) -> Optional[dict]:
        q, res = self._verified_read(intent["dep_op"], "xsw-wit")
        if res is None:
            return None
        return {"identifier": q.identifier, "reqId": q.req_id,
                "result": res}

    def _read_decision(self, intent: dict, txid: str
                       ) -> tuple[Optional[str], bool]:
        """-> (decision, proven). proven=False means the home shard was
        UNREACHABLE (no verified reply at all) — callers must treat
        that as 'unknown', never as an absence they may abort on."""
        anchor = self._anchor_did(intent["home"])
        _q, res = self._verified_read({
            "type": GET_ATTR, "dest": anchor,
            "attr_name": record_name(txid, "decision")}, "xsw-dec",
            attempts=2)
        if res is None:
            return None, False            # unreachable: unknown outcome
        if not res.get("data"):
            return None, True             # VERIFIED absence
        try:
            payload = json.loads(res["data"])
            return payload[record_name(txid, "decision")]["decision"], True
        except Exception:
            return None, True

    # --- record plumbing ------------------------------------------------------

    def _anchor_did(self, sid: int) -> str:
        return self._anchor(sid).identifier

    def _anchor(self, sid: int) -> Ed25519Signer:
        """Each shard holds a 2PC anchor DID (mined into its key range,
        NYM'd once) that all its xsw records attach to as ATTRIBs."""
        signer = self._anchors.get(sid)
        if signer is not None:
            return signer
        fab = self.fabric
        desc = next(d for d in fab.mapping.descriptors
                    if d.shard_id == sid)
        for i in range(2000):
            cand = Ed25519Signer(
                seed=(b"xsw-anchor-%d-%d" % (sid, i))
                .ljust(32, b"\0")[:32])
            if desc.owns_point(mapping_lib.key_point(
                    cand.identifier.encode())):
                break
        else:
            raise AssertionError(f"no anchor DID found for shard {sid}")
        self._order_signed({"type": NYM, "dest": cand.identifier,
                            "verkey": cand.verkey_b58}, f"xsw-anchor-{sid}")
        self._anchors[sid] = cand
        return cand

    def _order_record(self, sid: int, txid: str, label: str,
                      payload: dict, timeout: float = 20.0
                      ) -> Optional[dict]:
        """Order an xsw record as an ATTRIB on the shard's anchor DID;
        -> the payload once ordered, None on timeout."""
        raw = json.dumps({record_name(txid, label): payload},
                         sort_keys=True)
        op = {"type": ATTRIB, "dest": self._anchor_did(sid), "raw": raw}
        return payload if self._order_signed(op, f"xsw-{txid}",
                                             timeout=timeout) else None

    def _order_signed(self, operation: dict, frm: str,
                      timeout: float = 20.0) -> bool:
        """Sign (trustee), route, and pump until ordered on the owning
        shard — the one blocking primitive every phase rides."""
        fab = self.fabric
        req = Request(fab.trustee.identifier, self._next_req_id(),
                      dict(operation))
        req.signature = fab.trustee.sign_b58(req.signing_bytes())
        sid = fab.router.shard_of(req)
        if sid is None or fab.submit_write(req, frm=frm) is None:
            return False
        shard = fab.shards.get(sid)
        if shard is None:
            return False
        node = next(iter(shard.nodes.values()))
        waited = 0.0
        while waited < timeout:
            if node._executed_txn(req) is not None:
                return True
            fab.run(0.5)
            waited += 0.5
        return node._executed_txn(req) is not None

    def _scan_records(self, sid: int) -> dict[str, dict]:
        """Walk the shard's domain ledger for xsw records;
        -> {txid: {label: payload}} — the durable 2PC state recovery
        judges from (no in-memory table survives a coordinator crash)."""
        fab = self.fabric
        shard = fab.shards.get(sid) or fab.retired.get(sid)
        node = next(iter(shard.nodes.values()))
        ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
        out: dict[str, dict] = {}
        for seq in range(2, ledger.size + 1):
            txn = ledger.get_by_seq_no(seq)
            if txn_lib.txn_type_of(txn) != ATTRIB:
                continue
            raw = txn_lib.txn_data(txn).get("raw")
            if not raw or RECORD_PREFIX not in raw:
                continue
            try:
                parsed = json.loads(raw)
                (name, payload), = parsed.items()
            except (ValueError, AttributeError):
                continue
            if not name.startswith(RECORD_PREFIX):
                continue
            txid, _, label = name[len(RECORD_PREFIX):].rpartition(".")
            if txid:
                # FIRST-wins: ledger order is the canonical tiebreak —
                # should a late commit and a recovery abort both land,
                # the earlier record IS the decision
                out.setdefault(txid, {}).setdefault(label, payload)
        return out

    # the operation fields that identify a write's CONTENT (each re-sign
    # gets a fresh reqId, so payload digests cannot match across
    # recovery replays — content equality is the idempotence key)
    _CONTENT_FIELDS = ("dest", "verkey", "role", "alias",
                       "raw", "enc", "hash")

    def _applied(self, sid: int, operation: dict, txid: str) -> bool:
        """Has a write with THIS content already ordered? Matching on
        (dest, type) alone would let any older unrelated txn on the
        same DID satisfy the check and silently skip a recovery replay
        — a permanent half-commit."""
        fab = self.fabric
        shard = fab.shards.get(sid)
        if shard is None:
            return False
        want = {k: operation[k] for k in self._CONTENT_FIELDS
                if k in operation}
        node = next(iter(shard.nodes.values()))
        ledger = node.c.db.get_ledger(DOMAIN_LEDGER_ID)
        for seq in range(ledger.size, 1, -1):
            txn = ledger.get_by_seq_no(seq)
            if txn_lib.txn_type_of(txn) != operation.get("type"):
                continue
            data = txn_lib.txn_data(txn)
            if all(data.get(k) == v for k, v in want.items()):
                return True
        return False

    def _next_req_id(self) -> int:
        self._req_id += 1
        return self._req_id
