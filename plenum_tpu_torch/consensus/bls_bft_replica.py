"""BLS wiring into the 3PC flow: sign state roots at COMMIT, aggregate at
order time, embed the previous batch's multi-sig into the next PRE-PREPARE.

Reference behavior: plenum/bls/bls_bft_replica_plenum.py:21 —
update_pre_prepare :80 / validate_pre_prepare :43 / update_commit :99
(_sign_state :227) / validate_commit :55 / process_commit :144 /
process_order :154 (_calculate_all_multi_sigs :261) — and plenum/bls/
bls_store.py (root-hash → multi-sig KV used by state-proof reads).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.common.node_messages import Commit, PrePrepare
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.serialization import json_dumps, json_loads
from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, BlsCryptoVerifier
from plenum_tpu_torch.crypto.multi_signature import (MultiSignature,
                                                     MultiSignatureValue)
from plenum_tpu_torch.storage.kv_store import KeyValueStorage


class BlsKeyRegister:
    """node name → BLS verkey, sourced from the pool ledger NODE txns
    (ref plenum/bls/bls_key_register_pool_manager.py). Injectable for tests."""

    def __init__(self, keys: Optional[dict[str, str]] = None):
        self._keys: dict[str, str] = dict(keys or {})

    def get_key_by_name(self, node_name: str) -> Optional[str]:
        return self._keys.get(node_name)

    def set_key(self, node_name: str, verkey: Optional[str]) -> None:
        if verkey is None:
            self._keys.pop(node_name, None)
        else:
            self._keys[node_name] = verkey

    def known_nodes(self) -> list[str]:
        return list(self._keys)


class BlsStore:
    """Persistent root-hash → MultiSignature map consulted by state-proof
    reads (ref plenum/bls/bls_store.py)."""

    def __init__(self, kv: KeyValueStorage):
        self._kv = kv

    @property
    def kv(self) -> KeyValueStorage:
        return self._kv

    def put(self, multi_sig: MultiSignature) -> None:
        self._kv.put(multi_sig.value.state_root_hash.encode(),
                     json_dumps(multi_sig.to_list()).encode())

    def get(self, state_root_hash: str) -> Optional[MultiSignature]:
        data = self._kv.try_get(state_root_hash.encode())
        if data is None:
            return None
        return MultiSignature.from_list(json_loads(data))


class BlsBftReplica:
    PPR_NO_BLS_MULTISIG = 0      # benign: previous batch had no quorum yet
    PPR_BLS_MULTISIG_WRONG = 1
    CM_BLS_SIG_WRONG = 2

    def __init__(self,
                 node_name: str,
                 bls_signer: Optional[BlsCryptoSigner],
                 bls_verifier: BlsCryptoVerifier,
                 key_register: BlsKeyRegister,
                 bls_store: Optional[BlsStore] = None,
                 quorums: Optional[Quorums] = None,
                 node_reg_at: Optional[Callable[[str], Optional[list]]] = None,
                 key_at: Optional[Callable[[str, str],
                                           Optional[str]]] = None):
        self._node_name = node_name
        self._signer = bls_signer
        self._verifier = bls_verifier
        self._register = key_register
        self._store = bls_store
        self._quorums = quorums or Quorums(4)
        # pool-state-root -> node registry at that root (audit-ledger
        # lookup, wired by the node): a multi-sig is judged by the quorum
        # rules of the pool size it was CREATED under, not today's
        self._node_reg_at = node_reg_at
        # (name, pool_root_hex) -> BLS verkey at that pool state (historic
        # MPT read): after a key ROTATION the embedded sig from just before
        # the rotation batch verifies only against the OLD key
        self._key_at = key_at
        # (view_no, pp_seq_no) -> {node_name: sig}
        self._sigs: dict[tuple[int, int], dict[str, str]] = {}
        # state_root -> MultiSignature for recently ordered batches
        self._recent_multi_sigs: dict[str, MultiSignature] = {}
        # set by the node: called with the sender of a bad COMMIT signature
        # caught by the order-time per-signature fallback
        self.report_bad_signature: Optional[Callable[[str], None]] = None
        # set by the node: every freshly aggregated multi-sig (including
        # late pending-order retries) is announced so the read plane can
        # advance its signed-root anchor
        self.on_multi_sig: Optional[Callable[[MultiSignature], None]] = None
        # optional MetricsCollector (master instance only): commit-path
        # stage timer + the pairings-per-batch counter the batched-BLS
        # acceptance is judged by
        self.metrics = None
        # multi-sigs we aggregated (and therefore verified) ourselves: in
        # steady state the primary embeds exactly this into the next
        # PRE-PREPARE, so validate_pre_prepare can skip the pairing
        self._verified_ms_keys: dict[tuple, None] = {}
        # ordered batches whose multi-sig fell short of quorum, retried as
        # late COMMITs arrive; and senders whose sig already failed for a key
        self._pending_order: dict[tuple[int, int], PrePrepare] = {}
        self._known_bad: dict[tuple[int, int], set[str]] = {}
        # quorum-complete aggregates that a LATE honest sig may still
        # upgrade: key -> (pre_prepare, participants). Without this a
        # node on a slow WAN link whose COMMIT always lands after the
        # n-f quorum is permanently absent from every multi-sig this
        # node emits (and a just-re-keyed node never visibly rejoins)
        self._aggregated: dict[tuple[int, int],
                               tuple[PrePrepare, tuple]] = {}

    def set_quorums(self, quorums: Quorums) -> None:
        self._quorums = quorums

    # --- signed payload ---------------------------------------------------

    @staticmethod
    def _signed_value(pre_prepare: PrePrepare) -> MultiSignatureValue:
        return MultiSignatureValue(
            ledger_id=pre_prepare.ledger_id,
            state_root_hash=pre_prepare.state_root,
            pool_state_root_hash=pre_prepare.pool_state_root,
            txn_root_hash=pre_prepare.txn_root,
            timestamp=pre_prepare.pp_time)

    # --- PRE-PREPARE ------------------------------------------------------

    def update_pre_prepare(self, params: dict, state_root: str) -> dict:
        """Attach the previous batch's aggregated multi-sig (by state root)."""
        ms = self._recent_multi_sigs.get(state_root)
        if ms is not None:
            params["bls_multi_sig"] = tuple(ms.to_list())
        return params

    def validate_pre_prepare(self, pre_prepare: PrePrepare, sender: str) -> Optional[int]:
        if pre_prepare.bls_multi_sig is None:
            return None
        try:
            ms = MultiSignature.from_list(list(pre_prepare.bls_multi_sig))
        except (ValueError, TypeError, IndexError, KeyError):
            return self.PPR_BLS_MULTISIG_WRONG
        # Participants must be DISTINCT registered validators: aggregation is
        # plain point addition, so one colluding node's signature repeated
        # n-f times would otherwise verify as a quorum multi-sig (rogue
        # self-aggregation).
        if len(set(ms.participants)) != len(ms.participants):
            return self.PPR_BLS_MULTISIG_WRONG
        # A multi-sig we aggregated (or fully verified) OURSELVES passed the
        # quorum rules in force when it was created. This shortcut must come
        # BEFORE the current-quorum check: the first PRE-PREPARE after a pool
        # membership change legitimately embeds the previous batch's sig,
        # whose participant count satisfies the OLD n - f, not the new one —
        # re-judging it with the new quorums would mark every honest primary
        # suspicious and storm view changes on every pool growth.
        if self._ms_key(ms) in self._verified_ms_keys:
            return None
        # keys AND quorum AS OF the sig's cited pool state — the same
        # epoch resolution process_order aggregates under, so an honest
        # aggregate passes here BY CONSTRUCTION (each node's aggregate can
        # pick a different participant subset, so the self-verified
        # shortcut alone cannot cover membership changes)
        key_of, reg, quorums = self._epoch_of(ms.value.pool_state_root_hash)
        vk_of = {n: key_of(n) for n in ms.participants}
        if any(v is None for v in vk_of.values()):
            return self.PPR_BLS_MULTISIG_WRONG
        if reg is not None and not set(ms.participants) <= set(reg):
            return self.PPR_BLS_MULTISIG_WRONG
        if not quorums.bls_signatures.is_reached(len(ms.participants)):
            return self.PPR_BLS_MULTISIG_WRONG
        ok = self._verifier.verify_multi_sig(ms.signature,
                                             ms.value.as_single_value(),
                                             [vk_of[n] for n in
                                              ms.participants])
        self._drop_stale_points(vk_of)
        if not ok:
            return self.PPR_BLS_MULTISIG_WRONG
        self._remember_verified(ms)
        return None

    # --- COMMIT -----------------------------------------------------------

    def update_commit(self, params: dict, pre_prepare: PrePrepare) -> dict:
        if self._signer is not None:
            value = self._signed_value(pre_prepare)
            params["bls_sig"] = self._signer.sign(value.as_single_value())
        return params

    def validate_commit(self, commit: Commit, sender_node: str,
                        pre_prepare: PrePrepare) -> Optional[int]:
        """DEFERRED verification: only the cheap structural check happens per
        COMMIT. The ~74x more expensive pairing runs ONCE per batch when the
        commit quorum forms, as a random-linear-combination batch check with
        per-signature fallback to evict liars (process_order) — per-commit
        pairings were the dominant term in pool TPS (one pairing per peer
        COMMIT per batch per node)."""
        if commit.bls_sig is None:
            return None
        if not self._verifier.is_wellformed_sig(commit.bls_sig):
            return self.CM_BLS_SIG_WRONG
        return None

    def process_commit(self, commit: Commit, sender_node: str) -> None:
        if commit.bls_sig is None:
            return
        key = (commit.view_no, commit.pp_seq_no)
        self._sigs.setdefault(key, {})[sender_node] = commit.bls_sig
        # A batch can order before every honest COMMIT arrives; if its
        # multi-sig aggregation fell short of quorum (e.g. one bad signature
        # evicted by the bisection), late honest sigs must retry it — or a
        # single Byzantine racer could suppress multi-sigs forever.
        pending = self._pending_order.get(key)
        if pending is not None:
            self.process_order(key, pending)
            return
        # late sig for an already-aggregated batch: re-aggregate so the
        # sender joins the multi-sig (verdicts of the existing members
        # ride the process-wide cache — the upgrade prices one combined
        # check of the new sig, not n pairings)
        agg = self._aggregated.get(key)
        if agg is not None and sender_node not in agg[1]:
            self.process_order(key, agg[0])

    # --- order ------------------------------------------------------------

    def process_order(self, key: tuple[int, int],
                      pre_prepare: PrePrepare) -> Optional[MultiSignature]:
        # Aggregate under the keys and quorum of the EPOCH the sig value
        # cites (the pre-prepare's pool state root), not the node's current
        # register: around a rotation or demotion the two differ, and every
        # validator judging the embedded aggregate re-derives the CITED
        # epoch (validate_pre_prepare) — an aggregate judged by current
        # membership would fail on every honest peer and storm view changes
        # (churn-soak waves: 3-participant sigs citing a 5-node root, and
        # stale-register aggregates spanning a rotation window).
        key_of, _reg, quorums = self._epoch_of(pre_prepare.pool_state_root)
        # one historic-epoch key resolution per signer per call: _key_at
        # is a historic pool-state read, and this path re-runs on every
        # late COMMIT
        vk_of = {n: key_of(n) for n in self._sigs.get(key, {})}
        sigs = {n: s for n, s in self._sigs.get(key, {}).items()
                if vk_of[n] is not None
                and n not in self._known_bad.get(key, set())}
        if not quorums.bls_signatures.is_reached(len(sigs)):
            self._pending_order[key] = pre_prepare      # retry on late sigs
            return None
        value = self._signed_value(pre_prepare).as_single_value()
        t0 = time.perf_counter()
        from plenum_tpu_torch.crypto.bn254 import PAIRING_STATS
        pairings_before = PAIRING_STATS["pairings"]
        good, bad = self._batch_verify_commits(sigs, value, vk_of)
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.COMMIT_BLS_VERIFY_TIME,
                                   time.perf_counter() - t0)
            self.metrics.add_event(MetricsName.BLS_PAIRINGS_PER_BATCH,
                                   PAIRING_STATS["pairings"] - pairings_before)
        for sender in bad:
            self._known_bad.setdefault(key, set()).add(sender)
            if self.report_bad_signature is not None:
                self.report_bad_signature(sender)
        if not quorums.bls_signatures.is_reached(len(good)):
            self._pending_order[key] = pre_prepare      # retry on late sigs
            return None
        self._pending_order.pop(key, None)
        participants = tuple(sorted(good))
        prev = self._aggregated.get(key)
        if prev is not None and set(participants) <= set(prev[1]):
            return None         # no new honest signer: keep the aggregate
        agg = self._verifier.create_multi_sig([good[n] for n in participants])
        ms = MultiSignature(signature=agg, participants=participants,
                            value=self._signed_value(pre_prepare))
        self._remember_verified(ms)
        self._recent_multi_sigs[pre_prepare.state_root] = ms
        if len(self._recent_multi_sigs) > 10:
            oldest = next(iter(self._recent_multi_sigs))
            del self._recent_multi_sigs[oldest]
        self._aggregated.pop(key, None)     # re-insert newest-last
        self._aggregated[key] = (pre_prepare, participants)
        while len(self._aggregated) > 10:
            del self._aggregated[next(iter(self._aggregated))]
        if self._store is not None:
            self._store.put(ms)
        if self.on_multi_sig is not None:
            self.on_multi_sig(ms)
        return ms

    def _epoch_of(self, pool_root: str):
        """-> (key_of, reg, quorums) AS OF `pool_root` — the epoch a
        multi-sig value cites. Unresolvable history falls back to the
        current register/quorums. Aggregation (process_order) and
        validation (validate_pre_prepare) MUST share this resolution:
        any divergence makes honest aggregates look forged."""
        quorums = self._quorums
        reg = None
        if self._node_reg_at is not None:
            reg = self._node_reg_at(pool_root) or None
            if reg:
                quorums = Quorums(len(reg))

        def key_of(n: str) -> Optional[str]:
            vk = self._key_at(n, pool_root) \
                if self._key_at is not None else None
            return vk or self._register.get_key_by_name(n)
        return key_of, reg, quorums

    def _batch_verify_commits(self, sigs: dict[str, str], value: bytes,
                              vk_of: dict[str, Optional[str]]) \
            -> tuple[dict[str, str], list[str]]:
        """Validate the whole COMMIT set with ONE random-linear-combination
        pairing check (crypto.bls.BlsCryptoVerifier.batch_verify): every
        signer signs the same ordered-batch value, so the combined check
        costs 2 pairings regardless of pool size — amortized O(1) vs the
        Θ(n) independent 2-pairing checks of per-Commit verification. On
        failure the verifier falls back to per-signature checks, which name
        the culprit(s) exactly (no subset bisection: plain-aggregation
        subsets can be satisfied by error-cancelling signature pairs, the
        RLC cannot)."""
        names = sorted(sigs)
        items = [(sigs[n], value, vk_of[n]) for n in names]
        oks = self._verifier.batch_verify(items)
        self._drop_stale_points(vk_of)
        good = {n: sigs[n] for n, ok in zip(names, oks) if ok}
        bad = [n for n, ok in zip(names, oks) if not ok]
        return good, bad

    def _drop_stale_points(self, vk_of: dict[str, Optional[str]]) -> None:
        """A historic-epoch verify (a batch citing a pre-rotation pool
        root) legitimately decodes the rotated-OUT key — but it must not
        stay warm in the key table past the check, or the eviction
        contract node._on_pool_changed enforces is undone by the next
        in-flight batch."""
        for n, vk in vk_of.items():
            if vk is not None and vk != self._register.get_key_by_name(n):
                self._verifier.evict_key(vk)

    @staticmethod
    def _ms_key(ms: MultiSignature) -> tuple:
        return (ms.signature, tuple(ms.participants),
                ms.value.as_single_value())

    def _remember_verified(self, ms: MultiSignature) -> None:
        self._verified_ms_keys[self._ms_key(ms)] = None
        while len(self._verified_ms_keys) > 50:
            del self._verified_ms_keys[next(iter(self._verified_ms_keys))]

    def gc(self, stable_3pc: tuple[int, int]) -> None:
        self._sigs = {k: v for k, v in self._sigs.items() if k > stable_3pc}
        self._pending_order = {k: v for k, v in self._pending_order.items()
                               if k > stable_3pc}
        self._known_bad = {k: v for k, v in self._known_bad.items()
                           if k > stable_3pc}
        self._aggregated = {k: v for k, v in self._aggregated.items()
                            if k > stable_3pc}
