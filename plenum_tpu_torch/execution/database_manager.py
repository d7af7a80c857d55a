"""Registry of ledgers, states, and named stores.

Reference behavior: plenum/server/database_manager.py:11 — one place mapping
ledger_id -> (ledger, state) plus named specialty stores (BLS store :112,
ts store :116, idr cache :120). Handlers and batch handlers reach storage only
through this registry, which is what lets tests swap in-memory stores and the
node bootstrap wire real ones.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager
from typing import Iterable, Iterator, Optional

from plenum_tpu_torch.ledger.ledger import Ledger
# any StateCommitment backend (state/commitment/); PruningState is the
# default — the annotation names the interface shape, not the class
from plenum_tpu_torch.state.pruning_state import PruningState

BLS_STORE_LABEL = "bls"
TS_STORE_LABEL = "ts"
IDR_CACHE_LABEL = "idr"
SEQ_NO_DB_LABEL = "seq_no_db"
NODE_STATUS_DB_LABEL = "node_status_db"


class DatabaseManager:
    def __init__(self):
        self._ledgers: dict[int, Ledger] = {}
        self._states: dict[int, Optional[PruningState]] = {}
        self._stores: dict[str, object] = {}
        # crypto pipeline this node's commit drain rides (set by the
        # bootstrap when one exists): the write manager builds its fused
        # commit wave on it; None keeps every root producer inline
        self.pipeline = None

    # --- ledgers / states -------------------------------------------------

    def register_ledger(self, ledger_id: int, ledger: Ledger,
                        state: Optional[PruningState] = None) -> None:
        self._ledgers[ledger_id] = ledger
        self._states[ledger_id] = state

    def get_ledger(self, ledger_id: int) -> Optional[Ledger]:
        return self._ledgers.get(ledger_id)

    def get_state(self, ledger_id: int) -> Optional[PruningState]:
        return self._states.get(ledger_id)

    @property
    def ledger_ids(self) -> list[int]:
        return list(self._ledgers)

    def ledgers(self) -> Iterable[tuple[int, Ledger]]:
        return self._ledgers.items()

    # --- named stores -----------------------------------------------------

    def register_store(self, label: str, store) -> None:
        self._stores[label] = store

    def get_store(self, label: str):
        return self._stores.get(label)

    @property
    def bls_store(self):
        return self._stores.get(BLS_STORE_LABEL)

    @property
    def ts_store(self):
        return self._stores.get(TS_STORE_LABEL)

    @property
    def idr_cache(self):
        return self._stores.get(IDR_CACHE_LABEL)

    # --- group commit -----------------------------------------------------

    def iter_kv_stores(self) -> Iterator:
        """Every underlying KeyValueStorage a 3PC commit can touch: txn
        logs, Merkle hash stores, state tries, and the named specialty
        stores (ts/seq-no/bls/...). Deduplicated by identity."""
        seen: set[int] = set()

        def fresh(kv) -> bool:
            if kv is None or id(kv) in seen:
                return False
            seen.add(id(kv))
            return True

        for ledger in self._ledgers.values():
            if fresh(ledger.txn_log):
                yield ledger.txn_log
            hs_kv = ledger.tree.hash_store.kv
            if fresh(hs_kv):
                yield hs_kv
        for state in self._states.values():
            if state is not None and fresh(state.kv):
                yield state.kv
        for store in self._stores.values():
            kv = store if hasattr(store, "write_batch") \
                else getattr(store, "kv", None)
            if kv is not None and hasattr(kv, "write_batch") and fresh(kv):
                yield kv

    @contextmanager
    def group_commit(self):
        """One write_batch scope across EVERY store: all durable rows a
        3PC batch produces (ledger txns, hash-store rows, trie nodes,
        audit, ts-store, seq-no entries) land as one atomic KV batch per
        store, flushed once at scope exit. Nesting joins the outer scope
        (each backend's write_batch does), so the node can stretch one
        scope over several consecutive ordered batches — catchup-style
        multi-batch group commit."""
        with ExitStack() as stack:
            for kv in self.iter_kv_stores():
                stack.enter_context(kv.write_batch())
            yield self

    def close(self) -> None:
        for ledger in self._ledgers.values():
            ledger.close()
        for state in self._states.values():
            if state is not None:
                state.close()
        for store in self._stores.values():
            close = getattr(store, "close", None)
            if callable(close):
                close()
