"""Timestamp -> state-root index for historical state reads.

Reference behavior: storage/state_ts_store.py:24,38 — StateTsDbStorage maps
(ledger_id, timestamp) to the state root committed at that time, and serves
`get_equal_or_prev(ts, ledger_id)`: the root of the LAST batch committed at
or before `ts`. Request handlers use it to answer "state as of time T"
queries (request_handlers/get_txn_author_agreement_handler.py:46).

Key layout: 2-byte big-endian ledger_id || 8-byte big-endian unix seconds,
so lexicographic KV order equals (ledger, time) order. Writes are a single
KV put (commit_batch is the hot path); `get_equal_or_prev` is a bounded
range scan taking the max qualifying key — historical queries are rare, so
the scan cost lives on the read side and nothing is cached in memory.
"""
from __future__ import annotations

from typing import Optional

from .kv_store import KeyValueStorage


def _key(ledger_id: int, ts: int) -> bytes:
    return ledger_id.to_bytes(2, "big") + int(ts).to_bytes(8, "big")


class StateTsStore:
    def __init__(self, kv: KeyValueStorage):
        self._kv = kv

    @property
    def kv(self) -> KeyValueStorage:
        return self._kv

    def set(self, ledger_id: int, ts: float, root: bytes) -> None:
        self._kv.put(_key(ledger_id, int(ts)), root)

    def get(self, ledger_id: int, ts: float) -> Optional[bytes]:
        return self._kv.try_get(_key(ledger_id, int(ts)))

    def get_equal_or_prev(self, ts: float, ledger_id: int) -> Optional[bytes]:
        """Root of the last batch committed at or before `ts` (None if the
        ledger had no committed batch yet at that time). Max-key over the
        range scan, so backend iteration order doesn't matter."""
        prefix = ledger_id.to_bytes(2, "big")
        target = _key(ledger_id, int(ts))
        best_key, best_root = None, None
        for k, v in self._kv.iterator(start=prefix + bytes(8), end=target):
            if k[:2] == prefix and k <= target and \
                    (best_key is None or k > best_key):
                best_key, best_root = k, v
        return best_root

    def close(self) -> None:
        self._kv.close()
