"""Chunked durable file-backed KV store for unbounded append logs.

Reference behavior: storage/chunked_file_store.py:1 — a long-lived
append log (ledger txn logs grow forever) split across fixed-size chunk
files instead of one unbounded file, so a multi-year ledger never pays
whole-file rewrites, old history can be archived/shipped per chunk, and
a torn tail only ever concerns the LAST chunk.

Same `KeyValueStorage` ABC and record format as KvFile (this slots in
as a `Ledger` txn_log unchanged); records append to the live tail
chunk, which SEALS at `chunk_records` and rotates. Sealed chunks are
never rewritten — close() does NOT compact (an append-mostly history
log has nothing to compact; rewriting every chunk would defeat the
chunking), unlike KvFile whose single file earns its close-time rewrite.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator, Optional

from .kv_file import (apply_records, pack_record, scan_records, _BATCH,
                      _HDR, _PUT, _DEL)
from .kv_memory import KvMemory
from .kv_store import KeyValueStorage, encode_key


class KvChunked(KeyValueStorage):
    def __init__(self, path: str, name: str = "kv",
                 chunk_records: int = 1000):
        if chunk_records < 1:
            raise ValueError("chunk_records must be >= 1")
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._name = name
        self._chunk_records = chunk_records
        self._mem = KvMemory()
        self._fh = None
        self._batch: Optional[list[bytes]] = None   # staged records in scope
        self._tail_no = 0          # number of the live chunk
        self._tail_records = 0     # records in the live chunk
        self._replay()
        self._fh = open(self._chunk_path(self._tail_no), "ab")

    # --- chunk files ------------------------------------------------------

    def _chunk_path(self, no: int) -> str:
        return os.path.join(self._dir, f"{self._name}.{no:06d}.chunk")

    def _chunk_numbers(self) -> list[int]:
        prefix, suffix = self._name + ".", ".chunk"
        out = []
        for fn in os.listdir(self._dir):
            if fn.startswith(prefix) and fn.endswith(suffix):
                mid = fn[len(prefix):-len(suffix)]
                if mid.isdigit():
                    out.append(int(mid))
        return sorted(out)

    def _replay(self) -> None:
        chunks = self._chunk_numbers()
        if not chunks:
            self._tail_no, self._tail_records = 1, 0
            return
        for no in chunks:
            fpath = self._chunk_path(no)
            with open(fpath, "rb") as fh:
                data = fh.read()
            entries, off = scan_records(data)   # shared format scanner
            apply_records(self._mem, entries)
            records, n = len(entries), len(data)
            if off < n:
                if no != chunks[-1]:
                    # a sealed chunk must parse end to end; a torn TAIL
                    # chunk is the one crash case this format expects
                    raise IOError(
                        f"corrupt sealed chunk {fpath!r} at offset {off}")
                with open(fpath, "r+b") as fh:
                    fh.truncate(off)   # drop the torn record
            self._tail_no, self._tail_records = no, records

    def _rotate_if_full(self) -> None:
        if self._tail_records < self._chunk_records:
            return
        self._fh.close()
        self._tail_no += 1
        self._tail_records = 0
        self._fh = open(self._chunk_path(self._tail_no), "ab")

    def _append(self, op: int, key: bytes, value: bytes = b"") -> None:
        if self._batch is not None:
            self._batch.append(pack_record(op, key, value))
            return
        self._rotate_if_full()
        self._fh.write(pack_record(op, key, value))
        self._fh.flush()
        self._tail_records += 1

    @contextmanager
    def write_batch(self):
        """One atomic _BATCH record in the tail chunk per scope (torn tail
        drops the whole batch, same as KvFile). The batch counts as its
        inner record count toward chunk rotation — replay expands it to the
        inner entries, so the accounting must match on reopen. A batch
        larger than chunk_records overflows its chunk rather than split:
        atomicity beats the soft chunk-size target."""
        if self._batch is not None:         # nested: join the outer batch
            yield self
            return
        self._batch = []
        try:
            yield self
        finally:
            records, self._batch = self._batch, None
            if records:
                self._rotate_if_full()
                if len(records) == 1:
                    self._fh.write(records[0])
                else:
                    self._fh.write(pack_record(_BATCH, b"",
                                               b"".join(records)))
                self._fh.flush()
                self._tail_records += len(records)

    # --- KeyValueStorage --------------------------------------------------

    def put(self, key, value: bytes) -> None:
        k = encode_key(key)
        self._append(_PUT, k, bytes(value))
        self._mem.put(k, value)

    def get(self, key) -> bytes:
        return self._mem.get(key)

    def remove(self, key) -> None:
        k = encode_key(key)
        self._append(_DEL, k)
        self._mem.remove(k)

    def iterator(self, start=None, end=None,
                 include_value: bool = True) -> Iterator:
        return self._mem.iterator(start, end, include_value)

    def close(self) -> None:
        if self._fh is None:
            return
        self._fh.close()
        self._fh = None

    @property
    def size(self) -> int:
        return self._mem.size

    # --- chunk maintenance (operator tooling) -----------------------------

    @property
    def chunk_count(self) -> int:
        return len(self._chunk_numbers())

    def drop_sealed_chunks_before(self, chunk_no: int) -> int:
        """Archive hook: delete sealed chunk files numbered < chunk_no
        (the in-memory view keeps serving; on the NEXT open the dropped
        records are gone — only meaningful for logs whose old records
        the caller has archived elsewhere, e.g. a snapshotted ledger).
        -> number of files deleted."""
        dropped = 0
        for no in self._chunk_numbers():
            if no >= min(chunk_no, self._tail_no):
                break
            os.remove(self._chunk_path(no))
            dropped += 1
        return dropped
