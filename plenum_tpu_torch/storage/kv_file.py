"""Durable file-backed KV store.

Append-only log of (op, key, value) records with an in-memory index, compacted
on close. Fills the role of the reference's LevelDB/RocksDB backends
(storage/kv_store_leveldb.py:14, kv_store_rocksdb.py:15) for crash-resume
without native DB deps; a C++ LSM backend can slot in behind the same ABC.
"""
from __future__ import annotations

import os
import struct
from contextlib import contextmanager
from typing import Iterator, Optional

from .kv_store import KeyValueStorage, encode_key
from .kv_memory import KvMemory

# _BATCH is the group-commit record: key empty, value = the concatenated
# inner put/del records, written (and flushed) as ONE append. Crash
# atomicity falls out of the framing: the outer header's value_len covers
# every inner record, so a torn write drops the WHOLE batch on replay —
# there is no prefix of a batch.
_PUT, _DEL, _BATCH = 0, 1, 2
_HDR = struct.Struct(">BII")  # op, key_len, value_len


def pack_record(op: int, key: bytes, value: bytes = b"") -> bytes:
    return _HDR.pack(op, len(key), len(value)) + key + value


def scan_records(data: bytes) -> tuple[list[tuple[int, bytes, bytes]], int]:
    """THE record-scan for this on-disk format, shared by every reader
    (KvFile replay, read-only replay, KvChunked replay — a format or
    validation change happens HERE once). Parses until the first corrupt
    header or truncated (torn-tail) record; batch records expand to their
    inner put/del entries (whose framing the outer length already
    validated — a batch whose payload doesn't parse exactly is corrupt and
    ends the scan). -> ([(op, key, value)], good_prefix_length)."""
    entries = []
    off, n = 0, len(data)
    while off + _HDR.size <= n:
        op, klen, vlen = _HDR.unpack_from(data, off)
        if op not in (_PUT, _DEL, _BATCH) or off + _HDR.size + klen + vlen > n:
            break
        rec_end = off + _HDR.size + klen + vlen
        key = data[off + _HDR.size:off + _HDR.size + klen]
        val = data[off + _HDR.size + klen:rec_end]
        if op == _BATCH:
            inner, inner_off = scan_records(val)
            if inner_off != len(val) or any(o == _BATCH for o, _, _ in inner):
                break                      # corrupt batch payload
            entries.extend(inner)
        else:
            entries.append((op, key, val))
        off = rec_end
    return entries, off


def apply_records(mem: KvMemory, entries) -> None:
    for op, key, val in entries:
        if op == _PUT:
            mem.put(key, val)
        else:
            mem.remove(key)


def read_log_readonly(path: str, name: str = "kv") -> list[tuple[bytes, bytes]]:
    """Replay a KvFile log WITHOUT opening it for append, truncating a torn
    tail, or compacting — safe against a store another process is writing.
    Torn/corrupt tails are simply ignored. -> sorted [(key, value)]."""
    file_path = os.path.join(path, name + ".kvlog")
    mem = KvMemory()
    if not os.path.exists(file_path):
        return []
    with open(file_path, "rb") as fh:
        data = fh.read()
    apply_records(mem, scan_records(data)[0])
    return list(mem.iterator())


class KvFile(KeyValueStorage):
    def __init__(self, path: str, name: str = "kv"):
        os.makedirs(path, exist_ok=True)
        self._file_path = os.path.join(path, name + ".kvlog")
        self._mem = KvMemory()
        self._fh = None
        self._batch: Optional[list[bytes]] = None   # staged records in scope
        self._replay()
        self._fh = open(self._file_path, "ab")

    def _replay(self) -> None:
        if not os.path.exists(self._file_path):
            return
        with open(self._file_path, "rb") as fh:
            data = fh.read()
        entries, off = scan_records(data)
        apply_records(self._mem, entries)
        n = len(data)
        if off < n:
            # Drop the torn record so appended records aren't misparsed by the
            # next replay.
            with open(self._file_path, "r+b") as fh:
                fh.truncate(off)

    def _append(self, op: int, key: bytes, value: bytes = b"") -> None:
        if self._batch is not None:
            self._batch.append(pack_record(op, key, value))
            return
        self._fh.write(pack_record(op, key, value))
        self._fh.flush()

    def _flush_batch(self, records: list[bytes]) -> None:
        """One append, one flush, all-or-nothing on replay."""
        if not records:
            return
        if len(records) == 1:
            self._fh.write(records[0])      # a 1-op batch IS atomic already
        else:
            self._fh.write(pack_record(_BATCH, b"", b"".join(records)))
        self._fh.flush()

    @contextmanager
    def write_batch(self):
        if self._batch is not None:         # nested: join the outer batch
            yield self
            return
        self._batch = []
        try:
            yield self
        finally:
            # flushed even if the scope raised: the in-memory view already
            # holds these writes, and memory/disk must not diverge
            records, self._batch = self._batch, None
            self._flush_batch(records)

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

    def iterator(self, start=None, end=None, include_value: bool = True) -> Iterator:
        return self._mem.iterator(start, end, include_value)

    def close(self) -> None:
        if self._fh is None:
            return
        self._fh.close()
        self._fh = None
        # Compact: rewrite only live records.
        tmp = self._file_path + ".compact"
        with open(tmp, "wb") as fh:
            for k, v in self._mem.iterator():
                fh.write(_HDR.pack(_PUT, len(k), len(v)) + k + v)
        os.replace(tmp, self._file_path)

    @property
    def size(self) -> int:
        return self._mem.size
