"""Durable KV over the native C++ log-structured engine.

Reference behavior: storage/kv_store_leveldb.py:14 / kv_store_rocksdb.py:15
— the production durable backends behind the KeyValueStorage ABC. The
engine (plenum_tpu_torch/native/kvstore.cpp) is bitcask-shaped: append-only
CRC-checked log, in-memory ordered index, torn-tail tolerance, and
compaction; this wrapper adds the ABC surface and compacts on close when
the garbage ratio warrants it.
"""
from __future__ import annotations

import ctypes
import os
from contextlib import contextmanager
from typing import Iterator, Optional

from .kv_store import KeyValueStorage, encode_key

COMPACT_GARBAGE_RATIO = 0.5


def _load():
    from plenum_tpu_torch.native import _build
    lib = _build("kvstore.cpp", "kvstore")
    if lib is None:
        return None
    lib.kvn_open.argtypes = [ctypes.c_char_p]
    lib.kvn_open.restype = ctypes.c_void_p
    lib.kvn_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint32, ctypes.c_char_p,
                            ctypes.c_uint32]
    lib.kvn_put.restype = ctypes.c_int
    lib.kvn_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint32, ctypes.c_char_p,
                            ctypes.c_uint32]
    lib.kvn_get.restype = ctypes.c_long
    lib.kvn_get_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
    lib.kvn_get_len.restype = ctypes.c_long
    lib.kvn_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint32]
    lib.kvn_del.restype = ctypes.c_int
    lib.kvn_count.argtypes = [ctypes.c_void_p]
    lib.kvn_count.restype = ctypes.c_long
    lib.kvn_iter_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint32, ctypes.c_char_p,
                                  ctypes.c_uint32,
                                  ctypes.POINTER(ctypes.c_uint64)]
    lib.kvn_iter_keys.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kvn_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.kvn_compact.argtypes = [ctypes.c_void_p]
    lib.kvn_compact.restype = ctypes.c_int
    for name in ("kvn_begin_batch", "kvn_end_batch"):
        fn = getattr(lib, name, None)
        if fn is not None:       # older cached .so without batch support
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.kvn_garbage_ratio.argtypes = [ctypes.c_void_p]
    lib.kvn_garbage_ratio.restype = ctypes.c_double
    lib.kvn_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None
_LIB_TRIED = False


def native_available() -> bool:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _load()
    return _LIB is not None


class KvNative(KeyValueStorage):
    def __init__(self, path: str, name: str = "kv"):
        if not native_available():
            raise RuntimeError("native kvstore engine unavailable")
        os.makedirs(path, exist_ok=True)
        self._file_path = os.path.join(path, name + ".kvn")
        self._h = _LIB.kvn_open(self._file_path.encode())
        if not self._h:
            raise IOError(f"kvn_open failed for {self._file_path}")

    def put(self, key, value: bytes) -> None:
        k = encode_key(key)
        if _LIB.kvn_put(self._h, k, len(k), bytes(value), len(value)) != 0:
            raise IOError("kvn_put failed")

    @contextmanager
    def write_batch(self):
        """Engine-level group commit: puts/removes in the scope skip the
        per-record flush, one flush lands at scope exit (kvn_end_batch).
        Reads inside the scope stay exact (the engine flushes lazily on
        read). Nesting joins the outer scope."""
        begin = getattr(_LIB, "kvn_begin_batch", None)
        if begin is None or getattr(self, "_in_batch", False):
            yield self
            return
        self._in_batch = True
        begin(self._h)
        try:
            yield self
        finally:
            self._in_batch = False
            if _LIB.kvn_end_batch(self._h) != 0:
                raise IOError("kvn_end_batch failed")

    def get(self, key) -> bytes:
        k = encode_key(key)
        n = _LIB.kvn_get_len(self._h, k, len(k))
        if n < 0:
            raise KeyError(key)
        buf = ctypes.create_string_buffer(int(n) or 1)
        got = _LIB.kvn_get(self._h, k, len(k), buf, int(n) or 1)
        if got != n:
            raise IOError("kvn_get failed")
        return buf.raw[:n]

    def remove(self, key) -> None:
        k = encode_key(key)
        if _LIB.kvn_del(self._h, k, len(k)) != 0:
            raise IOError("kvn_del failed")

    def iterator(self, start=None, end=None,
                 include_value: bool = True) -> Iterator:
        s = encode_key(start) if start is not None else b""
        e = encode_key(end) if end is not None else b""
        total = ctypes.c_uint64()
        raw = _LIB.kvn_iter_keys(self._h, s, len(s), e, len(e),
                                 ctypes.byref(total))
        try:
            blob = ctypes.string_at(raw, total.value) if total.value else b""
        finally:
            _LIB.kvn_free(raw)
        keys = []
        off = 0
        while off < len(blob):
            klen = int.from_bytes(blob[off:off + 4], "little")
            off += 4
            keys.append(blob[off:off + klen])
            off += klen
        for k in keys:
            yield (k, self.get(k)) if include_value else k

    @property
    def size(self) -> int:
        return int(_LIB.kvn_count(self._h))

    def compact(self) -> None:
        if _LIB.kvn_compact(self._h) != 0:
            raise IOError("kvn_compact failed")

    @property
    def garbage_ratio(self) -> float:
        return float(_LIB.kvn_garbage_ratio(self._h))

    def close(self) -> None:
        if self._h:
            if self.garbage_ratio > COMPACT_GARBAGE_RATIO:
                try:
                    self.compact()
                except IOError:
                    pass                 # compaction is an optimization
            _LIB.kvn_close(self._h)
            self._h = None

    def __del__(self):
        # a dropped store must release its native handle (an open fd + C
        # buffers) even without an explicit close: a long-lived process
        # cycling stores — the crash-restart fuzz runs hundreds of node
        # lifecycles in one interpreter — exhausted the fd table through
        # GC'd-but-never-closed handles. Skip compaction: __del__ runs at
        # unpredictable times (interpreter teardown included) and must
        # only release resources.
        try:
            if getattr(self, "_h", None):
                _LIB.kvn_close(self._h)
                self._h = None
        except Exception:
            pass
