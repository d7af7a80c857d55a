"""The port's copy of tests/test_kv_native.py, run on plenum_tpu_torch.

Native C++ KV engine: differential-tested against the in-memory model,
plus durability, torn-tail, and compaction behavior.

Reference test model: storage tests for the LevelDB/RocksDB backends.
"""
from __future__ import annotations

import os
import random

import pytest

from plenum_tpu_torch.storage.kv_memory import KvMemory
from plenum_tpu_torch.storage.kv_native import KvNative, native_available

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")


def test_differential_vs_memory_model(tmp_path):
    rng = random.Random(7)
    kv = KvNative(str(tmp_path))
    model = KvMemory()
    keys = [b"k%03d" % i for i in range(50)]
    for _ in range(2000):
        op = rng.randrange(3)
        k = rng.choice(keys)
        if op == 0:
            v = rng.randbytes(rng.randrange(0, 200))
            kv.put(k, v)
            model.put(k, v)
        elif op == 1:
            kv.remove(k)
            model.remove(k)
        else:
            try:
                expect = model.get(k)
            except KeyError:
                with pytest.raises(KeyError):
                    kv.get(k)
            else:
                assert kv.get(k) == expect
    assert list(kv.iterator()) == list(model.iterator())
    assert kv.size == model.size

    # ranged iteration agrees too (inclusive end, KvMemory semantics)
    assert list(kv.iterator(start=b"k010", end=b"k020")) == \
        list(model.iterator(start=b"k010", end=b"k020"))

    # durability: reopen sees the same content
    kv.close()
    kv2 = KvNative(str(tmp_path))
    assert list(kv2.iterator()) == list(model.iterator())
    kv2.close()


def test_torn_tail_drops_only_last_record(tmp_path):
    kv = KvNative(str(tmp_path))
    for i in range(10):
        kv.put(b"key%d" % i, b"value%d" % i)
    # close WITHOUT compaction path interfering: garbage ratio is 0 here
    kv.close()
    path = os.path.join(str(tmp_path), "kv.kvn")
    os.truncate(path, os.path.getsize(path) - 4)
    kv2 = KvNative(str(tmp_path))
    assert kv2.size == 9                 # only the torn record lost
    assert kv2.get(b"key8") == b"value8"
    with pytest.raises(KeyError):
        kv2.get(b"key9")
    # the truncated tail was cut at a record boundary: appends work
    kv2.put(b"key9", b"value9b")
    kv2.close()
    kv3 = KvNative(str(tmp_path))
    assert kv3.get(b"key9") == b"value9b"
    kv3.close()


def test_corrupt_record_detected_by_crc(tmp_path):
    kv = KvNative(str(tmp_path))
    kv.put(b"aa", b"11")
    kv.put(b"bb", b"22")
    kv.close()
    path = os.path.join(str(tmp_path), "kv.kvn")
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF                     # flip a bit in the LAST record
    open(path, "wb").write(bytes(data))
    kv2 = KvNative(str(tmp_path))
    assert kv2.size == 1                 # corrupt record (and after) dropped
    assert kv2.get(b"aa") == b"11"
    kv2.close()


def test_compaction_shrinks_file_and_preserves_content(tmp_path):
    kv = KvNative(str(tmp_path))
    for round_ in range(20):
        for i in range(20):
            kv.put(b"k%d" % i, b"v%d-%d" % (i, round_))
    path = os.path.join(str(tmp_path), "kv.kvn")
    before = os.path.getsize(path)
    assert kv.garbage_ratio > 0.8
    kv.compact()
    after = os.path.getsize(path)
    assert after < before / 5
    assert kv.size == 20
    assert kv.get(b"k7") == b"v7-19"
    # still writable after compaction
    kv.put(b"new", b"x")
    kv.close()
    kv2 = KvNative(str(tmp_path))
    assert kv2.get(b"new") == b"x" and kv2.size == 21
    kv2.close()
