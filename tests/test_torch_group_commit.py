"""The port's copy of tests/test_group_commit.py, run on plenum_tpu_torch.

Group-committed durable writes: the per-3PC-batch atomic KV batch.

Covers the storage primitive (the _BATCH record in kv_file/kv_chunked:
torn tail drops the WHOLE batch, never a prefix), the execution layer's
commit footprint (one appended record frame per store per commit, no
interleaved single puts), crash-replay between commit-quorum and durable
flush, and multi-batch coalescing under one DatabaseManager.group_commit
scope.
"""
import os
import struct

import pytest

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.execution import (DatabaseManager, ThreePcBatch,
                                        WriteRequestManager)
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.execution.database_manager import (SEQ_NO_DB_LABEL,
                                                         TS_STORE_LABEL)
from plenum_tpu_torch.execution.handlers import NodeHandler, NymHandler
from plenum_tpu_torch.execution.txn import NYM, TRUSTEE
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import HashStore
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.state.pruning_state import PruningState
from plenum_tpu_torch.storage.kv_chunked import KvChunked
from plenum_tpu_torch.storage.kv_file import KvFile, _HDR
from plenum_tpu_torch.storage.state_ts_store import StateTsStore

TRUSTEE_DID = "trusteeTrusteeTrustee1"


def count_frames(path: str) -> int:
    """Top-level record frames in a kvlog (a _BATCH counts as ONE)."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames, off = 0, 0
    while off + _HDR.size <= len(data):
        _op, klen, vlen = _HDR.unpack_from(data, off)
        off += _HDR.size + klen + vlen
        frames += 1
    assert off == len(data), "trailing garbage in log"
    return frames


# --- storage level -----------------------------------------------------------

@pytest.mark.parametrize("factory", [
    lambda d: KvFile(d),
    lambda d: KvChunked(d, chunk_records=100),
], ids=["kv_file", "kv_chunked"])
def test_torn_batch_drops_whole_batch(tmp_path, factory):
    """Crash mid-flush (simulated by truncating the tail at EVERY byte
    boundary of the batch record): replay yields all-or-nothing, never a
    half-written batch."""
    d = str(tmp_path / "kv")
    kv = factory(d)
    kv.put(b"pre", b"kept")
    log = [f for f in os.listdir(d)][0]
    path = os.path.join(d, log)
    size_before = os.path.getsize(path)
    with kv.write_batch():
        for i in range(4):
            kv.put(b"k%d" % i, b"v%d" % i * 7)
    size_after = os.path.getsize(path)
    kv._fh.close()          # abandon WITHOUT close(): close compacts
    kv._fh = None
    import shutil
    for cut in range(size_before, size_after):
        trial = str(tmp_path / f"cut{cut}")
        shutil.copytree(d, trial)
        with open(os.path.join(trial, log), "r+b") as fh:
            fh.truncate(cut)
        re = factory(trial)
        got = dict(re.iterator())
        assert got == {b"pre": b"kept"}, \
            f"cut at {cut}: partial batch survived: {got}"
        re._fh.close()
        re._fh = None
    # untouched log replays the full batch
    re = factory(d)
    assert re.size == 5
    re._fh.close()
    re._fh = None


def test_batch_survives_replay_and_compaction(tmp_path):
    d = str(tmp_path / "kv")
    kv = KvFile(d)
    with kv.write_batch():
        kv.put(b"a", b"1")
        kv.remove(b"a")
        kv.put(b"b", b"2")
        assert kv.try_get(b"b") == b"2"     # read-your-writes in scope
    kv.close()                              # compacts to plain records
    re = KvFile(d)
    assert dict(re.iterator()) == {b"b": b"2"}
    re.close()


def test_nested_write_batch_joins_outer(tmp_path):
    d = str(tmp_path / "kv")
    kv = KvFile(d)
    with kv.write_batch():
        kv.put(b"x", b"1")
        with kv.write_batch():              # joins: still ONE frame
            kv.put(b"y", b"2")
        kv.put(b"z", b"3")
    assert count_frames(os.path.join(d, "kv.kvlog")) == 1
    kv._fh.close()
    kv._fh = None
    re = KvFile(d)
    assert re.size == 3
    re._fh.close()
    re._fh = None


# --- execution level ---------------------------------------------------------

def make_durable_db(path, kv_factory) -> DatabaseManager:
    """File-backed DatabaseManager mirroring bootstrap's store layout."""
    db = DatabaseManager()
    for lid, label in ((AUDIT_LEDGER_ID, "audit"), (POOL_LEDGER_ID, "pool"),
                       (CONFIG_LEDGER_ID, "config"),
                       (DOMAIN_LEDGER_ID, "domain")):
        tree = CompactMerkleTree(
            hash_store=HashStore(kv_factory(os.path.join(path,
                                                         label + "_hashes"))))
        ledger = Ledger(tree, kv_factory(os.path.join(path, label + "_log")))
        state = None if lid == AUDIT_LEDGER_ID else \
            PruningState(kv_factory(os.path.join(path, label + "_state")))
        db.register_ledger(lid, ledger, state)
    db.register_store(TS_STORE_LABEL,
                      StateTsStore(kv_factory(os.path.join(path, "ts"))))
    db.register_store(SEQ_NO_DB_LABEL,
                      kv_factory(os.path.join(path, "seq_no_db")))
    return db


def make_wm(db) -> WriteRequestManager:
    wm = WriteRequestManager(db)
    nym = NymHandler(db)
    wm.register_handler(nym)
    wm.register_handler(NodeHandler(db, nym))
    return wm


def commit_nym_batch(wm, dests, pp_seq_no, pp_time):
    reqs = []
    for i, dest in enumerate(dests):
        op = {"type": NYM, "dest": dest, "verkey": "vk%d" % i}
        if dest == TRUSTEE_DID:
            op["role"] = TRUSTEE            # pool bootstrap
        reqs.append(Request(TRUSTEE_DID, 100 + pp_seq_no * 10 + i, op,
                            signature="sig"))
    valid, rejected, roots = wm.apply_batch(
        DOMAIN_LEDGER_ID, reqs, pp_time, 0, pp_seq_no)
    assert len(valid) == len(dests) and not rejected
    batch = ThreePcBatch(DOMAIN_LEDGER_ID, 0, pp_seq_no, pp_time,
                         tuple(r.digest for r in valid),
                         bytes.fromhex(roots["state_root"]),
                         bytes.fromhex(roots["txn_root"]),
                         bytes.fromhex(roots["audit_txn_root"]))
    return wm.commit_batch(batch)


@pytest.mark.parametrize("kv_factory", [
    lambda d: KvFile(d),
    lambda d: KvChunked(d, chunk_records=1000),
], ids=["kv_file", "kv_chunked"])
def test_commit_is_one_frame_per_store(tmp_path, kv_factory):
    """The acceptance shape: a commit's durable writes per store collapse
    to ONE appended record frame (the atomic batch), not interleaved
    single puts."""
    d = str(tmp_path / "node")
    db = make_durable_db(d, kv_factory)
    wm = make_wm(db)
    commit_nym_batch(wm, [TRUSTEE_DID], 1, 1000.0)      # bootstrap trustee
    logs = {label: os.path.join(d, label, os.listdir(os.path.join(d, label))[0])
            for label in ("domain_log", "audit_log", "seq_no_db", "ts",
                          "domain_hashes", "audit_hashes")}
    before = {k: count_frames(p) for k, p in logs.items()}
    commit_nym_batch(wm, ["userA1", "userB2", "userC3"], 2, 1001.0)
    grew = {k: count_frames(p) - before[k] for k, p in logs.items()}
    # commit_batch runs under ONE group scope: every store that took >1 row
    # appended exactly one batch frame; single-row stores appended one
    # plain record
    for k, delta in grew.items():
        assert delta <= 1, f"{k}: {delta} frames for one committed batch"
    assert grew["domain_log"] == 1 and grew["seq_no_db"] == 1
    assert grew["audit_log"] == 1 and grew["ts"] == 1


def test_multi_batch_group_commit_single_frame(tmp_path):
    """Several ready batches committed inside one outer group_commit scope
    (the node's drain loop) coalesce into ONE frame per store."""
    d = str(tmp_path / "node")
    db = make_durable_db(d, lambda p: KvFile(p))
    wm = make_wm(db)
    commit_nym_batch(wm, [TRUSTEE_DID], 1, 1000.0)
    # stage two batches, then commit both under one scope
    batches = []
    for pp_seq_no, dests in ((2, ["uA", "uB"]), (3, ["uC", "uD"])):
        reqs = [Request(TRUSTEE_DID, 200 + pp_seq_no * 10 + i,
                        {"type": NYM, "dest": dest, "verkey": "v"},
                        signature="sig")
                for i, dest in enumerate(dests)]
        valid, rejected, roots = wm.apply_batch(
            DOMAIN_LEDGER_ID, reqs, 1000.0 + pp_seq_no, 0, pp_seq_no)
        assert len(valid) == 2 and not rejected
        batches.append(ThreePcBatch(
            DOMAIN_LEDGER_ID, 0, pp_seq_no, 1000.0 + pp_seq_no,
            tuple(r.digest for r in valid),
            bytes.fromhex(roots["state_root"]),
            bytes.fromhex(roots["txn_root"]),
            bytes.fromhex(roots["audit_txn_root"])))
    domain_log = os.path.join(d, "domain_log", "kv.kvlog")
    before = count_frames(domain_log)
    with db.group_commit():
        for b in batches:
            wm.commit_batch(b)
    assert count_frames(domain_log) - before == 1, \
        "two batches under one scope must flush as one frame"
    assert db.get_ledger(DOMAIN_LEDGER_ID).size == 5


def test_crash_between_quorum_and_flush_replays_cleanly(tmp_path):
    """The satellite's crash case: process dies after commit-quorum but
    mid durable flush. Simulated by truncating the committed batch's tail
    record at an arbitrary interior byte on EVERY store: replay must show
    NO half-written audit/seq-no/ledger rows — each store holds the whole
    batch or none of it."""
    import shutil
    d = str(tmp_path / "node")
    db = make_durable_db(d, lambda p: KvFile(p))
    wm = make_wm(db)
    commit_nym_batch(wm, [TRUSTEE_DID], 1, 1000.0)
    sizes_before = {}
    for label in ("domain_log", "audit_log", "seq_no_db"):
        sizes_before[label] = os.path.getsize(
            os.path.join(d, label, "kv.kvlog"))
    committed = commit_nym_batch(wm, ["uX1", "uX2", "uX3"], 2, 1001.0)
    digests = [txn_lib.txn_payload_digest(t) for t in committed]
    assert all(digests)
    ledger_size = db.get_ledger(DOMAIN_LEDGER_ID).size
    audit_size = db.get_ledger(AUDIT_LEDGER_ID).size

    # crash: abandon without close (close would compact), then tear the
    # tail of each store's log a few bytes into the batch record
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    for label in ("domain_log", "audit_log", "seq_no_db"):
        p = os.path.join(crash, label, "kv.kvlog")
        with open(p, "r+b") as fh:
            fh.truncate(sizes_before[label] + 7)    # mid batch record
    re_db = make_durable_db(crash, lambda p: KvFile(p))
    assert re_db.get_ledger(DOMAIN_LEDGER_ID).size == ledger_size - 3, \
        "torn ledger batch must vanish whole"
    assert re_db.get_ledger(AUDIT_LEDGER_ID).size == audit_size - 1
    seq_no = re_db.get_store(SEQ_NO_DB_LABEL)
    assert all(seq_no.try_get(dg.encode()) is None for dg in digests), \
        "half-written seq-no rows survived the torn batch"

    # the UNTORN copy replays the full batch — nothing was lost by the
    # batch framing itself
    re_db2 = make_durable_db(d, lambda p: KvFile(p))
    assert re_db2.get_ledger(DOMAIN_LEDGER_ID).size == ledger_size
    seq_no2 = re_db2.get_store(SEQ_NO_DB_LABEL)
    assert all(seq_no2.try_get(dg.encode()) is not None for dg in digests)
