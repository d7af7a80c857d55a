"""The port's copy of tests/test_substrate.py, run on plenum_tpu_torch; the
serialized bytes, digests and store contents are also held to the
reference's on the same inputs.

Unit tests for the common substrate: quorums, timers, buses, stashing,
messages, request digests, serialization, KV stores."""
import pytest

from plenum_tpu_torch.common.quorums import Quorums, faults
from plenum_tpu_torch.common.timer import MockTimer, QueueTimer, RepeatingTimer
from plenum_tpu_torch.common.event_bus import InternalBus, ExternalBus
from plenum_tpu_torch.common.stashing import StashingRouter, StashReason, STASH, PROCESS, DISCARD
from plenum_tpu_torch.common.message_base import (MessageValidationError,
                                            message_from_dict)
from plenum_tpu_torch.common.node_messages import (PrePrepare, Prepare, Commit,
                                             Checkpoint, Propagate)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack, signing_serialize
from plenum_tpu_torch.config import Config, load_config
from plenum_tpu_torch.storage import init_kv_store
from plenum_tpu_torch.storage.kv_file import KvFile

from plenum_tpu.common import serialization as ref_ser
from plenum_tpu.common.quorums import Quorums as RefQuorums
from plenum_tpu.common.request import Request as RefRequest


# --- quorums (ref quorums.py table) --------------------------------------

@pytest.mark.parametrize("n,f", [(4, 1), (7, 2), (10, 3), (13, 4), (25, 8)])
def test_faults(n, f):
    assert faults(n) == f


def test_quorum_table_n4():
    q = Quorums(4)
    assert q.propagate.value == 2
    assert q.prepare.value == 2
    assert q.commit.value == 3
    assert q.view_change.value == 3
    assert q.checkpoint.value == 2
    assert q.timestamp.value == 2
    assert q.bls_signatures.value == 3
    assert q.prepare.is_reached(2) and not q.prepare.is_reached(1)
    for n in (4, 7, 25):
        ours, theirs = Quorums(n), RefQuorums(n)
        assert {k: getattr(v, "value", v) for k, v in vars(ours).items()} == \
            {k: getattr(v, "value", v) for k, v in vars(theirs).items()}


# --- timers ---------------------------------------------------------------

def test_mock_timer_fires_in_order():
    timer = MockTimer()
    fired = []
    timer.schedule(5, lambda: fired.append("b"))
    timer.schedule(1, lambda: fired.append("a"))
    timer.schedule(10, lambda: fired.append("c"))
    timer.advance(6)
    assert fired == ["a", "b"]
    timer.advance(5)
    assert fired == ["a", "b", "c"]


def test_timer_cancel():
    timer = MockTimer()
    fired = []
    cb = lambda: fired.append(1)
    timer.schedule(1, cb)
    timer.cancel(cb)
    timer.advance(2)
    assert fired == []


def test_repeating_timer():
    timer = MockTimer()
    fired = []
    rt = RepeatingTimer(timer, 10, lambda: fired.append(timer.get_current_time()))
    timer.advance(35)
    assert fired == [10, 20, 30]
    rt.stop()
    timer.advance(20)
    assert fired == [10, 20, 30]


# --- buses ----------------------------------------------------------------

def test_internal_bus_dispatch_by_type():
    bus = InternalBus()
    got = []
    bus.subscribe(Checkpoint, lambda m: got.append(m))
    cp = Checkpoint(inst_id=0, view_no=0, seq_no_start=0, seq_no_end=100, digest="d")
    bus.send(cp)
    assert got == [cp]


def test_external_bus_connecteds():
    sent = []
    bus = ExternalBus(lambda msg, dst: sent.append((msg, dst)))
    events = []
    bus.subscribe(ExternalBus.Connected, lambda m, frm: events.append(("+", m.name)))
    bus.subscribe(ExternalBus.Disconnected, lambda m, frm: events.append(("-", m.name)))
    bus.update_connecteds({"B", "C"})
    bus.update_connecteds({"C", "D"})
    assert ("+", "B") in events and ("+", "D") in events and ("-", "B") in events
    bus.send("hello", "B")
    assert sent == [("hello", ["B"])]


# --- stashing router ------------------------------------------------------

def test_stashing_router_stash_and_replay():
    router = StashingRouter()
    state = {"ready": False}
    seen = []

    def handler(msg, frm):
        if not state["ready"]:
            return STASH(StashReason.CATCHING_UP)
        seen.append((msg, frm))
        return PROCESS

    router.subscribe(Checkpoint, handler)
    cp = Checkpoint(inst_id=0, view_no=0, seq_no_start=0, seq_no_end=10, digest="x")
    router.dispatch(cp, "NodeB")
    assert router.stash_size(StashReason.CATCHING_UP) == 1
    assert seen == []
    state["ready"] = True
    router.process_all_stashed(StashReason.CATCHING_UP)
    assert seen == [(cp, "NodeB")]
    assert router.stash_size() == 0


def test_stashing_router_discard():
    router = StashingRouter()
    router.subscribe(Checkpoint, lambda m, frm: (DISCARD, "bad"))
    cp = Checkpoint(inst_id=0, view_no=0, seq_no_start=0, seq_no_end=10, digest="x")
    router.dispatch(cp, "B")
    assert len(router.discarded) == 1


# --- messages -------------------------------------------------------------

def _pp(**kw):
    base = dict(inst_id=0, view_no=0, pp_seq_no=1, pp_time=1.0,
                req_idr=("d1", "d2"), discarded=(), digest="bd",
                ledger_id=1, state_root="sr", txn_root="tr")
    base.update(kw)
    return PrePrepare(**base)


def test_message_roundtrip():
    pp = _pp()
    d = pp.to_dict()
    assert d["op"] == "PREPREPARE"
    pp2 = message_from_dict(unpack(pack(d)))
    assert pp2 == pp
    assert pack(d) == ref_ser.pack(d)


def test_message_rejects_bad_fields():
    d = _pp().to_dict()
    d["pp_seq_no"] = "nope"
    with pytest.raises(MessageValidationError):
        message_from_dict(d)
    d2 = _pp().to_dict()
    d2["evil_extra"] = 1
    with pytest.raises(MessageValidationError):
        message_from_dict(d2)
    d3 = _pp().to_dict()
    del d3["digest"]
    with pytest.raises(MessageValidationError):
        message_from_dict(d3)


def test_message_semantic_validation():
    with pytest.raises(MessageValidationError):
        PrePrepare.from_dict(_pp().to_dict() | {"pp_seq_no": 0})
    with pytest.raises(MessageValidationError):
        Checkpoint.from_dict(dict(op="CHECKPOINT", inst_id=0, view_no=0,
                                  seq_no_start=5, seq_no_end=1, digest="d"))


def test_unknown_op_rejected():
    with pytest.raises(MessageValidationError):
        message_from_dict({"op": "EVIL"})


# --- request digests (ref request.py:87,90) ------------------------------

def test_request_digests():
    op = {"type": "1", "dest": "abc", "verkey": "vk"}
    r1 = Request("idr1", 1, op, signature="sigA")
    r2 = Request("idr1", 1, op, signature="sigB")
    assert r1.payload_digest == r2.payload_digest       # signature excluded
    assert r1.digest != r2.digest                       # signature included
    r3 = Request.from_dict(r1.to_dict())
    assert r3.digest == r1.digest
    ref = RefRequest("idr1", 1, op, signature="sigA")
    assert (r1.digest, r1.payload_digest, r1.signing_bytes()) == \
        (ref.digest, ref.payload_digest, ref.signing_bytes())


def test_request_multi_signatures():
    r = Request("idr1", 1, {"type": "1"}, signatures={"idr1": "s1", "endr": "s2"})
    assert r.all_signatures() == {"idr1": "s1", "endr": "s2"}


# --- serialization --------------------------------------------------------

def test_pack_deterministic_map_order():
    assert pack({"b": 1, "a": 2}) == pack({"a": 2, "b": 1})
    assert unpack(pack({"a": [1, 2], "n": None})) == {"a": [1, 2], "n": None}
    for obj in ({"b": 1, "a": 2}, {"a": [1, 2], "n": None}):
        assert pack(obj) == ref_ser.pack(obj)


def test_signing_serialize_canonical():
    assert signing_serialize({"b": 1, "a": 2}) == b'{"a":2,"b":1}'
    assert signing_serialize({"b": 1, "a": [2, {"d": None, "c": "x"}]}) == \
        ref_ser.signing_serialize({"b": 1, "a": [2, {"d": None, "c": "x"}]})


# --- config ---------------------------------------------------------------

def test_config_layering():
    cfg = load_config({"CHK_FREQ": 10}, {"CHK_FREQ": 5, "LOG_SIZE": 15}, None)
    assert cfg.CHK_FREQ == 5 and cfg.LOG_SIZE == 15
    assert cfg.Max3PCBatchSize == 1000
    cfg2 = cfg.replace(DELTA=0.5)
    assert cfg2.DELTA == 0.5 and cfg.DELTA == 0.1


# --- KV stores ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["memory", "file"])
def test_kv_store(backend, tdir):
    kv = init_kv_store(backend, path=tdir)
    kv.put("a", b"1")
    kv.put(b"b", b"2")
    kv.put("a", b"1x")
    assert kv.get("a") == b"1x"
    assert kv.try_get("zz") is None
    kv.remove("b")
    assert not kv.has_key("b")
    kv.put(5, b"five")
    assert kv.get(5) == b"five"
    assert kv.size == 2
    kv.close()


def test_kv_int_key_ordering(tdir):
    kv = init_kv_store("memory")
    for i in [3, 1, 300, 2, 256]:
        kv.put(i, str(i).encode())
    keys = [int.from_bytes(k, "big") for k in kv.iterator(include_value=False)]
    assert keys == [1, 2, 3, 256, 300]
    # ranged iteration
    vals = [v for _, v in kv.iterator(start=2, end=256)]
    assert vals == [b"2", b"3", b"256"]


def test_kv_file_crash_resume(tdir):
    kv = KvFile(tdir, "t")
    for i in range(100):
        kv.put(i, b"v%d" % i)
    kv.remove(50)
    del kv._fh  # simulate crash without close/compact
    kv2 = KvFile(tdir, "t")
    assert kv2.size == 99
    assert kv2.get(99) == b"v99"
    assert kv2.try_get(50) is None
    kv2.close()


def test_kv_file_batch_ops(tdir):
    kv = KvFile(tdir, "t")
    kv.do_ops_in_batch([("put", "x", b"1"), ("put", "y", b"2"), ("remove", "x", b"")])
    assert kv.try_get("x") is None and kv.get("y") == b"2"
    kv.close()


# --- regression tests for review findings ---------------------------------

def test_kv_file_torn_tail_then_append_then_crash(tdir):
    """Torn record must be truncated on replay so later appends aren't
    misparsed by the next replay (review finding #1)."""
    import os, struct
    kv = KvFile(tdir, "t")
    kv.put("key0", b"val0")
    kv.close()
    p = os.path.join(tdir, "t.kvlog")
    with open(p, "ab") as fh:  # simulate a torn header+partial record
        fh.write(struct.pack(">BII", 0, 4, 4) + b"ke")
    kv2 = KvFile(tdir, "t")
    kv2.put("b", b"2")
    del kv2._fh  # crash again without close
    kv3 = KvFile(tdir, "t")
    assert kv3.get("key0") == b"val0"
    assert kv3.get("b") == b"2"
    assert kv3.size == 2
    kv3.close()


def test_bare_tuple_field_roundtrips():
    """bls_multi_sig (bare tuple annot) must survive msgpack list decoding
    (review finding #2)."""
    pp = _pp(bls_multi_sig=("sig", "pool", ("v1", "v2")))
    pp2 = message_from_dict(unpack(pack(pp.to_dict())))
    assert pp2.bls_multi_sig == ("sig", "pool", ("v1", "v2"))
    assert hash(pp2) is not None


def test_stash_overflow_recorded():
    router = StashingRouter(limit=2)
    router.subscribe(Checkpoint, lambda m, frm: STASH(StashReason.CATCHING_UP))
    cp = Checkpoint(inst_id=0, view_no=0, seq_no_start=0, seq_no_end=10, digest="x")
    for frm in "BCDE":
        router.dispatch(cp, frm)
    assert router.stash_size() == 2
    assert len(router.discarded) == 2
    assert "overflow" in router.discarded[0][2]


def test_config_unknown_key_raises():
    with pytest.raises(KeyError):
        load_config({"CHK_FRQ": 10})


# --- regression tests for second review round -----------------------------

def test_dict_field_messages_hashable():
    c = Commit(inst_id=0, view_no=0, pp_seq_no=1, bls_sigs={"0": "sig"})
    assert hash(c) == hash(Commit.from_dict(c.to_dict()))
    assert c in {c}


def test_dict_field_rejects_non_str_keys():
    d = Propagate(request={"identifier": "a"}, sender_client=None).to_dict()
    d["request"] = {1: "a", "b": 2}
    with pytest.raises(MessageValidationError):
        message_from_dict(d)


def test_negative_fields_rejected_everywhere():
    from plenum_tpu_torch.common.node_messages import (InstanceChange, ViewChange,
                                                 LedgerStatus, CatchupReq)
    with pytest.raises(MessageValidationError):
        InstanceChange.from_dict({"op": "INSTANCE_CHANGE", "view_no": -3, "reason": 0})
    with pytest.raises(MessageValidationError):
        Checkpoint.from_dict({"op": "CHECKPOINT", "inst_id": -5, "view_no": 0,
                              "seq_no_start": 0, "seq_no_end": 1, "digest": "d"})
    with pytest.raises(MessageValidationError):
        LedgerStatus.from_dict({"op": "LEDGER_STATUS", "ledger_id": 1,
                                "txn_seq_no": -1, "merkle_root": "r"})
    with pytest.raises(MessageValidationError):
        CatchupReq.from_dict({"op": "CATCHUP_REQ", "ledger_id": 1,
                              "seq_no_start": 5, "seq_no_end": 2, "catchup_till": 9})


def test_pack_mixed_key_types_no_crash():
    assert unpack(pack({1: "a", "b": 2})) == {1: "a", "b": 2}
    assert pack({1: "a", "b": 2}) == ref_ser.pack({1: "a", "b": 2})


def test_kv_file_corrupt_op_byte_stops_replay(tdir):
    import os, struct
    kv = KvFile(tdir, "t")
    kv.put("a", b"1")
    kv.put("b", b"2")
    kv.close()
    p = os.path.join(tdir, "t.kvlog")
    data = open(p, "rb").read()
    # corrupt the op byte of the second record
    second_off = 9 + 1 + 1
    patched = bytearray(data)
    patched[second_off] = 7
    open(p, "wb").write(bytes(patched))
    kv2 = KvFile(tdir, "t")
    assert kv2.get("a") == b"1"       # prefix survives
    assert kv2.try_get("b") is None   # corrupt record dropped, not misread
    kv2.close()


def test_stashing_duplicate_subscribe_raises():
    router = StashingRouter()
    router.subscribe(Checkpoint, lambda m, frm: PROCESS)
    with pytest.raises(ValueError):
        router.subscribe(Checkpoint, lambda m, frm: PROCESS)


# --- chunked append-log store (ref chunked_file_store.py) ------------------

def test_kv_chunked_rotates_and_resumes(tdir):
    from plenum_tpu_torch.storage.kv_chunked import KvChunked
    kv = KvChunked(tdir, "c", chunk_records=10)
    for i in range(35):
        kv.put(i, b"v%d" % i)
    kv.remove(7)
    assert kv.chunk_count == 4            # 36 records / 10 per chunk
    del kv._fh                            # crash, no close
    kv2 = KvChunked(tdir, "c", chunk_records=10)
    assert kv2.size == 34
    assert kv2.get(34) == b"v34"
    assert kv2.try_get(7) is None
    # appends continue in the live tail chunk, sealing at the boundary
    for i in range(35, 50):
        kv2.put(i, b"v%d" % i)
    assert kv2.chunk_count == 6
    kv2.close()
    kv3 = KvChunked(tdir, "c", chunk_records=10)
    assert kv3.size == 49
    kv3.close()


def test_kv_chunked_torn_tail_only_affects_last_chunk(tdir):
    import os, struct
    from plenum_tpu_torch.storage.kv_chunked import KvChunked
    kv = KvChunked(tdir, "c", chunk_records=5)
    for i in range(12):
        kv.put(i, b"x%d" % i)
    kv.close()
    # tear the TAIL chunk: replay drops only the torn record
    with open(os.path.join(tdir, "c.000003.chunk"), "ab") as fh:
        fh.write(struct.pack(">BII", 0, 4, 4) + b"ke")
    kv2 = KvChunked(tdir, "c", chunk_records=5)
    assert kv2.size == 12
    kv2.put(99, b"after")
    kv2.close()
    kv3 = KvChunked(tdir, "c", chunk_records=5)
    assert kv3.get(99) == b"after" and kv3.size == 13
    kv3.close()
    # a SEALED chunk failing to parse is corruption and must be loud
    with open(os.path.join(tdir, "c.000001.chunk"), "r+b") as fh:
        fh.truncate(7)
    with pytest.raises(IOError):
        KvChunked(tdir, "c", chunk_records=5)


def test_kv_chunked_backs_a_ledger(tdir):
    """The chunked store slots in as a Ledger txn log unchanged."""
    from plenum_tpu_torch.storage.kv_chunked import KvChunked
    from plenum_tpu_torch.ledger.ledger import Ledger
    led = Ledger(txn_log=KvChunked(tdir, "txns", chunk_records=8))
    for i in range(20):
        led.append({"txn": {"type": "1", "data": {"i": i}},
                    "txnMetadata": {}, "ver": "1"})
    root = led.root_hash
    led.close()
    led2 = Ledger(txn_log=KvChunked(tdir, "txns", chunk_records=8))
    assert led2.size == 20
    assert led2.root_hash == root
    assert led2.get_by_seq_no(13)["txn"]["data"]["i"] == 12
    from plenum_tpu.ledger.ledger import Ledger as RefLedger
    ref = RefLedger()
    for i in range(20):
        ref.append({"txn": {"type": "1", "data": {"i": i}},
                    "txnMetadata": {}, "ver": "1"})
    assert ref.root_hash == root


def test_kv_chunked_drop_sealed_chunks(tdir):
    from plenum_tpu_torch.storage.kv_chunked import KvChunked
    kv = KvChunked(tdir, "c", chunk_records=4)
    for i in range(20):
        kv.put(i, b"d%d" % i)
    assert kv.chunk_count == 5
    assert kv.drop_sealed_chunks_before(3) == 2
    assert kv.chunk_count == 3
    # live view unaffected; the tail chunk is never dropped
    assert kv.get(0) == b"d0"
    assert kv.drop_sealed_chunks_before(999) == 2   # all sealed, not tail
    kv.close()
