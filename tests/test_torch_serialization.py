"""The port's two msgpack codecs (the `msgpack` package when it imports,
the pure-Python one otherwise) and Request digests against the `msgpack`
package and the JAX package's Request.

Ledger leaves are msgpack bytes, so one differing byte would change every
Merkle root: packing must be byte-identical, on every type the package
serializes, whichever codec runs; malformed input raises the same error
types from both.
"""
import importlib.util
import sys

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from plenum_tpu.common import serialization as ref_ser
from plenum_tpu.common.request import Request as RefRequest
from plenum_tpu_torch.common import serialization as port_ser
from plenum_tpu_torch.common.request import Request


def _module_without_msgpack():
    """A fresh copy of the port's serialization module, loaded while
    `msgpack` cannot be imported: the branch a host without it runs."""
    spec = importlib.util.spec_from_file_location(
        "_serialization_without_msgpack", port_ser.__file__)
    mod = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("msgpack")
    sys.modules["msgpack"] = None          # import msgpack -> ImportError
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules["msgpack"] = saved
    return mod


PURE = _module_without_msgpack()
# each codec's (pack, unpack, packb, unpackb)
CODECS = {"c": port_ser, "pure": PURE}


def test_the_c_codec_runs_where_msgpack_imports():
    assert port_ser.CODEC == "msgpack-c"
    assert PURE.CODEC == "pure-python"
    assert PURE.packb is PURE.pure_packb and PURE.unpackb is PURE.pure_unpackb
    assert port_ser.packb is not port_ser.pure_packb

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=300))
_objects = st.recursive(
    _scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.lists(kids, max_size=5).map(tuple)
                  | st.dictionaries(st.text(max_size=8) | st.integers(-99, 99),
                                    kids, max_size=20)),
    max_leaves=20)


@pytest.mark.parametrize("codec", sorted(CODECS))
@settings(max_examples=40, deadline=None)
@given(obj=_objects)
def test_packb_is_byte_identical_to_msgpack(codec, obj):
    ser = CODECS[codec]
    raw = ser.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert ser.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                               strict_map_key=False)


@pytest.mark.parametrize("codec", sorted(CODECS))
@settings(max_examples=25, deadline=None)
@given(obj=st.dictionaries(st.text(max_size=8), _objects, max_size=12))
def test_pack_matches_reference_pack(codec, obj):
    ser = CODECS[codec]
    assert ser.pack(obj) == ref_ser.pack(obj)
    assert ser.unpack(ser.pack(obj)) == ref_ser.unpack(ref_ser.pack(obj))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000,
    b"x" * 255, b"x" * 256, b"x" * 70000, [0] * 15, [0] * 16, [0] * 70000,
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(70000)}, 1.5, -0.0, float("inf")])
def test_width_boundaries(value):
    raw = PURE.packb(value)
    assert raw == msgpack.packb(value, use_bin_type=True)
    assert raw == port_ser.packb(value)
    assert PURE.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                strict_map_key=False)


def _error_of(fn, data):
    try:
        fn(data)
    except Exception as e:          # the type is what is compared
        return e
    raise AssertionError(f"{data!r} unpacked")


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xc4\x05ab", b"\xc1",
                                 b"\x01\x02", b"\xa2\xff\xfe",
                                 b"\xd9\x01\xff", b"\x81\x91\x01\x02"])
def test_unpack_rejects_malformed(codec, bad):
    """The same error type as the reference's unpack (C msgpack): plain
    ValueError for truncated input, FormatError for 0xc1, ExtraData for
    trailing bytes, UnicodeDecodeError, TypeError for a list key."""
    ref = _error_of(ref_ser.unpack, bad)
    port = _error_of(CODECS[codec].unpack, bad)
    assert type(port).__name__ == type(ref).__name__, (port, ref)
    assert isinstance(port, type(ref).__mro__[1])


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("value", [2**64, -2**63 - 1])
def test_pack_rejects_out_of_range_ints(codec, value):
    with pytest.raises(OverflowError):
        CODECS[codec].packb(value)
    with pytest.raises(OverflowError):
        ref_ser.pack(value)


def _request_kwargs():
    rng = np.random.default_rng(8)
    cases = []
    for i in range(6):
        kw = dict(identifier=f"did{i}", req_id=int(rng.integers(1, 2**40)),
                  operation={"type": "1", "dest": f"dest{i}",
                             "raw": rng.bytes(4).hex(), "n": [1, {"k": i}]})
        if i % 2:
            kw["signature"] = rng.bytes(8).hex()
        if i == 2:
            kw["signatures"] = {"a": "s1", "b": "s2"}
            kw["endorser"] = "b"
        if i == 3:
            kw["taa_acceptance"] = {"mechanism": "m", "time": 1700000000}
        cases.append(kw)
    return cases


@pytest.mark.parametrize("kw", _request_kwargs())
def test_request_digests_match_reference(kw):
    port, ref = Request(**kw), RefRequest(**kw)
    assert port.signing_bytes() == ref.signing_bytes()
    assert port.digest == ref.digest
    assert port.payload_digest == ref.payload_digest
    assert port_ser.pack(port.to_dict()) == ref_ser.pack(ref.to_dict())
    again = Request.from_dict(dict(port.to_dict()))
    assert again.digest == ref.digest
