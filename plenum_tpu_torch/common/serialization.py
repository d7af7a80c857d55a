"""Canonical serializers.

Reference behavior: plenum/common/serializers/serialization.py — msgpack for the
ledger/txn log and the wire, canonical JSON (sorted keys, no whitespace) for
anything that gets signed, so signatures are reproducible across nodes.

`packb`/`unpackb` (and `pack`/`unpack` over them) call the `msgpack`
package when it imports, as the reference does, and otherwise the
pure-Python codec here (`pure_packb`/`pure_unpackb`), so the port runs on
a host without `msgpack`. `CODEC` names the one in use. The pure codec
covers the types the package serializes — dict, list/tuple, str, bytes,
int, bool, None, float — and `pure_packb` is byte-identical to
`msgpack.packb(obj, use_bin_type=True)`: ledger leaves are these bytes,
so a single differing byte would change every Merkle root.
`pure_unpackb` raises msgpack's error types on malformed input
(ValueError and its `FormatError`/`ExtraData` subclasses).
"""
from __future__ import annotations

import json
import struct
from typing import Any

from plenum_tpu_torch.common.host_spans import RECORDER as _SPANS
from plenum_tpu_torch.common.host_spans import SERDE as _SERDE


class FormatError(ValueError):
    """An invalid msgpack head byte (msgpack.exceptions.FormatError)."""


class ExtraData(ValueError):
    """Bytes left after one object (msgpack.exceptions.ExtraData)."""


def _pack_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if obj >= 0:
            if obj < 0x80:
                out.append(obj)
            elif obj < 0x100:
                out += b"\xcc" + obj.to_bytes(1, "big")
            elif obj < 0x10000:
                out += b"\xcd" + obj.to_bytes(2, "big")
            elif obj < 0x100000000:
                out += b"\xce" + obj.to_bytes(4, "big")
            elif obj < 0x10000000000000000:
                out += b"\xcf" + obj.to_bytes(8, "big")
            else:
                raise OverflowError("Integer value out of range")
        elif obj >= -32:
            out.append(obj & 0xFF)
        elif obj >= -0x80:
            out += b"\xd0" + obj.to_bytes(1, "big", signed=True)
        elif obj >= -0x8000:
            out += b"\xd1" + obj.to_bytes(2, "big", signed=True)
        elif obj >= -0x80000000:
            out += b"\xd2" + obj.to_bytes(4, "big", signed=True)
        elif obj >= -0x8000000000000000:
            out += b"\xd3" + obj.to_bytes(8, "big", signed=True)
        else:
            raise OverflowError("Integer value out of range")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += b"\xd9" + n.to_bytes(1, "big")
        elif n < 0x10000:
            out += b"\xda" + n.to_bytes(2, "big")
        else:
            out += b"\xdb" + n.to_bytes(4, "big")
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 0x100:
            out += b"\xc4" + n.to_bytes(1, "big")
        elif n < 0x10000:
            out += b"\xc5" + n.to_bytes(2, "big")
        else:
            out += b"\xc6" + n.to_bytes(4, "big")
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out += b"\xdc" + n.to_bytes(2, "big")
        else:
            out += b"\xdd" + n.to_bytes(4, "big")
        for v in obj:
            _pack_into(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out += b"\xde" + n.to_bytes(2, "big")
        else:
            out += b"\xdf" + n.to_bytes(4, "big")
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def pure_packb(obj: Any) -> bytes:
    """msgpack encoding of obj in its own map order, as
    `msgpack.packb(obj, use_bin_type=True)` gives it."""
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


# fixed-width heads: code -> (struct format, byte count)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8),
          0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed heads: code -> (kind, length byte count)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("arr", 2), 0xDD: ("arr", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


def _unpack_at(data: bytes, pos: int) -> tuple[Any, int]:
    if pos >= len(data):
        raise ValueError("truncated msgpack data")
    code = data[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x9F:
        kind, n = ("map" if code < 0x90 else "arr"), code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None, pos
    elif code == 0xC2:
        return False, pos
    elif code == 0xC3:
        return True, pos
    elif code in _FIXED:
        fmt, size = _FIXED[code]
        if pos + size > len(data):
            raise ValueError("truncated msgpack data")
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    elif code in _SIZED:
        kind, size = _SIZED[code]
        if pos + size > len(data):
            raise ValueError("truncated msgpack data")
        n = int.from_bytes(data[pos:pos + size], "big")
        pos += size
    elif code == 0xC1:
        raise FormatError("msgpack head byte 0xc1 is never used")
    else:
        raise ValueError(f"unsupported msgpack type 0x{code:02x}")
    if kind in ("str", "bin"):
        if pos + n > len(data):
            raise ValueError("truncated msgpack data")
        raw = data[pos:pos + n]
        return (raw.decode("utf-8") if kind == "str" else raw), pos + n
    if kind == "arr":
        items = []
        for _ in range(n):
            v, pos = _unpack_at(data, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack_at(data, pos)
        v, pos = _unpack_at(data, pos)
        out[k] = v
    return out, pos


def pure_unpackb(data: bytes) -> Any:
    """Inverse of pure_packb, as `msgpack.unpackb(data, raw=False,
    strict_map_key=False)` reads it: arrays come back as lists."""
    data = bytes(data)
    obj, pos = _unpack_at(data, 0)
    if pos != len(data):
        raise ExtraData("unpack(b) received extra data.")
    return obj


try:
    import msgpack as _msgpack
except ImportError:
    _msgpack = None

if _msgpack is not None:
    CODEC = ("msgpack-c" if _msgpack.Packer.__module__.endswith("_cmsgpack")
             else "msgpack-python")

    def packb(obj: Any) -> bytes:
        """msgpack encoding of obj in its own map order."""
        return _msgpack.packb(obj, use_bin_type=True)

    def unpackb(data: bytes) -> Any:
        """Inverse of packb: arrays come back as lists."""
        return _msgpack.unpackb(data, raw=False, strict_map_key=False)
else:
    CODEC = "pure-python"
    packb, unpackb = pure_packb, pure_unpackb


# each public serializer below is a `serde` host span while the span
# recorder is on (common/host_spans.py); pack and unpack, run for every
# message and ledger entry, check the recorder inline, so that off they
# cost one attribute check and no extra call


def pack(obj: Any) -> bytes:
    """Binary wire/ledger serialization (msgpack, deterministic map order)."""
    if _SPANS.on:
        s = _SPANS.begin(_SERDE)
        try:
            return packb(_sort_maps(obj))
        finally:
            _SPANS.end(s)
    return packb(_sort_maps(obj))


def unpack(data: bytes) -> Any:
    if _SPANS.on:
        s = _SPANS.begin(_SERDE)
        try:
            return unpackb(data)
        finally:
            _SPANS.end(s)
    return unpackb(data)


class CanonicalDict(dict):
    """A dict ALREADY in canonical form (str keys sorted, nested values
    canonical): pack()/_sort_maps trust it and skip the deep walk. The
    serialize-once seam for the propagate path — a request's canonical
    form is built once (Request.to_dict) and embedded by reference in
    every hop's message instead of being re-walked per pack (the
    reference re-serializes per send, common/batched.py:20 over
    prepForSending). Immutable, so a shared cached instance can never
    be silently poisoned; build a new dict to change content."""

    def _immutable(self, *a, **k):
        raise TypeError("CanonicalDict is immutable; build a new dict")

    __setitem__ = __delitem__ = __ior__ = _immutable
    update = pop = popitem = clear = setdefault = _immutable


def canonicalize(obj: Any) -> Any:
    """obj -> canonical immutable form (CanonicalDict / tuples), the
    cached-and-shared twin of _sort_maps."""
    if type(obj) is CanonicalDict:
        return obj
    if isinstance(obj, dict):
        keys = list(obj)
        if all(type(k) is str for k in keys):
            keys.sort()
        else:
            keys.sort(key=lambda k: (type(k).__name__, str(k)))
        return CanonicalDict(
            (k, canonicalize(obj[k])
             if isinstance(obj[k], (dict, list, tuple)) else obj[k])
            for k in keys)
    if isinstance(obj, (list, tuple)):
        return tuple(canonicalize(v)
                     if isinstance(v, (dict, list, tuple)) else v
                     for v in obj)
    return obj


def _sort_maps(obj: Any) -> Any:
    if type(obj) is CanonicalDict:
        return obj
    if isinstance(obj, dict):
        keys = list(obj)
        if all(type(k) is str for k in keys):
            keys.sort()               # C-speed for the all-str common case
        else:
            # Non-str/mixed keys keep the HISTORIC canonical order —
            # (type name, str(k)) — so bytes packed by older code compare
            # equal; ingress validation rejects these on wire messages,
            # but internal data may use int keys.
            keys.sort(key=lambda k: (type(k).__name__, str(k)))
        return {k: (_sort_maps(v) if isinstance(v, (dict, list, tuple))
                    else v)
                for k, v in ((k, obj[k]) for k in keys)}
    if isinstance(obj, (list, tuple)):
        return [(_sort_maps(v) if isinstance(v, (dict, list, tuple)) else v)
                for v in obj]
    return obj


@_SPANS.spanning(_SERDE)
def signing_serialize(obj: Any) -> bytes:
    """Canonical JSON used as the message over which signatures are computed."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


@_SPANS.spanning(_SERDE)
def json_dumps(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@_SPANS.spanning(_SERDE)
def json_loads(data) -> Any:
    if isinstance(data, (bytes, bytearray)):
        data = data.decode()
    return json.loads(data)
