"""Serialization the checks need, frozen for the benchmark.

- msgpack: the encoding of msgpack's own specification, as
  `msgpack.packb(obj, use_bin_type=True)` writes it, with str-keyed maps
  sorted by key (indy-plenum's `serialization.ledger_txn_serializer`
  writes ledger leaves and state values so), and its inverse. Written
  from the specification; it covers nil, bool, int, float, str, bin,
  array and map.
- canonical JSON: `json.dumps(sort_keys=True, separators=(",", ":"),
  ensure_ascii=False)`, indy-plenum's `serialization.
  serialize_msg_for_signing` for the bytes a client signs.
- base58 with the Bitcoin alphabet, and indy's DID: base58 of a key's
  first 16 bytes.
- a request's digest: SHA-256 of the canonical JSON of the signed
  payload with its signature (indy-plenum `common/request.py`).
"""
from __future__ import annotations

import hashlib
import json
import struct

_B58 = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(_B58)}


def b58encode(raw: bytes) -> str:
    n = int.from_bytes(raw, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(_B58[r])
    pad = len(raw) - len(raw.lstrip(b"\0"))
    return "1" * pad + "".join(reversed(out))


def b58decode(text: str) -> bytes:
    n = 0
    for c in text:
        n = n * 58 + _B58_INDEX[c]
    pad = len(text) - len(text.lstrip("1"))
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    return b"\0" * pad + body


def did_of(verkey: bytes) -> str:
    return b58encode(verkey[:16])


def signing_bytes(payload: dict) -> bytes:
    """The canonical JSON a client signs."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode()


def request_digest(signed: dict) -> str:
    """Hex digest of a signed request dict (payload plus signature)."""
    return hashlib.sha256(signing_bytes(signed)).hexdigest()


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for head, size in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if obj < 1 << (8 * size):
                    out.append(head)
                    out += obj.to_bytes(size, "big")
                    return
            raise OverflowError(obj)
        else:
            for head, size in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if obj >= -(1 << (8 * size - 1)):
                    out.append(head)
                    out += obj.to_bytes(size, "big", signed=True)
                    return
            raise OverflowError(obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        _head(out, len(obj.encode()), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += obj.encode()
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += bytes(obj)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        keys = list(obj)
        if all(isinstance(k, str) for k in keys):
            keys.sort()
        for k in keys:
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(type(obj).__name__)


def _head(out: bytearray, n: int, fix, fix_max: int, heads) -> None:
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for head, size in zip(heads, (1, 2, 4)):
        if head is not None and n < 1 << (8 * size):
            out.append(head)
            out += n.to_bytes(size, "big")
            return
    raise OverflowError(n)


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("arr", 2), 0xDD: ("arr", 4), 0xDE: ("map", 2),
          0xDF: ("map", 4)}


def _unpack(data: bytes, pos: int):
    code = data[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code <= 0x9F:
        kind, n = ("map" if code < 0x90 else "arr"), code & 0x0F
    elif code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], pos
    elif code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    elif code in _SIZED:
        kind, size = _SIZED[code]
        n = int.from_bytes(data[pos:pos + size], "big")
        pos += size
    else:
        raise ValueError(f"msgpack head 0x{code:02x}")
    if kind in ("str", "bin"):
        raw = data[pos:pos + n]
        if len(raw) != n:
            raise ValueError("truncated msgpack")
        return (raw.decode() if kind == "str" else raw), pos + n
    if kind == "arr":
        items = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        out[k], pos = _unpack(data, pos)
    return out, pos


def unpackb(data: bytes):
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError("extra bytes after msgpack object")
    return obj
