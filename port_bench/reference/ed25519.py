"""RFC 8032 Ed25519 verification in plain Python.

Follows the Python code of RFC 8032 section 6 (extended coordinates,
`recover_x`, `point_decompress`), with section 5.1.7's checks: A and R
must decode (a y coordinate of p or more is refused), S must be below L,
and [S]B == R + [k]A with k = SHA-512(R || A || M) mod L. The two
scalar multiplications share one double-and-add pass (Shamir's trick),
which changes the cost and not the result.
"""
from __future__ import annotations

import hashlib

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_GY = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P)
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_GX = _recover_x(_GY, 0)
G = (_GX, _GY, 1, _GX * _GY % P)
IDENTITY = (0, 1, 1, 0)


def point_add(p1, p2):
    a = (p1[1] - p1[0]) * (p2[1] - p2[0]) % P
    b = (p1[1] + p1[0]) * (p2[1] + p2[0]) % P
    c = 2 * p1[3] * p2[3] * D % P
    d = 2 * p1[2] * p2[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_equal(p1, p2) -> bool:
    if (p1[0] * p2[2] - p2[0] * p1[2]) % P != 0:
        return False
    return (p1[1] * p2[2] - p2[1] * p1[2]) % P == 0


def point_decompress(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def point_compress(pt) -> bytes:
    zinv = pow(pt[2], P - 2, P)
    x = pt[0] * zinv % P
    y = pt[1] * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _double_mul(s: int, p1, k: int, p2):
    """[s]p1 + [k]p2 in one double-and-add pass."""
    both = point_add(p1, p2)
    acc = IDENTITY
    for bit in range(max(s.bit_length(), k.bit_length()) - 1, -1, -1):
        acc = point_add(acc, acc)
        sb, kb = (s >> bit) & 1, (k >> bit) & 1
        if sb and kb:
            acc = point_add(acc, both)
        elif sb:
            acc = point_add(acc, p1)
        elif kb:
            acc = point_add(acc, p2)
    return acc


def _negate(pt):
    return ((P - pt[0]) % P, pt[1], pt[2], (P - pt[3]) % P)


def verify(public: bytes, msg: bytes, signature: bytes) -> bool:
    """RFC 8032 section 5.1.7: True iff signature is A's over msg."""
    if len(public) != 32 or len(signature) != 64:
        return False
    a = point_decompress(public)
    if a is None:
        return False
    r = point_decompress(signature[:32])
    if r is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = int.from_bytes(hashlib.sha512(signature[:32] + public + msg).digest(),
                       "little") % L
    # [S]B - [k]A == R
    return point_equal(_double_mul(s, G, k, _negate(a)), r)


def public_key(secret: bytes) -> bytes:
    """The public key of a 32-byte secret (RFC 8032 section 5.1.5); for
    the reference's own test vectors."""
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return point_compress(_double_mul(a, G, 0, G))


def sign(secret: bytes, msg: bytes) -> bytes:
    """RFC 8032 section 5.1.6 signing; for the reference's own tests."""
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    pub = point_compress(_double_mul(a, G, 0, G))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % L
    r_enc = point_compress(_double_mul(r, G, 0, G))
    k = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(),
                       "little") % L
    return r_enc + int.to_bytes((r + k * a) % L, 32, "little")
