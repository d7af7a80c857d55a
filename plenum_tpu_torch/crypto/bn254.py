"""BN254 (alt_bn128) pairing arithmetic, built as an Fq2/Fq6/Fq12 tower.

Replaces the reference's native Hyperledger Ursa dependency
(crypto/bls/indy_crypto/bls_crypto_indy_crypto.py:6-10, Rust/AMCL BN254) with
an in-tree implementation: affine G1/G2 group law, optimal-Ate Miller loop on
twist coordinates with sparse line evaluations, and a split easy/hard final
exponentiation. Scalars and field elements are Python bigints on the host —
pairing stays CPU-side by design; only the batched signature planes
(Ed25519/SHA-256) go to the device (SURVEY.md §7 stage 2).

Curve: y² = x³ + 3 over Fq;  twist: y² = x³ + 3/ξ over Fq2, ξ = 9 + i,
D-type, untwist (x,y) → (x·w², y·w³) with w² = v, v³ = ξ.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

try:
    from plenum_tpu_torch.native import bn254_lib as _NATIVE
except Exception:                      # toolchain missing: pure Python only
    _NATIVE = None

# --- base field --------------------------------------------------------------

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
U = 4965661367192848881              # BN parameter
ATE_LOOP = 6 * U + 2                 # 29793968203157093288
B1 = 3                               # G1 curve coefficient

G1_GEN = (1, 2)
# Standard alt_bn128 G2 generator (x = x0 + x1·i, y = y0 + y1·i)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

Fq2 = Tuple[int, int]


def _inv(a: int) -> int:
    return pow(a, -1, P)


# --- native bridge (encodings match plenum_tpu_torch/native/bn254.cpp) -------------

def _enc_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _dec_g1(data: bytes):
    if data == b"\x00" * 64:
        return None
    return (int.from_bytes(data[:32], "big"), int.from_bytes(data[32:], "big"))


def _enc_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def _dec_g2(data: bytes):
    if data == b"\x00" * 128:
        return None
    vals = [int.from_bytes(data[i:i + 32], "big") for i in range(0, 128, 32)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def _native_call(fn, *args_then_outsize) -> Optional[bytes]:
    """Call fn(*byte_args, out_buffer); None on native failure (falls back)."""
    *args, out_size = args_then_outsize
    buf = ctypes.create_string_buffer(out_size)
    if fn(*args, buf) != 0:
        return None
    return buf.raw


# --- Fq2 = Fq[i]/(i²+1) ------------------------------------------------------

F2_ZERO: Fq2 = (0, 0)
F2_ONE: Fq2 = (1, 0)


def f2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fq2) -> Fq2:
    return (-a[0] % P, -a[1] % P)


def f2_mul(a: Fq2, b: Fq2) -> Fq2:
    # Karatsuba: (a0+a1 i)(b0+b1 i) with i² = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a: Fq2) -> Fq2:
    # (a0+a1 i)² = (a0+a1)(a0-a1) + 2 a0 a1 i
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def f2_scalar(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a: Fq2) -> Fq2:
    return (a[0], -a[1] % P)


def f2_inv(a: Fq2) -> Fq2:
    # 1/(a0+a1 i) = conj / (a0²+a1²)
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, -a[1] * d % P)


def f2_pow(a: Fq2, e: int) -> Fq2:
    out = F2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sqr(a)
        e >>= 1
    return out


XI: Fq2 = (9, 1)                     # the sextic-twist non-residue


def f2_mul_xi(a: Fq2) -> Fq2:
    # (a0 + a1 i)(9 + i) = 9a0 - a1 + (a0 + 9a1) i
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


# --- Fq6 = Fq2[v]/(v³-ξ) -----------------------------------------------------

Fq6 = Tuple[Fq2, Fq2, Fq2]
F6_ZERO: Fq6 = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE: Fq6 = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a: Fq6, b: Fq6) -> Fq6:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fq6, b: Fq6) -> Fq6:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fq6) -> Fq6:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fq6, b: Fq6) -> Fq6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)),
                                     f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
                f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a: Fq6) -> Fq6:
    return f6_mul(a, a)


def f6_mul_v(a: Fq6) -> Fq6:
    """Multiply by v: (c0,c1,c2) → (ξ·c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a: Fq6) -> Fq6:
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0),
                      f2_add(f2_mul_xi(f2_mul(a2, c1)), f2_mul_xi(f2_mul(a1, c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


# --- Fq12 = Fq6[w]/(w²-v) ----------------------------------------------------

Fq12 = Tuple[Fq6, Fq6]
F12_ONE: Fq12 = (F6_ONE, F6_ZERO)


def f12_mul(a: Fq12, b: Fq12) -> Fq12:
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a: Fq12) -> Fq12:
    a0, a1 = a
    t = f6_mul(a0, a1)
    c0 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1))),
                f6_add(t, f6_mul_v(t)))
    return (c0, f6_add(t, t))


def f12_inv(a: Fq12) -> Fq12:
    a0, a1 = a
    t = f6_inv(f6_sub(f6_sqr(a0), f6_mul_v(f6_sqr(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(a: Fq12) -> Fq12:
    """a^(p⁶): conjugation over Fq6 (negate the w-odd half)."""
    return (a[0], f6_neg(a[1]))


def f12_pow(a: Fq12, e: int) -> Fq12:
    if e < 0:
        return f12_pow(f12_conj(a), -e)  # valid only for unitary elements
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sqr(a)
        e >>= 1
    return out


# Frobenius coefficients: γ1[j] = ξ^(j(p-1)/6), j = 1..5 (computed once).
_G1C = [f2_pow(XI, j * (P - 1) // 6) for j in range(6)]
_G2C = [f2_mul(f2_conj(c), c) for c in _G1C]          # γ2[j] = γ1[j]^(p+1) — norm, in Fq
_G3C = [f2_mul(f2_conj(_G2C[j]), _G1C[j]) for j in range(6)]


def f12_frobenius(a: Fq12, power: int = 1) -> Fq12:
    """a^(p^power) for power in {1, 2, 3}."""
    coeffs = (None, _G1C, _G2C, _G3C)[power]
    conj = power % 2 == 1
    # a = Σ_{j=0..5} c_j · w^j with c_j ∈ Fq2 laid out as:
    # w⁰→a0.c0, w¹→a1.c0, w²→a0.c1, w³→a1.c1, w⁴→a0.c2, w⁵→a1.c2
    (c0, c2, c4), (c1, c3, c5) = a
    cs = [c0, c1, c2, c3, c4, c5]
    out = []
    for j, c in enumerate(cs):
        if conj:
            c = f2_conj(c)
        if j:
            c = f2_mul(c, coeffs[j])
        out.append(c)
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


# --- G1 (affine, None = infinity) -------------------------------------------

G1Point = Optional[Tuple[int, int]]


def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % P == 0


def g1_add(a: G1Point, b: G1Point) -> G1Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(a: G1Point) -> G1Point:
    return None if a is None else (a[0], -a[1] % P)


def g1_mul(a: G1Point, k: int) -> G1Point:
    k %= R
    if _NATIVE is not None and a is not None and k:
        out = _native_call(_NATIVE.pc_g1_mul, _enc_g1(a),
                           k.to_bytes(32, "big"), 64)
        if out is not None:
            return _dec_g1(out)
    out: G1Point = None
    while k:
        if k & 1:
            out = g1_add(out, a)
        a = g1_add(a, a)
        k >>= 1
    return out


# --- G2 (affine on the twist, None = infinity) -------------------------------

G2Point = Optional[Tuple[Fq2, Fq2]]
B2: Fq2 = f2_mul((3, 0), f2_inv(XI))


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == F2_ZERO


def g2_add(a: G2Point, b: G2Point) -> G2Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sqr(lam), f2_add(x1, x2))
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(a: G2Point) -> G2Point:
    return None if a is None else (a[0], f2_neg(a[1]))


def g2_mul(a: G2Point, k: int) -> G2Point:
    k %= R
    if _NATIVE is not None and a is not None and k:
        out = _native_call(_NATIVE.pc_g2_mul, _enc_g2(a),
                           k.to_bytes(32, "big"), 128)
        if out is not None:
            return _dec_g2(out)
    out: G2Point = None
    while k:
        if k & 1:
            out = g2_add(out, a)
        a = g2_add(a, a)
        k >>= 1
    return out


def g2_in_subgroup(pt: G2Point) -> bool:
    if not g2_is_on_curve(pt):
        return False
    if _NATIVE is not None and pt is not None:
        return bool(_NATIVE.pc_g2_in_subgroup(_enc_g2(pt)))
    return g2_mul(pt, R) is None


def g2_frobenius(pt: G2Point) -> G2Point:
    """π(x,y) = (x̄·ξ^((p-1)/3), ȳ·ξ^((p-1)/2)) — the untwist-Frobenius-twist map."""
    if pt is None:
        return None
    x, y = pt
    return (f2_mul(f2_conj(x), _FROB_X), f2_mul(f2_conj(y), _FROB_Y))


_FROB_X = f2_pow(XI, (P - 1) // 3)
_FROB_Y = f2_pow(XI, (P - 1) // 2)


# --- pairing -----------------------------------------------------------------

def _line(t: G2Point, q: G2Point, p1: Tuple[int, int]) -> Fq12:
    """Sparse Fq12 value of the line through T and Q (on the twist), evaluated
    at the G1 point P. Layout per untwist (x·w², y·w³):
    l = -yP + (λ'xP)·w + (yT' - λ'xT')·w³."""
    xp, yp = p1
    xt, yt = t
    if t == q:
        lam = f2_mul(f2_scalar(f2_sqr(xt), 3), f2_inv(f2_scalar(yt, 2)))
    elif xt == q[0]:
        # vertical line: l = xP - xT·w²
        return (((xp, 0), f2_neg(xt), F2_ZERO), F6_ZERO)
    else:
        lam = f2_mul(f2_sub(q[1], yt), f2_inv(f2_sub(q[0], xt)))
    c0: Fq2 = (-yp % P, 0)
    c1 = f2_scalar(lam, xp)
    c3 = f2_sub(yt, f2_mul(lam, xt))
    return ((c0, F2_ZERO, F2_ZERO), (c1, c3, F2_ZERO))


def miller_loop(q: G2Point, p1: G1Point) -> Fq12:
    if q is None or p1 is None:
        return F12_ONE
    f = F12_ONE
    t = q
    for i in range(ATE_LOOP.bit_length() - 2, -1, -1):
        f = f12_mul(f12_sqr(f), _line(t, t, p1))
        t = g2_add(t, t)
        if (ATE_LOOP >> i) & 1:
            f = f12_mul(f, _line(t, q, p1))
            t = g2_add(t, q)
    q1 = g2_frobenius(q)
    q2 = g2_neg(g2_frobenius(q1))
    f = f12_mul(f, _line(t, q1, p1))
    t = g2_add(t, q1)
    f = f12_mul(f, _line(t, q2, p1))
    return f


_HARD_EXP = (P ** 4 - P ** 2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((p⁶-1)(p²+1))
    f = f12_mul(f12_conj(f), f12_inv(f))          # f^(p⁶-1); result is unitary
    f = f12_mul(f12_frobenius(f, 2), f)           # ^(p²+1)
    # hard part: plain square-and-multiply over (p⁴-p²+1)/r
    return f12_pow(f, _HARD_EXP)


def pairing(q: G2Point, p1: G1Point) -> Fq12:
    return final_exponentiation(miller_loop(q, p1))


def multi_pairing(pairs) -> Fq12:
    """∏ e(Qᵢ, Pᵢ) with a single shared final exponentiation."""
    f = F12_ONE
    for q, p1 in pairs:
        f = f12_mul(f, miller_loop(q, p1))
    return final_exponentiation(f)


# Process-wide pairing accounting. A pairing is the unit the commit path's
# cost is measured in (~2.6 ms native, ~100x that pure-Python), so the
# counters are cheap ints bumped once per check: `checks` = pairing_check
# calls, `pairings` = Miller loops inside them, split by which engine ran.
# Readers (bls_bft_replica's per-batch delta, the node's flush gauges) take
# snapshots; nothing resets these during a process lifetime.
PAIRING_STATS = {"checks": 0, "pairings": 0, "native": 0, "python": 0}


def pairing_check(pairs) -> bool:
    """True iff ∏ e(Qᵢ, Pᵢ) == 1 — the shape every BLS verification reduces to.

    Dispatches to the in-tree C++ library (plenum_tpu_torch/native/bn254.cpp) when
    it built: the aggregate COMMIT check sits on the 3PC hot path, and the
    native multi-pairing is ~20× the pure-Python one. Falls back to the
    Python twin (the differential-testing reference) otherwise."""
    pairs = list(pairs)
    PAIRING_STATS["checks"] += 1
    PAIRING_STATS["pairings"] += len(pairs)
    if _NATIVE is not None:
        g2_bytes = b"".join(_enc_g2(q) for q, _ in pairs)
        g1_bytes = b"".join(_enc_g1(p) for _, p in pairs)
        res = _NATIVE.pc_pairing_check(g2_bytes, g1_bytes, len(pairs))
        if res >= 0:          # -1 = malformed input: let Python decide
            PAIRING_STATS["native"] += len(pairs)
            return bool(res)
    PAIRING_STATS["python"] += len(pairs)
    return multi_pairing(pairs) == F12_ONE


# --- hashing to G1 -----------------------------------------------------------

def g1_from_x(x: int) -> G1Point:
    """Lift x to a curve point if x³+3 is a QR (p ≡ 3 mod 4)."""
    y2 = (x * x * x + B1) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    return (x, y)


def hash_to_g1(data: bytes, domain: bytes = b"") -> Tuple[int, int]:
    """Try-and-increment hashing; deterministic, ~2 attempts expected."""
    import hashlib
    counter = 0
    while True:
        h = hashlib.sha256(domain + counter.to_bytes(4, "big") + data).digest()
        x = int.from_bytes(h, "big") % P
        pt = g1_from_x(x)
        if pt is not None:
            # canonicalize sign from one more hash bit for determinism
            if h[0] & 1:
                pt = g1_neg(pt)
            return pt
        counter += 1
