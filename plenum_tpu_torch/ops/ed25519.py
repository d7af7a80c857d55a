"""Batched Ed25519 verification: CUDA kernels, plain versions, host helpers.

Counterpart of the JAX package's ops/ed25519.py. Verification of a batch
of (S, h, R, key) checks compress([S]B + [h](-A)) == R bytes, cofactorless
and ref10-style: a non-canonical R fails the byte compare, and keys are
rejected when y >= p, when off the curve, or when x = 0 with the sign bit
set. `S < L` and h = SHA512(R || A || M) mod L stay on the host
(crypto/ed25519.py, `_dispatch_bytes`).

Four kernels (csrc/ed25519.cu) carry the device half, two for each of
the reference's two dispatches:

  K3 `decompress_kernel`  one thread per distinct key: RFC 8032 §5.1.3
      decompression and validity, the quarter points [2^(64k)](-A) for
      k = 0..3 (192 doublings), and each quarter's 16-entry window table.
  K4 `verify_tables`      one thread per signature: unpacks S, h and R
      bytes, gathers its key's tables by idx and the fixed-base comb
      table by S byte, runs 16 windows x (4 doublings + 4 additions) and
      32 comb additions, inverts Z once and compares with R.
  K5 `quarter_tables`     the limb-staged dispatch's keys: one thread per
      host-staged row of quarter points (the reference's 13-bit limbs,
      `ext_quarters`), converted and built into K3's table layout.
  K6 `verify_staged`      the limb-staged dispatch's signatures: K4's
      ladder on the reference's staged digit arrays (batch axis last),
      R compared as 13-bit limbs exactly as given.

`verify_kernel_bytes` is K3 then K4 (B1); `verify_kernel` and
`verify_kernel_indexed` are K5 then K6 (B3).

Field elements (device and plain versions alike) are 10 signed limbs in
radix 2^25.5 (ref10's layout: limb i sits at bit POS[i], 26 or 25 bits
wide), int32 in memory, multiplied in int64. The JAX package's 20x13-bit
limbs were a TPU artefact (its VPU lacks int64); this layout has Hopper's
32x32->64 multiply do the work. The plain versions below run exactly the
kernels' sequence of limb operations, so kernel and plain version agree
limb for limb, not only modulo p.

"Carried" limbs satisfy |limb| < 2^26 + 2^7. fe_mul/fe_sq take carried
inputs: every product is then below 2^57.3 and a 10-term sum below 2^61,
inside int64; three carry passes bring the result back to carried form.
fe_add/fe_sub of carried inputs need one pass.

The host half (constants, pure-Python curve helpers, the reference's
13-bit limb helpers and comb table) is copied from the JAX package so that
the port imports nothing of it.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from plenum_tpu_torch import ops

# --- curve constants (RFC 8032) ------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960

# the JAX package's limb layout (host helpers and b_comb_table keep it)
NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1

WBITS = 4               # window width for the variable point A
N_WIN = 16              # windows per 64-bit quarter of h
N_QUARTERS = 4
QUARTER_SHIFT = 64      # h = sum_k 2^(64k) * h_k
CBITS = 8               # comb digit width for the fixed base B
N_COMB = 32             # comb positions for the 256-bit S

# --- the port's limb layout: 10 limbs, radix 2^25.5 -----------------------

FE_LIMBS = 10
FE_POS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
FE_BITS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)


def int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMB)],
                    dtype=np.int32)


def limbs_to_int(l) -> int:
    arr = np.asarray(l)
    return sum(int(v) << (RADIX * i) for i, v in enumerate(arr))


def fe_from_int(x: int) -> list[int]:
    """Canonical 10-limb form of x mod p."""
    x %= P
    return [(x >> FE_POS[i]) & ((1 << FE_BITS[i]) - 1) for i in range(FE_LIMBS)]


def fe_to_int(limbs) -> int:
    """Value (not reduced) of 10 signed limbs, e.g. a tensor row."""
    vals = limbs.tolist() if hasattr(limbs, "tolist") else list(limbs)
    return sum(int(v) << FE_POS[i] for i, v in enumerate(vals))


# --- plain versions: field arithmetic on int64 tensors [..., 10] ----------

def _mul_tables():
    """Schoolbook weights m[i][j] (2 when both limbs odd — their positions
    sum one bit past the target limb's; 19 when i + j >= 10 — 2^255 = 19)
    and the gather index: h_k sums prod[i, (k - i) mod 10] over i."""
    mult = [[(2 if i & 1 and j & 1 else 1) * (19 if i + j >= 10 else 1)
             for j in range(FE_LIMBS)] for i in range(FE_LIMBS)]
    gather = [[i * FE_LIMBS + (k - i) % FE_LIMBS for i in range(FE_LIMBS)]
              for k in range(FE_LIMBS)]
    return mult, gather


_MULT, _GATHER = _mul_tables()
_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        vals = {"mult": _MULT, "gather": _GATHER,
                "d": fe_from_int(D), "d2": fe_from_int(D2),
                "sqrt_m1": fe_from_int(SQRT_M1), "one": fe_from_int(1),
                "zero": fe_from_int(0), "bits": FE_BITS,
                "mask": [(1 << b) - 1 for b in FE_BITS],
                "wrap": [19] + [1] * (FE_LIMBS - 1)}[name]
        t = _CONSTS[key] = torch.tensor(vals, dtype=torch.int64, device=device)
    return t


def fe_carry(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass: limb i keeps its low FE_BITS[i] bits and
    takes limb i-1's carry; limb 9's carry wraps to limb 0 times 19."""
    c = h >> _const("bits", h.device)
    return ((h & _const("mask", h.device))
            + torch.roll(c, 1, -1) * _const("wrap", h.device))


def fe_add(f, g):
    return fe_carry(f + g)


def fe_sub(f, g):
    return fe_carry(f - g)


def fe_mul(f, g):
    f, g = torch.broadcast_tensors(f, g)
    prod = f.unsqueeze(-1) * g.unsqueeze(-2) * _const("mult", f.device)
    flat = prod.reshape(*prod.shape[:-2], FE_LIMBS * FE_LIMBS)
    h = flat[..., _const("gather", f.device)].sum(-1)
    return fe_carry(fe_carry(fe_carry(h)))


def fe_sq(f):
    return fe_mul(f, f)


def _pow2k(z, k: int):
    for _ in range(k):
        z = fe_sq(z)
    return z


def _chain_250(z):
    """Shared prefix of the curve25519 exponentiation chains:
    -> (z^(2^250 - 1), z^11)."""
    z2 = fe_sq(z)                                     # 2
    z9 = fe_mul(_pow2k(z2, 2), z)                     # 9
    z11 = fe_mul(z9, z2)                              # 11
    z_5 = fe_mul(fe_sq(z11), z9)                      # 2^5 - 1
    z_10 = fe_mul(_pow2k(z_5, 5), z_5)                # 2^10 - 1
    z_20 = fe_mul(_pow2k(z_10, 10), z_10)             # 2^20 - 1
    z_40 = fe_mul(_pow2k(z_20, 20), z_20)             # 2^40 - 1
    z_50 = fe_mul(_pow2k(z_40, 10), z_10)             # 2^50 - 1
    z_100 = fe_mul(_pow2k(z_50, 50), z_50)            # 2^100 - 1
    z_200 = fe_mul(_pow2k(z_100, 100), z_100)         # 2^200 - 1
    return fe_mul(_pow2k(z_200, 50), z_50), z11       # 2^250 - 1


def fe_inv(z):
    """z^(p-2): 254 squarings + 11 multiplies."""
    z_250, z11 = _chain_250(z)
    return fe_mul(_pow2k(z_250, 5), z11)


def fe_pow_p58(z):
    """z^((p-5)/8) = z^(2^252 - 3), the RFC 8032 square-root exponent."""
    z_250, _ = _chain_250(z)
    return fe_mul(_pow2k(z_250, 2), z)


def _normalize(h: list) -> list:
    """Sequential carry over a list of limb tensors, 2^255 -> 19 wrap."""
    for i in range(FE_LIMBS):
        c = h[i] >> FE_BITS[i]
        h[i] = h[i] & ((1 << FE_BITS[i]) - 1)
        if i < FE_LIMBS - 1:
            h[i + 1] = h[i + 1] + c
        else:
            h[0] = h[0] + 19 * c
    return h


def _ge_p(h: list) -> torch.Tensor:
    """1 where the normalized limbs' value v (< 2^255) is >= p, i.e. where
    v + 19 reaches 2^255."""
    q = (h[0] + 19) >> 26
    for i in range(1, FE_LIMBS):
        q = (h[i] + q) >> FE_BITS[i]
    return q


def fe_canon(f):
    """The unique limbs of the value mod p: every limb in [0, 2^bits).
    Adding p first lifts the (small) negative limbs of carried form."""
    h = [f[..., i] + v for i, v in enumerate(fe_from_int(P - 1))]
    h[0] = h[0] + 1                                   # + p in all
    for _ in range(3):
        h = _normalize(h)
    q = _ge_p(h)
    h[0] = h[0] + 19 * q
    for i in range(FE_LIMBS - 1):
        c = h[i] >> FE_BITS[i]
        h[i] = h[i] & ((1 << FE_BITS[i]) - 1)
        h[i + 1] = h[i + 1] + c
    h[9] = h[9] & ((1 << 25) - 1)
    return torch.stack(h, dim=-1)


def bytes_to_fe(u8: torch.Tensor) -> torch.Tensor:
    """uint8[..., 32] little-endian -> int64[..., 10] limbs of the low 255
    bits (bit 255, the sign, is dropped; the value is NOT reduced)."""
    b = u8.to(torch.int64)
    limbs = []
    for i in range(FE_LIMBS):
        lo = FE_POS[i] // 8
        v = b[..., lo]
        for k in range(1, 5):
            if lo + k < 32:
                v = v | (b[..., lo + k] << (8 * k))
        limbs.append((v >> (FE_POS[i] % 8)) & ((1 << FE_BITS[i]) - 1))
    return torch.stack(limbs, dim=-1)


def _limb13_plan() -> list[tuple[int, int]]:
    """For each 13-bit limb i (at bit 13 i): the limb j of the port's
    layout it lands in (FE_POS[j] <= 13 i) and its shift inside it."""
    plan = []
    for i in range(NLIMB):
        b = RADIX * i
        j = max(k for k in range(FE_LIMBS) if FE_POS[k] <= b)
        plan.append((j, b - FE_POS[j]))
    return plan


_LIMB13 = _limb13_plan()


def limbs13_to_fe(l: torch.Tensor) -> torch.Tensor:
    """The reference's 20 signed 13-bit limbs [..., 20] (carried, in
    [-2, 2^13 + 3], or canonical) -> int64[..., 10] carried limbs of the
    same value mod p (fe_from_limbs13 in csrc/fe25519.cuh): the terms
    l_i 2^(13 i) are summed into the limb they fall in, signs kept, then
    three carry passes; the bits at 2^255 and up wrap as 19."""
    l = l.to(torch.int64)
    t = [torch.zeros_like(l[..., 0]) for _ in range(FE_LIMBS)]
    for i, (j, shift) in enumerate(_LIMB13):
        t[j] = t[j] + l[..., i] * (1 << shift)
    return fe_carry(fe_carry(fe_carry(torch.stack(t, dim=-1))))


def fe_to_limbs13(f: torch.Tensor) -> torch.Tensor:
    """Canonical limbs [..., 10] (fe_canon's output) -> the 20 canonical
    13-bit limbs of the same value (fe_to_limbs13_canon)."""
    out = []
    for i, (j, shift) in enumerate(_LIMB13):
        v = f[..., j] >> shift
        if j < FE_LIMBS - 1:
            v = v | (f[..., j + 1] << (FE_POS[j + 1] - RADIX * i))
        out.append(v & MASK)
    return torch.stack(out, dim=-1)


# --- point ops: extended twisted Edwards (X:Y:Z:T), a = -1 ----------------
# A point is a tuple of 4 carried field tensors. Identity is (0, 1, 1, 0).
# Independent field operations of one formula run as one call on stacked
# operands: each row gets exactly the limb operations the kernel gives it
# (a carry pass and a product are row-wise), in fewer PyTorch calls.

def _stack(*fs) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*fs))


def _muls(fs, gs) -> tuple:
    """fe_mul of each pair (f_i, g_i), as one call."""
    return fe_mul(_stack(*fs), _stack(*gs)).unbind(0)


def _finish(e, f_, g, h):
    """The common tail of the formulas: (e f, g h, f g, e h)."""
    return _muls((e, g, f_, e), (f_, h, g, h))


def _add_tail(a, b, c, d):
    """e = b - a, f = d - c, g = d + c, h = b + a, one carry pass each,
    then the tail."""
    return _finish(*fe_carry(_stack(b - a, d - c, d + c, b + a)).unbind(0))


def pt_add(p1, p2):
    """Unified addition (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    u1 = fe_carry(_stack(y1 - x1, y1 + x1)).unbind(0)
    u2 = fe_carry(_stack(y2 - x2, y2 + x2)).unbind(0)
    a, b, tt, zz = _muls((u1[0], u1[1], t1, z1), (u2[0], u2[1], t2, z2))
    c = fe_mul(tt, _const("d2", t1.device))
    return _add_tail(a, b, c, fe_add(zz, zz))


def pt_add_t2d(p1, q):
    """Addition where q carries 2d*T in place of T."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2d2 = q
    u1 = fe_carry(_stack(y1 - x1, y1 + x1)).unbind(0)
    u2 = fe_carry(_stack(y2 - x2, y2 + x2)).unbind(0)
    a, b, c, zz = _muls((u1[0], u1[1], t1, z1), (u2[0], u2[1], t2d2, z2))
    return _add_tail(a, b, c, fe_add(zz, zz))


def pt_madd(p1, ypx, ymx, t2d):
    """Mixed addition with an affine niels point (y+x, y-x, 2d*x*y)."""
    x1, y1, z1, t1 = p1
    u1 = fe_carry(_stack(y1 - x1, y1 + x1)).unbind(0)
    a, b, c = _muls((u1[0], u1[1], t1), (ymx, ypx, t2d))
    return _add_tail(a, b, c, fe_add(z1, z1))


def pt_double(p1):
    """dbl-2008-hwcd for a = -1: 4 squarings + 4 multiplies."""
    x1, y1, z1, _ = p1
    sq_in = _stack(x1, y1, z1, fe_add(x1, y1))
    a, b, zz, s = fe_sq(sq_in).unbind(0)
    c, h, g = fe_carry(_stack(zz + zz, a + b, a - b)).unbind(0)
    e = fe_sub(h, s)
    return _finish(e, fe_add(c, g), g, h)


def _identity(shape, device):
    zero = _const("zero", device).expand(*shape, FE_LIMBS)
    one = _const("one", device).expand(*shape, FE_LIMBS)
    return (zero, one, one, zero)


# --- plain version of K3: decompress, quarters, window tables -------------

def decompress_torch(keys_u8: torch.Tensor):
    """Plain version of K3. keys_u8: uint8[U, 32] ->
      quarters int32[U, 4, 4, 10]: [2^(64k)](-A), k = 0..3, as (X, Y, Z, T)
      tables   int32[U, 4, 16, 4, 10]: per quarter, entry d = [d]quarter
               as (X, Y, Z, 2d*T), entry 0 the identity
      valid    bool[U]."""
    dev = keys_u8.device
    u_ = keys_u8.shape[0]
    sign = keys_u8[:, 31].to(torch.int64) >> 7
    y = bytes_to_fe(keys_u8)
    noncanon = _ge_p(list(y.unbind(-1))) == 1
    one = _const("one", dev).expand(u_, FE_LIMBS)
    y2 = fe_sq(y)
    u = fe_sub(y2, one)
    v = fe_add(fe_mul(y2, _const("d", dev)), one)
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    vxx = fe_mul(v, fe_sq(x))
    ok1 = (fe_canon(fe_sub(vxx, u)) == 0).all(-1)      # v x^2 =  u
    ok2 = (fe_canon(fe_add(vxx, u)) == 0).all(-1)      # v x^2 = -u
    x = torch.where(ok1[:, None], x, fe_mul(x, _const("sqrt_m1", dev)))
    xc = fe_canon(x)
    x_zero = (xc == 0).all(-1)
    neg_xc = fe_canon(fe_sub(_const("zero", dev).expand(u_, FE_LIMBS), xc))
    flip = (xc[:, 0] & 1) != sign
    # A = (x with the sign bit's parity, y); the ladder wants -A = (-x, y)
    negx = torch.where(flip[:, None], xc, neg_xc)
    valid = (ok1 | ok2) & ~noncanon & ~(x_zero & (sign == 1))
    pt = (negx, y, one, fe_mul(negx, y))
    quarters = [pt]
    for _ in range(N_QUARTERS - 1):
        for _ in range(QUARTER_SHIFT):
            pt = pt_double(pt)
        quarters.append(pt)
    quarters_t = torch.stack([torch.stack(q, dim=1) for q in quarters], dim=1)
    return (quarters_t.to(torch.int32), build_tables_torch(quarters_t),
            valid)


def build_tables_torch(quarters: torch.Tensor) -> torch.Tensor:
    """[U, 4, 4, 10] quarter points -> [U, 4, 16, 4, 10] window tables:
    tab[1] = q, tab[2k] = dbl(tab[k]), tab[2k+1] = tab[2k] + q, then T is
    replaced by 2d*T in every entry."""
    q = quarters.to(torch.int64)
    q = tuple(q[:, :, c] for c in range(4))               # each [U, 4, 10]
    tab = [_identity(q[0].shape[:-1], q[0].device), q]
    for k in range(1, 8):
        dbl = pt_double(tab[k])
        tab.append(dbl)
        tab.append(pt_add(dbl, q))
    d2 = _const("d2", q[0].device)
    rows = [torch.stack((x, y, z, fe_mul(t, d2)), dim=2) for x, y, z, t in tab]
    return torch.stack(rows, dim=2).to(torch.int32)


# --- plain version of K4: the ladder and the compare ----------------------

def h_digits(h_u8: torch.Tensor) -> torch.Tensor:
    """uint8[N, 32] little-endian h -> int64[N, 4, 16] nibble windows:
    quarter q is bytes 8q..8q+7, window t its nibble t."""
    hb = h_u8.to(torch.int64).reshape(-1, N_QUARTERS, 8)
    return torch.stack([hb & 0xF, hb >> 4], dim=-1).reshape(
        -1, N_QUARTERS, N_WIN)


def _ladder(h_dig, s_dig, tab):
    """The ladder K4 and K6 share: [S]B + [h](-A) from h's windows
    h_dig [N, 4, 16] (quarter q, window t, LSB first), S's comb digits
    s_dig [N, 32] and each signature's tables tab [N, 4, 16, 4, 10];
    -> canonical affine (x, y), int64[N, 10] each."""
    dev = tab.device
    n = tab.shape[0]
    rows = torch.arange(n, device=dev)
    acc = _identity((n,), dev)
    for t in range(N_WIN - 1, -1, -1):                   # MSB-first windows
        for _ in range(WBITS):
            acc = pt_double(acc)
        for q in range(N_QUARTERS):
            sel = tab[rows, q, h_dig[:, q, t]]           # [N, 4, 10]
            acc = pt_add_t2d(acc, sel.unbind(1))
    comb = comb_table_fe(dev)                            # [32, 256, 3, 10]
    for w in range(N_COMB):
        ypx, ymx, t2d = comb[w, s_dig[:, w]].unbind(1)
        acc = pt_madd(acc, ypx, ymx, t2d)
    px, py, pz, _ = acc
    zinv = fe_inv(pz)
    return fe_canon(fe_mul(px, zinv)), fe_canon(fe_mul(py, zinv))


def verify_tables_torch(s_u8, h_u8, r_u8, idx, tables, valid):
    """Plain version of K4 -> bool[N]: compress([S]B + [h](-A)) == R,
    with A's tables gathered by idx; False where the key is invalid."""
    tab = tables.to(torch.int64)[idx.long()]             # [N, 4, 16, 4, 10]
    x_aff, y_aff = _ladder(h_digits(h_u8), s_u8.long(), tab)
    ok_y = (y_aff == bytes_to_fe(r_u8)).all(-1)
    ok_sign = (x_aff[:, 0] & 1) == (r_u8[:, 31].to(torch.int64) >> 7)
    return ok_y & ok_sign & valid[idx.long()]


def verify_kernel_bytes_torch(s_u8, h_u8, keys_u8, idx, r_u8):
    """Plain version of verify_kernel_bytes (K3 then K4)."""
    _, tables, valid = decompress_torch(keys_u8)
    return verify_tables_torch(s_u8, h_u8, r_u8, idx, tables, valid)


# --- plain versions of K5 and K6: the limb-staged dispatch ----------------

def quarter_tables_torch(aq: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: the reference's staged quarter points
    int32[U, 4, 4, 20] (13-bit limbs, projective) -> window tables
    int32[U, 4, 16, 4, 10] in K3's layout."""
    return build_tables_torch(limbs13_to_fe(aq))


def verify_staged_torch(s_digits, h_digits, ry, r_sign, idx, tables):
    """Plain version of K6 -> bool[N].

    s_digits int32[32, N] and h_digits int32[16, 4, N] are the
    reference's staged digits (batch axis last; taken mod 256 and 16),
    ry int32[N, 20] and r_sign int32[N] R's y limbs and sign as staged,
    idx int32[N] each signature's row of tables (K5's output). True where
    canonical y', written as 13-bit limbs, equals ry limb for limb and
    x's parity equals r_sign; False where idx is outside [0, U)."""
    n = idx.shape[0]
    u_ = tables.shape[0]
    idx_l = idx.long()
    in_range = (idx_l >= 0) & (idx_l < u_)
    if n == 0 or u_ == 0:
        return torch.zeros((n,), dtype=torch.bool, device=idx.device)
    tab = tables.to(torch.int64)[torch.where(in_range, idx_l, 0)]
    h_dig = h_digits.long().permute(2, 1, 0) & 15        # [N, 4, 16]
    s_dig = s_digits.long().T & 255                      # [N, 32]
    x_aff, y_aff = _ladder(h_dig, s_dig, tab)
    ok_y = (fe_to_limbs13(y_aff) == ry.long()).all(-1)
    ok_sign = (x_aff[:, 0] & 1) == r_sign.long()
    return ok_y & ok_sign & in_range


# --- kernel wrappers (csrc/ed25519.cu) -------------------------------------

_CONFIGURED = False

# K3-K6 run each key or signature on four lanes (a quad), in blocks of
# THREADS_PER_BLOCK threads (a multiple of 4, at most 128; read at every
# launch): 32 was the fastest or tied for all four on the H100
THREADS_PER_ITEM = 4
THREADS_PER_BLOCK = 32


def lib() -> ctypes.CDLL:
    """csrc/ed25519.cu's library, its launchers' signatures set."""
    global _CONFIGURED
    cdll = ops.lib("ed25519")
    if not _CONFIGURED:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cdll.ed25519_decompress_launch.argtypes = [vp, vp, vp, vp, ci, ci,
                                                  vp]
        cdll.ed25519_verify_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                              vp, ci, ci, ci, vp]
        cdll.ed25519_quarter_tables_launch.argtypes = [vp, vp, ci, ci, vp]
        cdll.ed25519_verify_staged_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                                     vp, vp, ci, ci, ci, vp]
        cdll.field_chain_launch.argtypes = [vp, vp, ci, ci, vp]
        for fn in (cdll.ed25519_decompress_launch, cdll.ed25519_verify_launch,
                   cdll.ed25519_quarter_tables_launch,
                   cdll.ed25519_verify_staged_launch, cdll.field_chain_launch):
            fn.restype = ci
        _CONFIGURED = True
    return cdll


def _check_rows(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32:
        raise ValueError(f"{name}: want uint8[N, 32], got "
                         f"{t.dtype}{list(t.shape)}")


def decompress_kernel(keys_u8: torch.Tensor):
    """K3: uint8[U, 32] keys -> (quarters int32[U, 4, 4, 10],
    tables int32[U, 4, 16, 4, 10], valid bool[U]); see decompress_torch."""
    _check_rows(keys_u8, "decompress_kernel")
    if not keys_u8.is_cuda:
        return decompress_torch(keys_u8)
    ops.require_cuda("ed25519_decompress", keys_u8)
    u_ = keys_u8.shape[0]
    dev = keys_u8.device
    quarters = torch.empty((u_, N_QUARTERS, 4, FE_LIMBS), dtype=torch.int32,
                           device=dev)
    tables = torch.empty((u_, N_QUARTERS, 16, 4, FE_LIMBS), dtype=torch.int32,
                         device=dev)
    valid = torch.empty((u_,), dtype=torch.bool, device=dev)
    if u_:
        ops.checked(lib().ed25519_decompress_launch(
            ops.ptr(keys_u8), ops.ptr(quarters), ops.ptr(tables),
            ops.ptr(valid), u_, THREADS_PER_BLOCK,
            ops.stream_handle(dev)), "ed25519_decompress")
        ops.count("ed25519_decompress")
    return quarters, tables, valid


def verify_tables(s_u8, h_u8, r_u8, idx, tables, valid) -> torch.Tensor:
    """K4: per-signature verdicts bool[N] from raw S, h, R bytes
    (uint8[N, 32] each), key index idx int32[N] into the K3 output
    (tables, valid). An idx outside [0, U) is a False verdict."""
    for t, name in ((s_u8, "s"), (h_u8, "h"), (r_u8, "r")):
        _check_rows(t, f"verify_tables {name}")
    if not s_u8.is_cuda:
        return verify_tables_torch(s_u8, h_u8, r_u8, idx, tables, valid)
    ops.require_cuda("ed25519_verify", s_u8, h_u8, r_u8, idx, tables, valid)
    if idx.dtype != torch.int32 or tables.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise ValueError("verify_tables: idx/tables int32, valid bool")
    n = s_u8.shape[0]
    dev = s_u8.device
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        comb = comb_table_device(dev)
        ops.checked(lib().ed25519_verify_launch(
            ops.ptr(s_u8), ops.ptr(h_u8), ops.ptr(r_u8), ops.ptr(idx),
            ops.ptr(tables), ops.ptr(valid), ops.ptr(comb), ops.ptr(out),
            n, tables.shape[0], THREADS_PER_BLOCK,
            ops.stream_handle(dev)), "ed25519_verify")
        ops.count("ed25519_verify")
    return out


def verify_kernel_bytes(s_u8, h_u8, keys_u8, idx, r_u8) -> torch.Tensor:
    """The compressed dispatch: S, h, R as uint8[N, 32], distinct keys as
    uint8[U, 32], idx int32[N] -> bool[N]. On CUDA tensors: one K3 launch
    over the keys, one K4 launch over the signatures."""
    _, tables, valid = decompress_kernel(keys_u8)
    return verify_tables(s_u8, h_u8, r_u8, idx, tables, valid)


def _check_i32(t: torch.Tensor, name: str, shape: tuple) -> None:
    """int32 with the given shape; None in `shape` takes any size."""
    if t.dtype != torch.int32 or t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: want int32{list(shape)}, got "
                         f"{t.dtype}{list(t.shape)}")


def quarter_tables(aq: torch.Tensor) -> torch.Tensor:
    """K5: staged quarter points int32[U, 4, 4, 20] (the reference's
    13-bit limbs, as `ext_quarters` gives them) -> window tables
    int32[U, 4, 16, 4, 10], the layout K3 writes."""
    _check_i32(aq, "quarter_tables", (None, N_QUARTERS, 4, NLIMB))
    if not aq.is_cuda:
        return quarter_tables_torch(aq)
    ops.require_cuda("ed25519_quarter_tables", aq)
    u_ = aq.shape[0]
    tables = torch.empty((u_, N_QUARTERS, 16, 4, FE_LIMBS), dtype=torch.int32,
                         device=aq.device)
    if u_:
        ops.checked(lib().ed25519_quarter_tables_launch(
            ops.ptr(aq), ops.ptr(tables), u_, THREADS_PER_BLOCK,
            ops.stream_handle(aq.device)), "ed25519_quarter_tables")
        ops.count("ed25519_quarter_tables")
    return tables


def verify_staged(s_digits, h_digits, ry, r_sign, idx, tables) -> torch.Tensor:
    """K6: verdicts bool[N] from the reference's staged arrays
    (see verify_staged_torch) and K5's tables, gathered by idx."""
    n = idx.shape[0] if idx.dim() == 1 else -1
    _check_i32(idx, "verify_staged idx", (n,))
    _check_i32(s_digits, "verify_staged s_digits", (N_COMB, n))
    _check_i32(h_digits, "verify_staged h_digits", (N_WIN, N_QUARTERS, n))
    _check_i32(ry, "verify_staged ry", (n, NLIMB))
    _check_i32(r_sign, "verify_staged r_sign", (n,))
    _check_i32(tables, "verify_staged tables",
               (None, N_QUARTERS, 16, 4, FE_LIMBS))
    if not idx.is_cuda:
        return verify_staged_torch(s_digits, h_digits, ry, r_sign, idx, tables)
    ops.require_cuda("ed25519_verify_staged", s_digits, h_digits, ry, r_sign,
                     idx, tables)
    dev = idx.device
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        comb = comb_table_device(dev)
        ops.checked(lib().ed25519_verify_staged_launch(
            ops.ptr(s_digits), ops.ptr(h_digits), ops.ptr(ry), ops.ptr(r_sign),
            ops.ptr(idx), ops.ptr(tables), ops.ptr(comb), ops.ptr(out), n,
            tables.shape[0], THREADS_PER_BLOCK,
            ops.stream_handle(dev)), "ed25519_verify_staged")
        ops.count("ed25519_verify_staged")
    return out


def verify_kernel_indexed(s_digits, h_digits, aq_unique, idx, ry,
                          r_sign) -> torch.Tensor:
    """The limb-staged dispatch with keys deduped (the reference's
    verify_kernel_indexed): one row of quarter points per distinct key,
    aq_unique int32[U, 4, 4, 20], and idx int32[N] mapping each signature
    to its row -> bool[N]. On CUDA tensors: one K5 launch over the rows,
    one K6 launch over the signatures."""
    return verify_staged(s_digits, h_digits, ry, r_sign, idx,
                         quarter_tables(aq_unique))


def verify_kernel(s_digits, h_digits, aq, ry, r_sign) -> torch.Tensor:
    """The limb-staged dispatch with one row per signature (the
    reference's verify_kernel): verify_kernel_indexed with idx = 0..N-1."""
    idx = torch.arange(aq.shape[0], dtype=torch.int32, device=aq.device)
    return verify_kernel_indexed(s_digits, h_digits, aq, idx, ry, r_sign)


def stage_on(device, *arrays) -> tuple:
    """Staged host arrays (numpy or tensors) as contiguous tensors on one
    device; None means the card, and raises when there is none."""
    dev = ops.resolve_device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)
                                 if isinstance(a, np.ndarray) else a)
                 .to(dev).contiguous() for a in arrays)


# --- fixed-base comb table -------------------------------------------------

_B_COMB: np.ndarray | None = None   # float32[N_COMB, 256, 3*NLIMB]
_B_COMB_FE: np.ndarray | None = None
_COMB_DEV: dict = {}


def b_comb_table() -> np.ndarray:
    """32 position tables for the fixed base B: T[w][d] = d*256^w*B as
    affine niels rows (y+x, y-x, 2d*x*y), entry 0 the niels identity
    (1, 1, 0). The JAX package's layout (13-bit limbs in float32), kept
    so the two packages' tables can be compared as they are."""
    global _B_COMB
    if _B_COMB is not None:
        return _B_COMB
    base = (BX, BY, 1, BX * BY % P)
    ext: list[list[tuple]] = []
    for w in range(N_COMB):
        row = [base]
        for _ in range(2, 256):
            row.append(_ext_add_int(row[-1], base))
        ext.append(row)
        if w != N_COMB - 1:
            for _ in range(CBITS):
                base = _ext_dbl_int(base)
    zs = [p[2] for row in ext for p in row]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv_all = pow(prefix[-1], P - 2, P)
    zinv = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        zinv[i] = prefix[i] * inv_all % P
        inv_all = inv_all * zs[i] % P
    tab = np.zeros((N_COMB, 256, 3, NLIMB), np.float32)
    for w in range(N_COMB):
        tab[w, 0, 0] = int_to_limbs(1)      # identity niels: (1, 1, 0)
        tab[w, 0, 1] = int_to_limbs(1)
        for d in range(1, 256):
            x, y, _, _ = ext[w][d - 1]
            zi = zinv[w * 255 + d - 1]
            xa, ya = x * zi % P, y * zi % P
            tab[w, d, 0] = int_to_limbs((ya + xa) % P)
            tab[w, d, 1] = int_to_limbs((ya - xa) % P)
            tab[w, d, 2] = int_to_limbs(D2 * xa * ya % P)
    _B_COMB = tab.reshape(N_COMB, 256, 3 * NLIMB)
    return _B_COMB


def comb_table_limbs() -> np.ndarray:
    """b_comb_table in the port's layout: int32[32, 256, 3, 10]."""
    global _B_COMB_FE
    if _B_COMB_FE is None:
        ref = b_comb_table().reshape(N_COMB, 256, 3, NLIMB).astype(np.int64)
        weights = np.array([1 << (RADIX * i) for i in range(NLIMB)],
                           dtype=object)
        vals = (ref.astype(object) * weights).sum(-1)       # exact ints
        out = np.array([fe_from_int(int(v)) for v in vals.reshape(-1)],
                       dtype=np.int32)
        _B_COMB_FE = out.reshape(N_COMB, 256, 3, FE_LIMBS)
    return _B_COMB_FE


def comb_table_fe(device) -> torch.Tensor:
    """The comb table as int64 limbs on device (plain versions)."""
    return comb_table_device(device).to(torch.int64)


def comb_table_device(device) -> torch.Tensor:
    """The comb table resident on device, int32[32, 256, 3, 10]."""
    key = str(device)
    t = _COMB_DEV.get(key)
    if t is None:
        t = _COMB_DEV[key] = torch.from_numpy(comb_table_limbs()).to(device)
    return t


# --- host-side extended-coordinate helpers (Python ints) ------------------

def _ext_add_int(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = D2 * t1 * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_dbl_int(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1)
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def ext_quarters(pt: tuple[int, int]) -> np.ndarray:
    """Affine host point -> int32[4, 4, NLIMB] (the JAX package's 13-bit
    limbs): the four quarter points [2^(64k)]pt for k = 0..3 in extended
    coordinates (X:Y:Z:T), by 192 extended doublings, no inversions."""
    x, y = pt
    p = (x, y, 1, x * y % P)
    out = np.zeros((N_QUARTERS, 4, NLIMB), np.int32)
    for k in range(N_QUARTERS):
        for c in range(4):
            out[k, c] = int_to_limbs(p[c])
        if k != N_QUARTERS - 1:
            for _ in range(QUARTER_SHIFT):
                p = _ext_dbl_int(p)
    return out


def edwards_add(p1: tuple[int, int], p2: tuple[int, int]) -> tuple[int, int]:
    """Affine Edwards addition over Python ints (host-side, no deps)."""
    x1, y1 = p1
    x2, y2 = p2
    dd = D * x1 * x2 * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + dd, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dd + P, P - 2, P) % P
    return (x3, y3)


def edwards_mul(k: int, pt: tuple[int, int]) -> tuple[int, int]:
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = add if acc is None else edwards_add(acc, add)
        add = edwards_add(add, add)
        k >>= 1
    return acc if acc is not None else (0, 1)


def compress(pt: tuple[int, int]) -> bytes:
    x, y = pt
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


_EXT_IDENTITY = (0, 1, 1, 0)


def ext_scalar_mul(k: int, pt: tuple[int, int]) -> tuple[int, int]:
    """[k]pt over Python ints in extended coordinates (one inversion at
    the end) — the ladder behind the no-deps sign/verify path."""
    acc = _EXT_IDENTITY
    add = (pt[0], pt[1], 1, pt[0] * pt[1] % P)
    while k:
        if k & 1:
            acc = _ext_add_int(acc, add)
        add = _ext_dbl_int(add)
        k >>= 1
    return ext_to_affine(acc)


def ext_to_affine(p) -> tuple[int, int]:
    x, y, z, _t = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def ext_double_scalar_mul(s: int, p1: tuple[int, int],
                          h: int, p2: tuple[int, int]) -> tuple[int, int]:
    """[s]p1 + [h]p2 (Shamir interleave, MSB first) -> affine."""
    e1 = (p1[0], p1[1], 1, p1[0] * p1[1] % P)
    e2 = (p2[0], p2[1], 1, p2[0] * p2[1] % P)
    e12 = _ext_add_int(e1, e2)
    acc = _EXT_IDENTITY
    for i in range(max(s.bit_length(), h.bit_length()) - 1, -1, -1):
        acc = _ext_dbl_int(acc)
        b1, b2 = (s >> i) & 1, (h >> i) & 1
        if b1 and b2:
            acc = _ext_add_int(acc, e12)
        elif b1:
            acc = _ext_add_int(acc, e1)
        elif b2:
            acc = _ext_add_int(acc, e2)
    return ext_to_affine(acc)


def pure_python_verify(msg: bytes, sig: bytes, vk: bytes) -> bool:
    """RFC 8032 verification without external deps (ref10 semantics: the
    recomputed R' = [s]B - [h]A must BYTE-match the signature's R, no
    cofactor multiplication). Strict: rejects S >= L and non-canonical A."""
    import hashlib
    try:
        msg, sig, vk = bytes(msg), bytes(sig), bytes(vk)
    except Exception:
        return False
    if len(sig) != 64 or len(vk) != 32:
        return False
    A = decompress(vk)
    if A is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + vk + msg).digest(),
                       "little") % L
    neg_a = ((P - A[0]) % P, A[1])
    return compress(ext_double_scalar_mul(s, (BX, BY), h, neg_a)) == sig[:32]


def pure_python_sign(seed: bytes, msg: bytes) -> tuple[bytes, bytes]:
    """RFC 8032 signing without external deps -> (signature, verkey)."""
    import hashlib
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    prefix = h[32:]
    A = ext_scalar_mul(a, (BX, BY))
    vk = compress(A)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = ext_scalar_mul(r, (BX, BY))
    r_enc = compress(R)
    k = int.from_bytes(hashlib.sha512(r_enc + vk + msg).digest(),
                       "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little"), vk


def decompress(comp: bytes):
    """Verkey/R bytes -> affine point, or None if not on curve."""
    if len(comp) != 32:
        return None
    y = int.from_bytes(comp, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # sqrt(u/v) for p = 5 mod 8 (RFC 8032 §5.1.3)
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u % P:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y)


def scalar_windows(values: list[int], n_windows: int,
                   bits: int = WBITS) -> np.ndarray:
    """[n_windows, N] little-endian `bits`-wide digits (int32)."""
    nbytes = (n_windows * bits + 7) // 8
    raw = np.frombuffer(
        b"".join(v.to_bytes(nbytes, "little") for v in values),
        dtype=np.uint8).reshape(len(values), nbytes)
    if bits == 8:
        out = raw[:, :n_windows].astype(np.int32)
    elif bits == 4:
        nib = np.empty((len(values), 2 * nbytes), np.uint8)
        nib[:, 0::2] = raw & 0x0F
        nib[:, 1::2] = raw >> 4
        out = nib[:, :n_windows].astype(np.int32)
    else:
        raise ValueError(f"unsupported window width {bits}")
    return np.ascontiguousarray(out.T)


# bit b of a 255-bit little-endian value belongs to 13-bit limb b//13,
# weight 2^(b%13); bit 255 is the sign bit (excluded)
_BIT_TO_LIMB = np.zeros((256, NLIMB), np.int32)
for _b in range(255):
    _BIT_TO_LIMB[_b, _b // RADIX] = 1 << (_b % RADIX)


def r_bytes_to_limbs(r_encodings: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Raw 32-byte R encodings -> (13-bit y limbs int32[N, NLIMB], sign
    int32[N]), the JAX package's host staging of R."""
    raw = np.frombuffer(b"".join(bytes(e) for e in r_encodings),
                        dtype=np.uint8).reshape(len(r_encodings), 32)
    bits = np.unpackbits(raw, axis=1, bitorder="little")   # [N, 256]
    ry = bits.astype(np.int32) @ _BIT_TO_LIMB
    return ry, bits[:, 255].astype(np.int32)
