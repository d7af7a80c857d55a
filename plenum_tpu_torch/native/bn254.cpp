// BN254 (alt_bn128) pairing arithmetic in C++ — the native-speed twin of
// plenum_tpu/crypto/bn254.py (same tower layout, same wire encodings), built
// because a BLS pairing check sits on the 3PC hot path: one aggregate check
// per ordered batch per node. Pure-Python bigint pairing costs ~74 ms; this
// library does it in single-digit milliseconds. Plays the role the Rust Ursa
// native library plays for the reference
// (crypto/bls/indy_crypto/bls_crypto_indy_crypto.py:6-10).
//
// Field arithmetic: 4x64-bit Montgomery (CIOS). Tower: Fq2 = Fq[i]/(i^2+1),
// Fq6 = Fq2[v]/(v^3 - (9+i)), Fq12 = Fq6[w]/(w^2 - v). Groups affine with
// Fermat inversion. Optimal-Ate Miller loop; easy+hard final exponentiation
// (plain square-and-multiply over (p^4-p^2+1)/r, matching the Python twin so
// the two implementations are differential-testable bit for bit).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment). All point
// encodings are big-endian bytes: Fp = 32B, G1 = x||y (64B, all-zero =
// infinity), G2 = x0||x1||y0||y1 (128B, all-zero = infinity) — identical to
// the Python g1_to_bytes / g2_to_bytes layout.

#include <cstdint>
#include <cstring>
#include <mutex>

typedef uint64_t u64;
typedef __uint128_t u128;

// ---------------------------------------------------------------- base field

struct Fp { u64 v[4]; };

static const u64 PL[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 NP = 0x87d20782e4866389ULL;          // -P^-1 mod 2^64
static const Fp R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                       0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};
static const Fp FP_ONE_M = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                             0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};
static const Fp FP_ZERO = {{0, 0, 0, 0}};
// group order r (for scalar reduction / subgroup checks), NOT a field element
static const u64 RL[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL};

static inline bool fp_is_zero(const Fp &a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
    return a.v[0] == b.v[0] && a.v[1] == b.v[1] &&
           a.v[2] == b.v[2] && a.v[3] == b.v[3];
}

static inline int cmp4(const u64 *a, const u64 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static inline void sub4(u64 *r, const u64 *a, const u64 *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - (u64)borrow;
        r[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fp_add(Fp &r, const Fp &a, const Fp &b) {
    u128 carry = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + (u64)carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || cmp4(t, PL) >= 0) sub4(r.v, t, PL);
    else memcpy(r.v, t, sizeof t);
}

static inline void fp_sub(Fp &r, const Fp &a, const Fp &b) {
    if (cmp4(a.v, b.v) >= 0) { sub4(r.v, a.v, b.v); return; }
    u64 t[4];
    sub4(t, b.v, a.v);          // b - a
    sub4(r.v, PL, t);           // P - (b - a)
}

static inline void fp_neg(Fp &r, const Fp &a) {
    if (fp_is_zero(a)) { r = a; return; }
    sub4(r.v, PL, a.v);
}

// Montgomery CIOS multiply: r = a*b*R^-1 mod P
static void fp_mul(Fp &r, const Fp &a, const Fp &b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + (u64)c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s = (u128)t[4] + (u64)c;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * NP;
        c = ((u128)m * PL[0] + t[0]) >> 64;
        for (int j = 1; j < 4; j++) {
            u128 s2 = (u128)t[j] + (u128)m * PL[j] + (u64)c;
            t[j - 1] = (u64)s2;
            c = s2 >> 64;
        }
        u128 s3 = (u128)t[4] + (u64)c;
        t[3] = (u64)s3;
        t[4] = t[5] + (u64)(s3 >> 64);
    }
    if (t[4] || cmp4(t, PL) >= 0) sub4(r.v, t, PL);
    else memcpy(r.v, t, 4 * sizeof(u64));
}

static inline void fp_sqr(Fp &r, const Fp &a) { fp_mul(r, a, a); }

static void fp_pow(Fp &r, const Fp &a, const u64 *e, int nlimbs) {
    Fp out = FP_ONE_M, base = a;
    for (int i = 0; i < nlimbs; i++) {
        u64 w = e[i];
        for (int bit = 0; bit < 64; bit++) {
            if (w & 1) fp_mul(out, out, base);
            fp_sqr(base, base);
            w >>= 1;
        }
    }
    r = out;
}

static inline bool is_zero4(const u64 *a) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static inline bool is_one4(const u64 *a) {
    return a[0] == 1 && (a[1] | a[2] | a[3]) == 0;
}

static inline void shr1_4(u64 *a) {
    a[0] = (a[0] >> 1) | (a[1] << 63);
    a[1] = (a[1] >> 1) | (a[2] << 63);
    a[2] = (a[2] >> 1) | (a[3] << 63);
    a[3] >>= 1;
}

// halve x mod p: x/2 if even, else (x+p)/2 (tracking the 257th bit)
static inline void half_mod(u64 *x) {
    if (x[0] & 1) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)x[i] + PL[i] + (u64)carry;
            x[i] = (u64)s;
            carry = s >> 64;
        }
        shr1_4(x);
        if (carry) x[3] |= 0x8000000000000000ULL;
    } else {
        shr1_4(x);
    }
}

static inline void sub_mod(u64 *r, const u64 *a, const u64 *b) {
    if (cmp4(a, b) >= 0) { sub4(r, a, b); return; }
    u64 t[4];
    sub4(t, b, a);
    sub4(r, PL, t);
}

// Binary extended GCD inversion — ~15x cheaper than Fermat and it sits under
// every affine group-law step and line evaluation.
static void fp_inv(Fp &r, const Fp &a) {
    if (fp_is_zero(a)) { r = a; return; }
    u64 u[4], v[4], x1[4], x2[4];
    memcpy(u, a.v, sizeof u);       // value of a_mont = a*R; inverted directly,
    memcpy(v, PL, sizeof v);        // then re-scaled by R2 twice below
    x1[0] = 1; x1[1] = x1[2] = x1[3] = 0;
    memset(x2, 0, sizeof x2);
    while (!is_one4(u) && !is_one4(v)) {
        while (!(u[0] & 1)) { shr1_4(u); half_mod(x1); }
        while (!(v[0] & 1)) { shr1_4(v); half_mod(x2); }
        if (cmp4(u, v) >= 0) {
            sub4(u, u, v);
            sub_mod(x1, x1, x2);
        } else {
            sub4(v, v, u);
            sub_mod(x2, x2, x1);
        }
    }
    Fp x;
    memcpy(x.v, is_one4(u) ? x1 : x2, sizeof x.v);
    // x = (aR)^-1; output must be a^-1 * R = x * R^2 = (x (*) R2) (*) R2
    fp_mul(x, x, R2);
    fp_mul(r, x, R2);
}

static void to_mont(Fp &r, const Fp &a) { fp_mul(r, a, R2); }
static void from_mont(Fp &r, const Fp &a) {
    Fp one = {{1, 0, 0, 0}};
    fp_mul(r, a, one);
}

// ------------------------------------------------------------------- Fq2

struct Fp2 { Fp c0, c1; };

static const Fp2 F2_ZERO = {FP_ZERO, FP_ZERO};

static inline void f2_add(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    fp_add(r.c0, a.c0, b.c0);
    fp_add(r.c1, a.c1, b.c1);
}

static inline void f2_sub(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    fp_sub(r.c0, a.c0, b.c0);
    fp_sub(r.c1, a.c1, b.c1);
}

static inline void f2_neg(Fp2 &r, const Fp2 &a) {
    fp_neg(r.c0, a.c0);
    fp_neg(r.c1, a.c1);
}

static void f2_mul(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    Fp t0, t1, t2, sa, sb;
    fp_mul(t0, a.c0, b.c0);
    fp_mul(t1, a.c1, b.c1);
    fp_add(sa, a.c0, a.c1);
    fp_add(sb, b.c0, b.c1);
    fp_mul(t2, sa, sb);
    fp_sub(r.c0, t0, t1);
    fp_sub(t2, t2, t0);
    fp_sub(r.c1, t2, t1);
}

static void f2_sqr(Fp2 &r, const Fp2 &a) {
    Fp t, s, d;
    fp_mul(t, a.c0, a.c1);
    fp_add(s, a.c0, a.c1);
    fp_sub(d, a.c0, a.c1);
    fp_mul(r.c0, s, d);
    fp_add(r.c1, t, t);
}

static inline void f2_conj(Fp2 &r, const Fp2 &a) {
    r.c0 = a.c0;
    fp_neg(r.c1, a.c1);
}

static void f2_inv(Fp2 &r, const Fp2 &a) {
    Fp t0, t1, d;
    fp_sqr(t0, a.c0);
    fp_sqr(t1, a.c1);
    fp_add(t0, t0, t1);
    fp_inv(d, t0);
    fp_mul(r.c0, a.c0, d);
    fp_mul(t1, a.c1, d);
    fp_neg(r.c1, t1);
}

static inline void f2_dbl(Fp2 &r, const Fp2 &a) { f2_add(r, a, a); }

static void f2_mul_small(Fp2 &r, const Fp2 &a, int k) {  // k in {2,3,9}
    Fp2 acc = a;
    for (int i = 1; i < k; i++) f2_add(acc, acc, a);
    r = acc;
}

// multiply by xi = 9 + i
static void f2_mul_xi(Fp2 &r, const Fp2 &a) {
    Fp2 nine;
    f2_mul_small(nine, a, 9);
    Fp t0, t1;
    fp_sub(t0, nine.c0, a.c1);       // 9 a0 - a1
    fp_add(t1, a.c0, nine.c1);       // a0 + 9 a1
    r.c0 = t0;
    r.c1 = t1;
}

static inline bool f2_is_zero(const Fp2 &a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

static inline bool f2_eq(const Fp2 &a, const Fp2 &b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// ------------------------------------------------------------------- Fq6

struct Fp6 { Fp2 c0, c1, c2; };

static const Fp6 F6_ZERO = {F2_ZERO, F2_ZERO, F2_ZERO};

static inline void f6_add(Fp6 &r, const Fp6 &a, const Fp6 &b) {
    f2_add(r.c0, a.c0, b.c0);
    f2_add(r.c1, a.c1, b.c1);
    f2_add(r.c2, a.c2, b.c2);
}

static inline void f6_sub(Fp6 &r, const Fp6 &a, const Fp6 &b) {
    f2_sub(r.c0, a.c0, b.c0);
    f2_sub(r.c1, a.c1, b.c1);
    f2_sub(r.c2, a.c2, b.c2);
}

static inline void f6_neg(Fp6 &r, const Fp6 &a) {
    f2_neg(r.c0, a.c0);
    f2_neg(r.c1, a.c1);
    f2_neg(r.c2, a.c2);
}

static void f6_mul(Fp6 &r, const Fp6 &a, const Fp6 &b) {
    Fp2 t0, t1, t2, s0, s1, u;
    f2_mul(t0, a.c0, b.c0);
    f2_mul(t1, a.c1, b.c1);
    f2_mul(t2, a.c2, b.c2);

    Fp2 c0, c1, c2;
    // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    f2_add(s0, a.c1, a.c2);
    f2_add(s1, b.c1, b.c2);
    f2_mul(u, s0, s1);
    f2_sub(u, u, t1);
    f2_sub(u, u, t2);
    f2_mul_xi(u, u);
    f2_add(c0, t0, u);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    f2_add(s0, a.c0, a.c1);
    f2_add(s1, b.c0, b.c1);
    f2_mul(u, s0, s1);
    f2_sub(u, u, t0);
    f2_sub(u, u, t1);
    Fp2 xt2;
    f2_mul_xi(xt2, t2);
    f2_add(c1, u, xt2);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    f2_add(s0, a.c0, a.c2);
    f2_add(s1, b.c0, b.c2);
    f2_mul(u, s0, s1);
    f2_sub(u, u, t0);
    f2_sub(u, u, t2);
    f2_add(c2, u, t1);
    r.c0 = c0; r.c1 = c1; r.c2 = c2;
}

static inline void f6_sqr(Fp6 &r, const Fp6 &a) { f6_mul(r, a, a); }

static void f6_mul_v(Fp6 &r, const Fp6 &a) {    // (c0,c1,c2) -> (xi*c2, c0, c1)
    Fp2 t;
    f2_mul_xi(t, a.c2);
    Fp2 old0 = a.c0, old1 = a.c1;
    r.c0 = t;
    r.c1 = old0;
    r.c2 = old1;
}

static void f6_inv(Fp6 &r, const Fp6 &a) {
    Fp2 c0, c1, c2, t, u;
    f2_sqr(t, a.c0);
    f2_mul(u, a.c1, a.c2);
    f2_mul_xi(u, u);
    f2_sub(c0, t, u);
    f2_sqr(t, a.c2);
    f2_mul_xi(t, t);
    f2_mul(u, a.c0, a.c1);
    f2_sub(c1, t, u);
    f2_sqr(t, a.c1);
    f2_mul(u, a.c0, a.c2);
    f2_sub(c2, t, u);

    Fp2 d, tmp;
    f2_mul(d, a.c0, c0);
    f2_mul(tmp, a.c2, c1);
    f2_mul_xi(tmp, tmp);
    f2_add(d, d, tmp);
    f2_mul(tmp, a.c1, c2);
    f2_mul_xi(tmp, tmp);
    f2_add(d, d, tmp);
    f2_inv(d, d);
    f2_mul(r.c0, c0, d);
    f2_mul(r.c1, c1, d);
    f2_mul(r.c2, c2, d);
}

// ------------------------------------------------------------------- Fq12

struct Fp12 { Fp6 c0, c1; };

static void f12_mul(Fp12 &r, const Fp12 &a, const Fp12 &b) {
    Fp6 t0, t1, s0, s1, u;
    f6_mul(t0, a.c0, b.c0);
    f6_mul(t1, a.c1, b.c1);
    Fp6 vt1;
    f6_mul_v(vt1, t1);
    Fp6 c0;
    f6_add(c0, t0, vt1);
    f6_add(s0, a.c0, a.c1);
    f6_add(s1, b.c0, b.c1);
    f6_mul(u, s0, s1);
    f6_sub(u, u, t0);
    f6_sub(u, u, t1);
    r.c0 = c0;
    r.c1 = u;
}

static void f12_sqr(Fp12 &r, const Fp12 &a) {
    Fp6 t, s0, s1, u;
    f6_mul(t, a.c0, a.c1);
    f6_add(s0, a.c0, a.c1);
    Fp6 va1;
    f6_mul_v(va1, a.c1);
    f6_add(s1, a.c0, va1);
    f6_mul(u, s0, s1);
    Fp6 vt;
    f6_mul_v(vt, t);
    f6_sub(u, u, t);
    f6_sub(u, u, vt);
    r.c0 = u;
    f6_add(r.c1, t, t);
}

static void f12_inv(Fp12 &r, const Fp12 &a) {
    Fp6 t0, t1;
    f6_sqr(t0, a.c0);
    f6_sqr(t1, a.c1);
    f6_mul_v(t1, t1);
    f6_sub(t0, t0, t1);
    f6_inv(t0, t0);
    f6_mul(r.c0, a.c0, t0);
    Fp6 t2;
    f6_mul(t2, a.c1, t0);
    f6_neg(r.c1, t2);
}

static inline void f12_conj(Fp12 &r, const Fp12 &a) {
    r.c0 = a.c0;
    f6_neg(r.c1, a.c1);
}

static bool f12_is_one(const Fp12 &a) {
    if (!fp_eq(a.c0.c0.c0, FP_ONE_M)) return false;
    if (!fp_is_zero(a.c0.c0.c1)) return false;
    return f2_is_zero(a.c0.c1) && f2_is_zero(a.c0.c2) &&
           f2_is_zero(a.c1.c0) && f2_is_zero(a.c1.c1) && f2_is_zero(a.c1.c2);
}

// Frobenius coefficient tables (normal form; converted to Montgomery at init).
// gamma1[j] = xi^(j(p-1)/6), gamma2 = norm(gamma1), gamma3 = conj(g2)*g1.
static const u64 G1C_RAW[6][2][4] = {
    {{1, 0, 0, 0}, {0, 0, 0, 0}},
    {{0xd60b35dadcc9e470ULL, 0x5c521e08292f2176ULL, 0xe8b99fdd76e68b60ULL, 0x1284b71c2865a7dfULL},
     {0xca5cf05f80f362acULL, 0x747992778eeec7e5ULL, 0xa6327cfe12150b8eULL, 0x246996f3b4fae7e6ULL}},
    {{0x99e39557176f553dULL, 0xb78cc310c2c3330cULL, 0x4c0bec3cf559b143ULL, 0x2fb347984f7911f7ULL},
     {0x1665d51c640fcba2ULL, 0x32ae2a1d0b7c9dceULL, 0x4ba4cc8bd75a0794ULL, 0x16c9e55061ebae20ULL}},
    {{0xdc54014671a0135aULL, 0xdbaae0eda9c95998ULL, 0xdc5ec698b6e2f9b9ULL, 0x063cf305489af5dcULL},
     {0x82d37f632623b0e3ULL, 0x21807dc98fa25bd2ULL, 0x0704b5a7ec796f2bULL, 0x07c03cbcac41049aULL}},
    {{0x848a1f55921ea762ULL, 0xd33365f7be94ec72ULL, 0x80f3c0b75a181e84ULL, 0x05b54f5e64eea801ULL},
     {0xc13b4711cd2b8126ULL, 0x3685d2ea1bdec763ULL, 0x9f3a80b03b0b1c92ULL, 0x2c145edbe7fd8aeeULL}},
    {{0x2ea2c810eab7692fULL, 0x425c459b55aa1bd3ULL, 0xe93a3661a4353ff4ULL, 0x0183c1e74f798649ULL},
     {0x24c6b8ee6e0c2c4bULL, 0xb080cb99678e2ac0ULL, 0xa27fb246c7729f7dULL, 0x12acf2ca76fd0675ULL}},
};
static const u64 G2C_RAW[6][4] = {
    {1, 0, 0, 0},
    {0xe4bd44e5607cfd49ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL, 0x30644e72e131a029ULL},
    {0xe4bd44e5607cfd48ULL, 0xc28f069fbb966e3dULL, 0x5e6dd9e7e0acccb0ULL, 0x30644e72e131a029ULL},
    {0x3c208c16d87cfd46ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL, 0x30644e72e131a029ULL},
    {0x5763473177fffffeULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL, 0x0000000000000000ULL},
    {0x5763473177ffffffULL, 0xd4f263f1acdb5c4fULL, 0x59e26bcea0d48bacULL, 0x0000000000000000ULL},
};
static const u64 G3C_RAW[6][2][4] = {
    {{1, 0, 0, 0}, {0, 0, 0, 0}},
    {{0xe86f7d391ed4a67fULL, 0x894cb38dbe55d24aULL, 0xefe9608cd0acaa90ULL, 0x19dc81cfcc82e4bbULL},
     {0x7694aa2bf4c0c101ULL, 0x7f03a5e397d439ecULL, 0x06cbeee33576139dULL, 0x00abf8b60be77d73ULL}},
    {{0x7b746ee87bdcfb6dULL, 0x805ffd3d5d6942d3ULL, 0xbaff1c77959f25acULL, 0x0856e078b755ef0aULL},
     {0x380cab2baaa586deULL, 0x0fdf31bf98ff2631ULL, 0xa9f30e6dec26094fULL, 0x04f1de41b3d1766fULL}},
    {{0x5fcc8ad066dce9edULL, 0xbbd689a3bea870f4ULL, 0xdbf17f1dca9e5ea3ULL, 0x2a275b6d9896aa4cULL},
     {0xb94d0cb3b2594c64ULL, 0x7600ecc7d8cf6ebaULL, 0xb14b900e9507e932ULL, 0x28a411b634f09b8fULL}},
    {{0x0e1a92bc3ccbf066ULL, 0xe633094575b06bcbULL, 0x19bee0f7b5b2444eULL, 0x0bc58c6611c08dabULL},
     {0x5fe3ed9d730c239fULL, 0xa44a9e08737f96e5ULL, 0xfeb0f6ef0cd21d04ULL, 0x23d5e999e1910a12ULL}},
    {{0xebde847076261b43ULL, 0x2ed68098967c84a5ULL, 0x711699fa3b4d3f69ULL, 0x13c49044952c0905ULL},
     {0x1f25041384282499ULL, 0x3e2ddaea20028021ULL, 0x9fb1b2282a48633dULL, 0x16db366a59b1dd0bULL}},
};
static const u64 FROBX_RAW[2][4] = {
    {0x99e39557176f553dULL, 0xb78cc310c2c3330cULL, 0x4c0bec3cf559b143ULL, 0x2fb347984f7911f7ULL},
    {0x1665d51c640fcba2ULL, 0x32ae2a1d0b7c9dceULL, 0x4ba4cc8bd75a0794ULL, 0x16c9e55061ebae20ULL},
};
static const u64 FROBY_RAW[2][4] = {
    {0xdc54014671a0135aULL, 0xdbaae0eda9c95998ULL, 0xdc5ec698b6e2f9b9ULL, 0x063cf305489af5dcULL},
    {0x82d37f632623b0e3ULL, 0x21807dc98fa25bd2ULL, 0x0704b5a7ec796f2bULL, 0x07c03cbcac41049aULL},
};
// hard exponent (p^4 - p^2 + 1)/r, 761 bits, little-endian limbs
static const u64 HARD[12] = {
    0xe81bb482ccdf42b1ULL, 0x5abf5cc4f49c36d4ULL, 0xf1154e7e1da014fdULL,
    0xdcc7b44c87cdbacfULL, 0xaaa441e3954bcf8aULL, 0x6b887d56d5095f23ULL,
    0x79581e16f3fd90c6ULL, 0x3b1b1355d189227dULL, 0x4e529a5861876f6bULL,
    0x6c0eb522d5b12278ULL, 0x331ec15183177fafULL, 0x01baaa710b0759adULL,
};
static const u64 ATE_LOOP = 0x9d797039be763ba8ULL;   // low 64 bits
static const int ATE_TOP_BIT = 64;                   // bit 64 is set (value 0x1...)

static Fp2 G1C_M[6], G3C_M[6], FROBX_M, FROBY_M;
static Fp G2C_M[6];
static Fp2 G2_GEN_X, G2_GEN_Y;
static bool INITED = false;

static void load_fp2(Fp2 &out, const u64 raw[2][4]) {
    Fp a, b;
    memcpy(a.v, raw[0], sizeof a.v);
    memcpy(b.v, raw[1], sizeof b.v);
    to_mont(out.c0, a);
    to_mont(out.c1, b);
}

static void init_constants() {
    if (INITED) return;
    for (int j = 0; j < 6; j++) {
        load_fp2(G1C_M[j], G1C_RAW[j]);
        load_fp2(G3C_M[j], G3C_RAW[j]);
        Fp t;
        memcpy(t.v, G2C_RAW[j], sizeof t.v);
        to_mont(G2C_M[j], t);
    }
    load_fp2(FROBX_M, FROBX_RAW);
    load_fp2(FROBY_M, FROBY_RAW);
    INITED = true;
}

// a^(p^power) for power in {1,2,3}; layout identical to the Python twin.
static void f12_frobenius(Fp12 &r, const Fp12 &a, int power) {
    const Fp2 *cs[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                        &a.c1.c1, &a.c0.c2, &a.c1.c2};
    Fp2 out[6];
    bool conj = (power % 2) == 1;
    for (int j = 0; j < 6; j++) {
        Fp2 c = *cs[j];
        if (conj) f2_conj(c, c);
        if (j) {
            if (power == 2) {
                fp_mul(c.c0, c.c0, G2C_M[j]);
                fp_mul(c.c1, c.c1, G2C_M[j]);
            } else {
                const Fp2 &co = (power == 1) ? G1C_M[j] : G3C_M[j];
                f2_mul(c, c, co);
            }
        }
        out[j] = c;
    }
    r.c0.c0 = out[0]; r.c0.c1 = out[2]; r.c0.c2 = out[4];
    r.c1.c0 = out[1]; r.c1.c1 = out[3]; r.c1.c2 = out[5];
}

static void f12_one(Fp12 &r) {
    memset(&r, 0, sizeof r);
    r.c0.c0.c0 = FP_ONE_M;
}

static const u64 BN_U = 4965661367192848881ULL;    // the BN parameter u

// a^u for UNITARY a (all final-exp intermediates are unitary after the easy
// part, so this is only ever called on unitary elements)
static void f12_pow_u(Fp12 &r, const Fp12 &a) {
    Fp12 out;
    f12_one(out);
    Fp12 base = a;
    u64 w = BN_U;
    while (w) {
        if (w & 1) f12_mul(out, out, base);
        f12_sqr(base, base);
        w >>= 1;
    }
    r = out;
}

static void f12_pow_small(Fp12 &r, const Fp12 &a, unsigned e) {
    Fp12 out;
    f12_one(out);
    Fp12 base = a;
    while (e) {
        if (e & 1) f12_mul(out, out, base);
        f12_sqr(base, base);
        e >>= 1;
    }
    r = out;
}

// Hard part f^((p^4-p^2+1)/r) via the base-p decomposition
//   lambda = l0 + l1*p + l2*p^2 + p^3,
//   l0 = -(36u^3 + 30u^2 + 18u + 2),  l1 = 1 - (36u^3 + 18u^2 + 12u),
//   l2 = 6u^2 + 1
// (derived symbolically from p(u), r(u) and verified numerically against the
// 761-bit plain exponent — see the Python twin's _HARD_EXP). Inverses are
// conjugates because the input is unitary. ~200 squarings instead of ~760.
static void f12_pow_hard(Fp12 &r, const Fp12 &f) {
    Fp12 y1, y2, y3;
    f12_pow_u(y1, f);                   // f^u
    f12_pow_u(y2, y1);                  // f^(u^2)
    f12_pow_u(y3, y2);                  // f^(u^3)

    Fp12 y3_36, y2_6, y2_12, y2_18, y2_30, y1_3, y1_12, y1_18, f2;
    Fp12 t;
    f12_pow_small(y3_36, y3, 36);
    f12_pow_small(y2_6, y2, 6);
    f12_sqr(y2_12, y2_6);
    f12_mul(y2_18, y2_12, y2_6);
    f12_mul(y2_30, y2_18, y2_12);
    f12_sqr(t, y1);
    f12_mul(y1_3, t, y1);
    f12_pow_small(y1_12, y1_3, 4);
    f12_mul(y1_18, y1_12, t);          // y1^12 * y1^2 * ... wait: 12+2=14
    f12_mul(y1_18, y1_18, t);          // +2 -> 16
    f12_mul(y1_18, y1_18, t);          // +2 -> 18
    f12_sqr(f2, f);

    Fp12 fl2, fl1, fl0, acc;
    // f^{l2} = y2^6 * f
    f12_mul(fl2, y2_6, f);
    // f^{l1} = conj(y3^36 * y2^18 * y1^12) * f
    f12_mul(t, y3_36, y2_18);
    f12_mul(t, t, y1_12);
    f12_conj(t, t);
    f12_mul(fl1, t, f);
    // f^{l0} = conj(y3^36 * y2^30 * y1^18 * f^2)
    f12_mul(t, y3_36, y2_30);
    f12_mul(t, t, y1_18);
    f12_mul(t, t, f2);
    f12_conj(fl0, t);

    Fp12 u1, u2, u3;
    f12_frobenius(u1, fl1, 1);
    f12_frobenius(u2, fl2, 2);
    f12_frobenius(u3, f, 3);
    f12_mul(acc, fl0, u1);
    f12_mul(acc, acc, u2);
    f12_mul(r, acc, u3);
}

// ------------------------------------------------------------------- groups

struct G1 { Fp x, y; bool inf; };
struct G2 { Fp2 x, y; bool inf; };

static void g1_add_pt(G1 &r, const G1 &a, const G1 &b) {
    if (a.inf) { r = b; return; }
    if (b.inf) { r = a; return; }
    Fp lam;
    if (fp_eq(a.x, b.x)) {
        Fp s;
        fp_add(s, a.y, b.y);
        if (fp_is_zero(s)) { r.inf = true; return; }
        Fp num, den, x2;
        fp_sqr(x2, a.x);
        fp_add(num, x2, x2);
        fp_add(num, num, x2);          // 3x^2
        fp_add(den, a.y, a.y);
        fp_inv(den, den);
        fp_mul(lam, num, den);
    } else {
        Fp num, den;
        fp_sub(num, b.y, a.y);
        fp_sub(den, b.x, a.x);
        fp_inv(den, den);
        fp_mul(lam, num, den);
    }
    Fp x3, t;
    fp_sqr(x3, lam);
    fp_sub(x3, x3, a.x);
    fp_sub(x3, x3, b.x);
    fp_sub(t, a.x, x3);
    fp_mul(t, lam, t);
    fp_sub(t, t, a.y);
    r.x = x3; r.y = t; r.inf = false;
}

// Jacobian coordinates for the scalar-mul ladders: the affine group law
// above pays one field inversion (~50x a mul, even with binary EGCD) per
// step, so a 256-bit ladder costs ~380 inversions. Jacobian double/add are
// inversion-free (dbl-2009-l / add-2007-bl, a=0 curve); one inversion at
// the end converts back. Measured: g1_mul 1.9 ms -> ~0.1 ms.

struct G1J { Fp X, Y, Z; };           // inf <=> Z == 0

static void g1j_from_affine(G1J &r, const G1 &a) {
    if (a.inf) { r.X = FP_ONE_M; r.Y = FP_ONE_M; r.Z = FP_ZERO; return; }
    r.X = a.x; r.Y = a.y; r.Z = FP_ONE_M;
}

static void g1j_to_affine(G1 &r, const G1J &a) {
    if (fp_is_zero(a.Z)) { r.inf = true; return; }
    Fp zi, zi2, zi3;
    fp_inv(zi, a.Z);
    fp_sqr(zi2, zi);
    fp_mul(zi3, zi2, zi);
    fp_mul(r.x, a.X, zi2);
    fp_mul(r.y, a.Y, zi3);
    r.inf = false;
}

static void g1j_dbl(G1J &r, const G1J &p) {
    if (fp_is_zero(p.Z)) { r = p; return; }
    Fp A, B, C, D, E, F, t;
    fp_sqr(A, p.X);                    // A = X^2
    fp_sqr(B, p.Y);                    // B = Y^2
    fp_sqr(C, B);                      // C = B^2
    fp_add(D, p.X, B);
    fp_sqr(D, D);
    fp_sub(D, D, A);
    fp_sub(D, D, C);
    fp_add(D, D, D);                   // D = 2((X+B)^2 - A - C)
    fp_add(E, A, A);
    fp_add(E, E, A);                   // E = 3A
    fp_sqr(F, E);                      // F = E^2
    fp_sub(r.X, F, D);
    fp_sub(r.X, r.X, D);               // X3 = F - 2D
    fp_sub(t, D, r.X);
    fp_mul(t, E, t);
    Fp c8;
    fp_add(c8, C, C);
    fp_add(c8, c8, c8);
    fp_add(c8, c8, c8);                // 8C
    fp_mul(r.Z, p.Y, p.Z);
    fp_add(r.Z, r.Z, r.Z);             // Z3 = 2YZ  (before Y3 clobbers Y)
    fp_sub(r.Y, t, c8);                // Y3 = E(D - X3) - 8C
}

// mixed addition: q is affine (Z2 = 1)
static void g1j_add_affine(G1J &r, const G1J &p, const G1 &q) {
    if (q.inf) { r = p; return; }
    if (fp_is_zero(p.Z)) { g1j_from_affine(r, q); return; }
    Fp Z1Z1, U2, S2, H, HH, I, J, rr, V, t;
    fp_sqr(Z1Z1, p.Z);
    fp_mul(U2, q.x, Z1Z1);
    fp_mul(S2, q.y, p.Z);
    fp_mul(S2, S2, Z1Z1);
    fp_sub(H, U2, p.X);
    fp_sub(rr, S2, p.Y);
    if (fp_is_zero(H)) {
        if (fp_is_zero(rr)) { g1j_dbl(r, p); return; }
        r.X = FP_ONE_M; r.Y = FP_ONE_M; r.Z = FP_ZERO;  // P + (-P)
        return;
    }
    fp_add(rr, rr, rr);                // r = 2(S2 - Y1)
    fp_sqr(HH, H);
    fp_add(I, HH, HH);
    fp_add(I, I, I);                   // I = 4HH
    fp_mul(J, H, I);
    fp_mul(V, p.X, I);
    fp_sqr(r.X, rr);
    fp_sub(r.X, r.X, J);
    fp_sub(r.X, r.X, V);
    fp_sub(r.X, r.X, V);               // X3 = r^2 - J - 2V
    fp_sub(t, V, r.X);
    fp_mul(t, rr, t);
    Fp YJ;
    fp_mul(YJ, p.Y, J);
    fp_add(YJ, YJ, YJ);
    Fp Z3;
    fp_mul(Z3, p.Z, H);
    fp_add(r.Z, Z3, Z3);               // Z3 = 2 Z1 H
    fp_sub(r.Y, t, YJ);                // Y3 = r(V - X3) - 2 Y1 J
}

static void g1_mul_pt(G1 &r, const G1 &a, const u64 *k) {
    G1J out;
    out.X = FP_ONE_M; out.Y = FP_ONE_M; out.Z = FP_ZERO;
    if (a.inf) { r = a; return; }
    int top = 3;
    while (top >= 0 && k[top] == 0) top--;
    if (top < 0) { r.inf = true; return; }
    int bit = 63;
    while (bit >= 0 && !((k[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int b = (i == top ? bit : 63); b >= 0; b--) {
            g1j_dbl(out, out);
            if ((k[i] >> b) & 1) g1j_add_affine(out, out, a);
        }
    }
    g1j_to_affine(r, out);
}

static void g2_add_pt(G2 &r, const G2 &a, const G2 &b) {
    if (a.inf) { r = b; return; }
    if (b.inf) { r = a; return; }
    Fp2 lam;
    if (f2_eq(a.x, b.x)) {
        Fp2 s;
        f2_add(s, a.y, b.y);
        if (f2_is_zero(s)) { r.inf = true; return; }
        Fp2 num, den, x2;
        f2_sqr(x2, a.x);
        f2_mul_small(num, x2, 3);
        f2_dbl(den, a.y);
        f2_inv(den, den);
        f2_mul(lam, num, den);
    } else {
        Fp2 num, den;
        f2_sub(num, b.y, a.y);
        f2_sub(den, b.x, a.x);
        f2_inv(den, den);
        f2_mul(lam, num, den);
    }
    Fp2 x3, t;
    f2_sqr(x3, lam);
    f2_sub(x3, x3, a.x);
    f2_sub(x3, x3, b.x);
    f2_sub(t, a.x, x3);
    f2_mul(t, lam, t);
    f2_sub(t, t, a.y);
    r.x = x3; r.y = t; r.inf = false;
}

// Jacobian ladder over Fp2 — same dbl-2009-l / add-2007-bl shapes as G1J.

struct G2J { Fp2 X, Y, Z; };          // inf <=> Z == 0

static const Fp2 F2_ONE_M = {FP_ONE_M, FP_ZERO};

static void g2j_from_affine(G2J &r, const G2 &a) {
    if (a.inf) { r.X = F2_ONE_M; r.Y = F2_ONE_M; r.Z = F2_ZERO; return; }
    r.X = a.x; r.Y = a.y; r.Z = F2_ONE_M;
}

static void g2j_to_affine(G2 &r, const G2J &a) {
    if (f2_is_zero(a.Z)) { r.inf = true; return; }
    Fp2 zi, zi2, zi3;
    f2_inv(zi, a.Z);
    f2_sqr(zi2, zi);
    f2_mul(zi3, zi2, zi);
    f2_mul(r.x, a.X, zi2);
    f2_mul(r.y, a.Y, zi3);
    r.inf = false;
}

static void g2j_dbl(G2J &r, const G2J &p) {
    if (f2_is_zero(p.Z)) { r = p; return; }
    Fp2 A, B, C, D, E, F, t;
    f2_sqr(A, p.X);
    f2_sqr(B, p.Y);
    f2_sqr(C, B);
    f2_add(D, p.X, B);
    f2_sqr(D, D);
    f2_sub(D, D, A);
    f2_sub(D, D, C);
    f2_add(D, D, D);
    f2_add(E, A, A);
    f2_add(E, E, A);
    f2_sqr(F, E);
    f2_sub(r.X, F, D);
    f2_sub(r.X, r.X, D);
    f2_sub(t, D, r.X);
    f2_mul(t, E, t);
    Fp2 c8;
    f2_add(c8, C, C);
    f2_add(c8, c8, c8);
    f2_add(c8, c8, c8);
    f2_mul(r.Z, p.Y, p.Z);
    f2_add(r.Z, r.Z, r.Z);
    f2_sub(r.Y, t, c8);
}

static void g2j_add_affine(G2J &r, const G2J &p, const G2 &q) {
    if (q.inf) { r = p; return; }
    if (f2_is_zero(p.Z)) { g2j_from_affine(r, q); return; }
    Fp2 Z1Z1, U2, S2, H, HH, I, J, rr, V, t;
    f2_sqr(Z1Z1, p.Z);
    f2_mul(U2, q.x, Z1Z1);
    f2_mul(S2, q.y, p.Z);
    f2_mul(S2, S2, Z1Z1);
    f2_sub(H, U2, p.X);
    f2_sub(rr, S2, p.Y);
    if (f2_is_zero(H)) {
        if (f2_is_zero(rr)) { g2j_dbl(r, p); return; }
        r.X = F2_ONE_M; r.Y = F2_ONE_M; r.Z = F2_ZERO;
        return;
    }
    f2_add(rr, rr, rr);
    f2_sqr(HH, H);
    f2_add(I, HH, HH);
    f2_add(I, I, I);
    f2_mul(J, H, I);
    f2_mul(V, p.X, I);
    f2_sqr(r.X, rr);
    f2_sub(r.X, r.X, J);
    f2_sub(r.X, r.X, V);
    f2_sub(r.X, r.X, V);
    f2_sub(t, V, r.X);
    f2_mul(t, rr, t);
    Fp2 YJ;
    f2_mul(YJ, p.Y, J);
    f2_add(YJ, YJ, YJ);
    Fp2 Z3;
    f2_mul(Z3, p.Z, H);
    f2_add(r.Z, Z3, Z3);
    f2_sub(r.Y, t, YJ);
}

static void g2_mul_pt(G2 &r, const G2 &a, const u64 *k) {
    if (a.inf) { r = a; return; }
    int top = 3;
    while (top >= 0 && k[top] == 0) top--;
    if (top < 0) { r.inf = true; return; }
    G2J out;
    out.X = F2_ONE_M; out.Y = F2_ONE_M; out.Z = F2_ZERO;
    int bit = 63;
    while (bit >= 0 && !((k[top] >> bit) & 1)) bit--;
    for (int i = top; i >= 0; i--) {
        for (int b = (i == top ? bit : 63); b >= 0; b--) {
            g2j_dbl(out, out);
            if ((k[i] >> b) & 1) g2j_add_affine(out, out, a);
        }
    }
    g2j_to_affine(r, out);
}

static void g2_neg_pt(G2 &r, const G2 &a) {
    r = a;
    if (!a.inf) f2_neg(r.y, a.y);
}

static void g2_frob_pt(G2 &r, const G2 &a) {
    if (a.inf) { r = a; return; }
    Fp2 cx, cy;
    f2_conj(cx, a.x);
    f2_conj(cy, a.y);
    f2_mul(r.x, cx, FROBX_M);
    f2_mul(r.y, cy, FROBY_M);
    r.inf = false;
}

// ------------------------------------------------------------------- pairing

// Multiply f by the sparse line value  A + B*w + C*w^3  (A,B,C in Fq2),
// i.e. l = ((A,0,0),(B,C,0)) in the (c0,c1) Fq6 layout. ~15 Fq2 muls vs 18
// for a generic f12_mul — and no memset/copy of a mostly-zero Fp12.
static void f12_mul_line(Fp12 &f, const Fp2 &A, const Fp2 &B, const Fp2 &C) {
    // t0 = f.c0 * (A,0,0): coefficient-wise scale by A
    Fp6 t0;
    f2_mul(t0.c0, f.c0.c0, A);
    f2_mul(t0.c1, f.c0.c1, A);
    f2_mul(t0.c2, f.c0.c2, A);
    // t1 = f.c1 * (B,C,0)
    Fp6 t1;
    {
        Fp2 a0b0, a1b1, u;
        f2_mul(a0b0, f.c1.c0, B);
        f2_mul(a1b1, f.c1.c1, C);
        f2_mul(u, f.c1.c2, C);
        f2_mul_xi(u, u);
        f2_add(t1.c0, a0b0, u);                    // a0B + xi*a2C
        Fp2 a0b1, a1b0;
        f2_mul(a0b1, f.c1.c0, C);
        f2_mul(a1b0, f.c1.c1, B);
        f2_add(t1.c1, a0b1, a1b0);                 // a0C + a1B
        Fp2 a2b0;
        f2_mul(a2b0, f.c1.c2, B);
        f2_add(t1.c2, a1b1, a2b0);                 // a1C + a2B
    }
    // (f0+f1) * (A+B, C, 0)
    Fp6 s, m;
    f6_add(s, f.c0, f.c1);
    Fp2 AB;
    f2_add(AB, A, B);
    {
        Fp2 a0b0, a1b1, u;
        f2_mul(a0b0, s.c0, AB);
        f2_mul(a1b1, s.c1, C);
        f2_mul(u, s.c2, C);
        f2_mul_xi(u, u);
        f2_add(m.c0, a0b0, u);
        Fp2 a0b1, a1b0;
        f2_mul(a0b1, s.c0, C);
        f2_mul(a1b0, s.c1, AB);
        f2_add(m.c1, a0b1, a1b0);
        Fp2 a2b0;
        f2_mul(a2b0, s.c2, AB);
        f2_add(m.c2, a1b1, a2b0);
    }
    Fp6 vt1;
    f6_mul_v(vt1, t1);
    f6_add(f.c0, t0, vt1);
    f6_sub(m, m, t0);
    f6_sub(f.c1, m, t1);
}

// P-independent half of a doubling step: the tangent's (lambda, C) at T
// — which depend ONLY on T — plus the T <- 2T advance. The expensive
// part (one Fp2 inversion, ~a Fermat exponentiation) lives here, which
// is what makes precomputing these per distinct Q worthwhile.
static void dbl_coeff(Fp2 &lam, Fp2 &C, G2 &t) {
    Fp2 num, den, x2;
    f2_sqr(x2, t.x);
    f2_mul_small(num, x2, 3);
    f2_dbl(den, t.y);
    f2_inv(den, den);
    f2_mul(lam, num, den);
    Fp2 lx;
    f2_mul(lx, lam, t.x);
    f2_sub(C, t.y, lx);
    Fp2 x3, yy;
    f2_sqr(x3, lam);
    f2_sub(x3, x3, t.x);
    f2_sub(x3, x3, t.x);
    f2_sub(yy, t.x, x3);
    f2_mul(yy, lam, yy);
    f2_sub(yy, yy, t.y);
    t.x = x3;
    t.y = yy;
}

// P-dependent half: scale the line to the G1 point (2 fp_mul, no inversion).
static inline void line_eval(Fp2 &A, Fp2 &B, const Fp2 &lam, const Fp &xp,
                             const Fp &yp) {
    A.c0 = FP_ZERO; A.c1 = FP_ZERO;
    fp_neg(A.c0, yp);
    fp_mul(B.c0, lam.c0, xp);
    fp_mul(B.c1, lam.c1, xp);
}

// Doubling step: computes the tangent line at T evaluated at P AND advances
// T <- 2T, sharing one lambda (and thus one field inversion) between them.
static void dbl_step(Fp2 &A, Fp2 &B, Fp2 &C, G2 &t, const Fp &xp,
                     const Fp &yp) {
    Fp2 lam;
    dbl_coeff(lam, C, t);
    line_eval(A, B, lam, xp, yp);
}

// Addition step: chord line through T and Q at P; T <- T+Q; shares lambda.
// Returns false for the degenerate vertical case (T = -Q), where the line is
// xP - xT*w^2 and T becomes infinity — callers fall back to a generic mul.
static bool add_coeff(Fp2 &lam, Fp2 &C, G2 &t, const G2 &q) {
    if (f2_eq(t.x, q.x)) return false;
    Fp2 num, den;
    f2_sub(num, q.y, t.y);
    f2_sub(den, q.x, t.x);
    f2_inv(den, den);
    f2_mul(lam, num, den);
    Fp2 lx;
    f2_mul(lx, lam, t.x);
    f2_sub(C, t.y, lx);
    Fp2 x3, yy;
    f2_sqr(x3, lam);
    f2_sub(x3, x3, t.x);
    f2_sub(x3, x3, q.x);
    f2_sub(yy, t.x, x3);
    f2_mul(yy, lam, yy);
    f2_sub(yy, yy, t.y);
    t.x = x3;
    t.y = yy;
    return true;
}

static bool add_step(Fp2 &A, Fp2 &B, Fp2 &C, G2 &t, const G2 &q,
                     const Fp &xp, const Fp &yp) {
    Fp2 lam;
    if (!add_coeff(lam, C, t, q)) return false;
    line_eval(A, B, lam, xp, yp);
    return true;
}

static void mul_vertical(Fp12 &f, const G2 &t, const Fp &xp) {
    // l = xP - xT*w^2: generic fallback for the (vanishingly rare) T = -Q
    Fp12 l;
    memset(&l, 0, sizeof l);
    l.c0.c0.c0 = xp;
    f2_neg(l.c0.c1, t.x);
    f12_mul(f, f, l);
}

static void miller_loop(Fp12 &f, const G2 &q, const G1 &p) {
    f12_one(f);
    if (q.inf || p.inf) return;
    G2 t = q;
    Fp2 A, B, C;
    for (int i = ATE_TOP_BIT - 1; i >= 0; i--) {
        f12_sqr(f, f);
        if (!t.inf) {
            dbl_step(A, B, C, t, p.x, p.y);
            f12_mul_line(f, A, B, C);
        }
        bool bit = (i < 64) ? ((ATE_LOOP >> i) & 1) : true;
        if (bit && !t.inf) {
            if (add_step(A, B, C, t, q, p.x, p.y)) {
                f12_mul_line(f, A, B, C);
            } else {
                // T = -Q (unreachable for subgroup inputs; guarded anyway)
                mul_vertical(f, t, p.x);
                g2_add_pt(t, t, q);
            }
        }
    }
    G2 q1, q2, nq2;
    g2_frob_pt(q1, q);
    g2_frob_pt(q2, q1);
    g2_neg_pt(nq2, q2);
    if (!t.inf) {
        if (add_step(A, B, C, t, q1, p.x, p.y)) f12_mul_line(f, A, B, C);
        else { mul_vertical(f, t, p.x); g2_add_pt(t, t, q1); }
    }
    if (!t.inf) {
        if (add_step(A, B, C, t, nq2, p.x, p.y)) f12_mul_line(f, A, B, C);
        else mul_vertical(f, t, p.x);
    }
}

// ------------------------------------------------- prepared pairings
//
// Every dbl/add step above pays an Fp2 inversion (a Fermat
// exponentiation — by far the step's dominant cost), and the (lam, C)
// coefficients those inversions produce depend ONLY on the G2 argument.
// A BLS verification pairs (G2 generator, -sig) and (aggregated pool
// key, H(m)): the generator is fixed forever and the aggregate repeats
// per participant set, so both Miller loops run inversion-free once
// their coefficient sequences are cached (keyed by the raw 128-byte G2
// encoding; a small mutex-guarded table — ctypes callers release the
// GIL, so concurrent pairing checks are real).

#define PREP_MAX_STEPS 136        // 64 dbl + <=65 add + 2 frobenius adds
struct PreparedG2 {
    uint8_t key[128];
    int n_steps;
    bool used;
    Fp2 lam[PREP_MAX_STEPS];
    Fp2 c[PREP_MAX_STEPS];
};

static bool prepare_g2(PreparedG2 &pre, const G2 &q0) {
    pre.n_steps = 0;
    if (q0.inf) return false;
    G2 t = q0;
    int s = 0;
    for (int i = ATE_TOP_BIT - 1; i >= 0; i--) {
        if (t.inf || s + 2 > PREP_MAX_STEPS) return false;
        dbl_coeff(pre.lam[s], pre.c[s], t);
        s++;
        bool bit = (i < 64) ? ((ATE_LOOP >> i) & 1) : true;
        if (bit) {
            if (t.inf) return false;
            if (!add_coeff(pre.lam[s], pre.c[s], t, q0)) return false;
            s++;
        }
    }
    G2 q1, q2, nq2;
    g2_frob_pt(q1, q0);
    g2_frob_pt(q2, q1);
    g2_neg_pt(nq2, q2);
    if (t.inf || s + 2 > PREP_MAX_STEPS) return false;
    if (!add_coeff(pre.lam[s], pre.c[s], t, q1)) return false;
    s++;
    if (t.inf) return false;
    if (!add_coeff(pre.lam[s], pre.c[s], t, nq2)) return false;
    s++;
    pre.n_steps = s;
    return true;
}

// Same loop structure as miller_loop, consuming cached coefficients:
// zero inversions, two fp_mul per line.
static void miller_loop_prepared(Fp12 &f, const PreparedG2 &pre,
                                 const G1 &p) {
    f12_one(f);
    if (p.inf) return;
    Fp2 A, B;
    int s = 0;
    for (int i = ATE_TOP_BIT - 1; i >= 0; i--) {
        f12_sqr(f, f);
        line_eval(A, B, pre.lam[s], p.x, p.y);
        f12_mul_line(f, A, B, pre.c[s]);
        s++;
        bool bit = (i < 64) ? ((ATE_LOOP >> i) & 1) : true;
        if (bit) {
            line_eval(A, B, pre.lam[s], p.x, p.y);
            f12_mul_line(f, A, B, pre.c[s]);
            s++;
        }
    }
    line_eval(A, B, pre.lam[s], p.x, p.y);
    f12_mul_line(f, A, B, pre.c[s]);
    s++;
    line_eval(A, B, pre.lam[s], p.x, p.y);
    f12_mul_line(f, A, B, pre.c[s]);
}

#define PREP_CACHE_SLOTS 8
static PreparedG2 g_prep_cache[PREP_CACHE_SLOTS];
static uint64_t g_prep_last_hit[PREP_CACHE_SLOTS];
static uint64_t g_prep_tick = 0;
static std::mutex g_prep_mu;

// Copy only the LIVE coefficients (n_steps of PREP_MAX_STEPS) so the
// critical section stays short for concurrent pairing callers.
static void prep_copy(PreparedG2 &dst, const PreparedG2 &src) {
    memcpy(dst.key, src.key, sizeof src.key);
    dst.n_steps = src.n_steps;
    dst.used = src.used;
    memcpy(dst.lam, src.lam, sizeof(Fp2) * src.n_steps);
    memcpy(dst.c, src.c, sizeof(Fp2) * src.n_steps);
}

static bool prep_cache_get(const uint8_t *key, PreparedG2 &out) {
    std::lock_guard<std::mutex> lock(g_prep_mu);
    for (int i = 0; i < PREP_CACHE_SLOTS; i++) {
        if (g_prep_cache[i].used &&
                memcmp(g_prep_cache[i].key, key, 128) == 0) {
            prep_copy(out, g_prep_cache[i]);
            g_prep_last_hit[i] = ++g_prep_tick;   // LRU: hits keep the
            return true;                          // generator resident
        }
    }
    return false;
}

static void prep_cache_put(const uint8_t *key, const PreparedG2 &pre) {
    std::lock_guard<std::mutex> lock(g_prep_mu);
    int slot = 0;
    for (int i = 1; i < PREP_CACHE_SLOTS; i++) {
        if (!g_prep_cache[i].used) { slot = i; break; }
        if (g_prep_last_hit[i] < g_prep_last_hit[slot]) slot = i;
    }
    prep_copy(g_prep_cache[slot], pre);
    memcpy(g_prep_cache[slot].key, key, 128);
    g_prep_cache[slot].used = true;
    g_prep_last_hit[slot] = ++g_prep_tick;
}

static void final_exp(Fp12 &r, const Fp12 &f) {
    Fp12 inv, t, u;
    f12_inv(inv, f);
    f12_conj(t, f);
    f12_mul(t, t, inv);                 // f^(p^6 - 1), now unitary
    f12_frobenius(u, t, 2);
    f12_mul(t, u, t);                   // ^(p^2 + 1)
    f12_pow_hard(r, t);
}

// ------------------------------------------------------------------- I/O

static bool fp_from_be(Fp &out, const uint8_t *in) {
    Fp raw;
    for (int i = 0; i < 4; i++) {
        u64 w = 0;
        for (int j = 0; j < 8; j++)
            w = (w << 8) | in[(3 - i) * 8 + j];
        raw.v[i] = w;
    }
    if (cmp4(raw.v, PL) >= 0) return false;
    to_mont(out, raw);
    return true;
}

static void fp_to_be(uint8_t *out, const Fp &a) {
    Fp n;
    from_mont(n, a);
    for (int i = 0; i < 4; i++) {
        u64 w = n.v[3 - i];
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (uint8_t)(w >> (8 * (7 - j)));
    }
}

static bool is_zero_bytes(const uint8_t *b, int n) {
    for (int i = 0; i < n; i++)
        if (b[i]) return false;
    return true;
}

static bool g1_on_curve(const G1 &p) {
    if (p.inf) return true;
    Fp y2, x3, three;
    fp_sqr(y2, p.y);
    fp_sqr(x3, p.x);
    fp_mul(x3, x3, p.x);
    Fp b3 = {{3, 0, 0, 0}};
    to_mont(three, b3);
    fp_add(x3, x3, three);
    return fp_eq(y2, x3);
}

static bool g2_on_curve(const G2 &p) {
    if (p.inf) return true;
    // y^2 == x^3 + 3/xi
    Fp2 y2, x3, b2, three, xi;
    f2_sqr(y2, p.y);
    f2_sqr(x3, p.x);
    f2_mul(x3, x3, p.x);
    Fp t3 = {{3, 0, 0, 0}}, t9 = {{9, 0, 0, 0}}, t1 = {{1, 0, 0, 0}};
    to_mont(three.c0, t3);
    three.c1 = FP_ZERO;
    to_mont(xi.c0, t9);
    to_mont(xi.c1, t1);
    f2_inv(b2, xi);
    f2_mul(b2, b2, three);
    f2_add(x3, x3, b2);
    return f2_eq(y2, x3);
}

static bool decode_g1(G1 &out, const uint8_t *in) {
    if (is_zero_bytes(in, 64)) { out.inf = true; return true; }
    out.inf = false;
    if (!fp_from_be(out.x, in) || !fp_from_be(out.y, in + 32)) return false;
    return g1_on_curve(out);
}

static bool decode_g2(G2 &out, const uint8_t *in) {
    if (is_zero_bytes(in, 128)) { out.inf = true; return true; }
    out.inf = false;
    if (!fp_from_be(out.x.c0, in) || !fp_from_be(out.x.c1, in + 32) ||
        !fp_from_be(out.y.c0, in + 64) || !fp_from_be(out.y.c1, in + 96))
        return false;
    return g2_on_curve(out);
}

static void encode_g1(uint8_t *out, const G1 &p) {
    if (p.inf) { memset(out, 0, 64); return; }
    fp_to_be(out, p.x);
    fp_to_be(out + 32, p.y);
}

static void encode_g2(uint8_t *out, const G2 &p) {
    if (p.inf) { memset(out, 0, 128); return; }
    fp_to_be(out, p.x.c0);
    fp_to_be(out + 32, p.x.c1);
    fp_to_be(out + 64, p.y.c0);
    fp_to_be(out + 96, p.y.c1);
}

static void scalar_from_be(u64 *out, const uint8_t *in) {
    for (int i = 0; i < 4; i++) {
        u64 w = 0;
        for (int j = 0; j < 8; j++)
            w = (w << 8) | in[(3 - i) * 8 + j];
        out[i] = w;
    }
}

// ------------------------------------------------------------------- C ABI

extern "C" {

// prod of e(Q_i, P_i) == 1 ? 1 : 0; -1 on malformed input.
int pc_pairing_check(const uint8_t *g2s, const uint8_t *g1s, int n) {
    init_constants();
    Fp12 acc;
    memset(&acc, 0, sizeof acc);
    acc.c0.c0.c0 = FP_ONE_M;
    for (int i = 0; i < n; i++) {
        G2 q;
        G1 p;
        if (!decode_g2(q, g2s + 128 * i)) return -1;
        if (!decode_g1(p, g1s + 64 * i)) return -1;
        Fp12 f;
        // prepared path: reuse (or build) the coefficient sequence for
        // this G2 — inversion-free Miller loop on every cache hit. A
        // degenerate structure (infinity/vertical mid-ladder; impossible
        // for valid subgroup points) falls back to the generic loop.
        PreparedG2 pre;
        if (prep_cache_get(g2s + 128 * i, pre)) {
            miller_loop_prepared(f, pre, p);
        } else if (prepare_g2(pre, q)) {
            prep_cache_put(g2s + 128 * i, pre);
            miller_loop_prepared(f, pre, p);
        } else {
            miller_loop(f, q, p);
        }
        f12_mul(acc, acc, f);
    }
    Fp12 res;
    final_exp(res, acc);
    return f12_is_one(res) ? 1 : 0;
}

int pc_g1_mul(const uint8_t *in, const uint8_t *scalar, uint8_t *out) {
    init_constants();
    G1 p;
    if (!decode_g1(p, in)) return -1;
    u64 k[4];
    scalar_from_be(k, scalar);
    G1 r;
    g1_mul_pt(r, p, k);
    encode_g1(out, r);
    return 0;
}

int pc_g2_mul(const uint8_t *in, const uint8_t *scalar, uint8_t *out) {
    init_constants();
    G2 p;
    if (!decode_g2(p, in)) return -1;
    u64 k[4];
    scalar_from_be(k, scalar);
    G2 r;
    g2_mul_pt(r, p, k);
    encode_g2(out, r);
    return 0;
}

int pc_g1_add(const uint8_t *a, const uint8_t *b, uint8_t *out) {
    init_constants();
    G1 pa, pb, r;
    if (!decode_g1(pa, a) || !decode_g1(pb, b)) return -1;
    g1_add_pt(r, pa, pb);
    encode_g1(out, r);
    return 0;
}

int pc_g2_add(const uint8_t *a, const uint8_t *b, uint8_t *out) {
    init_constants();
    G2 pa, pb, r;
    if (!decode_g2(pa, a) || !decode_g2(pb, b)) return -1;
    g2_add_pt(r, pa, pb);
    encode_g2(out, r);
    return 0;
}

int pc_g2_in_subgroup(const uint8_t *in) {
    init_constants();
    G2 p;
    if (!decode_g2(p, in)) return 0;
    G2 r;
    g2_mul_pt(r, p, RL);
    return r.inf ? 1 : 0;
}

// --- differential-test surface (Fq12 laid out as 12 BE 32-byte coeffs in
// the order c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1) ------------------

static void f12_to_be(uint8_t *out, const Fp12 &a) {
    const Fp *cs[12] = {&a.c0.c0.c0, &a.c0.c0.c1, &a.c0.c1.c0, &a.c0.c1.c1,
                        &a.c0.c2.c0, &a.c0.c2.c1, &a.c1.c0.c0, &a.c1.c0.c1,
                        &a.c1.c1.c0, &a.c1.c1.c1, &a.c1.c2.c0, &a.c1.c2.c1};
    for (int i = 0; i < 12; i++) fp_to_be(out + 32 * i, *cs[i]);
}

extern "C" int pc_miller(const uint8_t *g2, const uint8_t *g1, uint8_t *out) {
    init_constants();
    G2 q;
    G1 p;
    if (!decode_g2(q, g2) || !decode_g1(p, g1)) return -1;
    Fp12 f;
    miller_loop(f, q, p);
    f12_to_be(out, f);
    return 0;
}

extern "C" int pc_final_exp(const uint8_t *in, uint8_t *out) {
    init_constants();
    Fp12 f;
    Fp *cs[12] = {&f.c0.c0.c0, &f.c0.c0.c1, &f.c0.c1.c0, &f.c0.c1.c1,
                  &f.c0.c2.c0, &f.c0.c2.c1, &f.c1.c0.c0, &f.c1.c0.c1,
                  &f.c1.c1.c0, &f.c1.c1.c1, &f.c1.c2.c0, &f.c1.c2.c1};
    for (int i = 0; i < 12; i++)
        if (!fp_from_be(*cs[i], in + 32 * i)) return -1;
    Fp12 r;
    final_exp(r, f);
    f12_to_be(out, r);
    return 0;
}

}  // extern "C"
