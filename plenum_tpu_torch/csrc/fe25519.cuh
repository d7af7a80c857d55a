// GF(2^255 - 19) and twisted Edwards point arithmetic for the Ed25519
// kernels (csrc/ed25519.cu), one field element per thread in registers.
//
// Layout: 10 signed int32 limbs in radix 2^25.5 (ref10's): limb i sits at
// bit 0, 26, 51, 77, ... and is 26 bits wide when i is even, 25 when odd.
// Products are 32x32->64 multiplies (IMAD.WIDE) summed in int64.
//
// "Carried" limbs satisfy |limb| < 2^26 + 2^7. fe_mul/fe_sq take carried
// inputs: products stay below 2^57.3 and each 10-term sum below 2^61; three
// parallel carry passes then bring the result back to carried form.
// fe_add/fe_sub of carried inputs need one pass. Every operation here is
// the one the plain PyTorch version in plenum_tpu_torch/ops/ed25519.py runs
// (same passes, same order), so kernel and plain version agree limb for
// limb. Squaring sums the same products as fe_mul(f, f), pairing the
// symmetric ones: the integers, and so the limbs, are identical.
//
// Device functions under nvcc; plain inline C++ otherwise, so the same code
// also compiles for the host for a differential check without a GPU.
#pragma once
#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define FE_HD __device__ __forceinline__
#else
#define FE_HD inline
#endif

struct fe {
  int32_t v[10];
};

struct ge {  // extended coordinates (X:Y:Z:T); T may hold 2d*T in tables
  fe X, Y, Z, T;
};

FE_HD int fe_bits(int i) { return (i & 1) ? 25 : 26; }

FE_HD fe fe_const(int32_t a0, int32_t a1, int32_t a2, int32_t a3, int32_t a4,
                  int32_t a5, int32_t a6, int32_t a7, int32_t a8, int32_t a9) {
  fe r = {{a0, a1, a2, a3, a4, a5, a6, a7, a8, a9}};
  return r;
}

FE_HD fe fe_zero() { return fe_const(0, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
FE_HD fe fe_one() { return fe_const(1, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
FE_HD fe fe_d() {
  return fe_const(56195235, 13857412, 51736253, 6949390, 114729, 24766616,
                  60832955, 30306712, 48412415, 21499315);
}
FE_HD fe fe_d2() {
  return fe_const(45281625, 27714825, 36363642, 13898781, 229458, 15978800,
                  54557047, 27058993, 29715967, 9444199);
}
FE_HD fe fe_sqrt_m1() {
  return fe_const(34513072, 25610706, 9377949, 3500415, 12389472, 33281959,
                  41962654, 31548777, 326685, 11406482);
}

// One parallel carry pass: limb i keeps its low bits and takes limb i-1's
// carry; limb 9's carry wraps to limb 0 times 19 (2^255 = 19 mod p).
FE_HD void fe_carry(fe& h) {
  int32_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = h.v[i] >> fe_bits(i);
#pragma unroll
  for (int i = 0; i < 10; ++i)
    h.v[i] = (h.v[i] & ((1 << fe_bits(i)) - 1)) + (i == 0 ? 19 * c[9] : c[i - 1]);
}

FE_HD void fe_carry64(int64_t t[10]) {
  int64_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = t[i] >> fe_bits(i);
#pragma unroll
  for (int i = 0; i < 10; ++i)
    t[i] = (t[i] & ((int64_t(1) << fe_bits(i)) - 1)) +
           (i == 0 ? 19 * c[9] : c[i - 1]);
}

FE_HD fe fe_add(const fe& f, const fe& g) {
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
  return h;
}

FE_HD fe fe_sub(const fe& f, const fe& g) {
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] - g.v[i];
  fe_carry(h);
  return h;
}

FE_HD fe fe_from64(int64_t t[10]) {
  fe_carry64(t);
  fe_carry64(t);
  fe_carry64(t);
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = (int32_t)t[i];
  return h;
}

// Schoolbook: t[(i+j) mod 10] += f_i g_j m_ij, m_ij = 2 when i and j are
// both odd, times 19 when i + j >= 10.
FE_HD fe fe_mul(const fe& f, const fe& g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      t[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_from64(t);
}

// fe_mul(f, f) with the symmetric products paired: 55 multiplies.
FE_HD fe fe_sq(const fe& f) {
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      int32_t a = ((i & 1) && (j & 1)) ? 2 * f.v[i] : f.v[i];
      int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
      int64_t prod = (int64_t)a * b;
      t[(i + j) % 10] += (j > i) ? 2 * prod : prod;
    }
  }
  return fe_from64(t);
}

FE_HD fe fe_pow2k(fe z, int k) {
  for (int i = 0; i < k; ++i) z = fe_sq(z);
  return z;
}

// -> z^(2^250 - 1); z11 gets z^11.
FE_HD fe fe_chain_250(const fe& z, fe& z11) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(fe_pow2k(z2, 2), z);
  z11 = fe_mul(z9, z2);
  fe z_5 = fe_mul(fe_sq(z11), z9);
  fe z_10 = fe_mul(fe_pow2k(z_5, 5), z_5);
  fe z_20 = fe_mul(fe_pow2k(z_10, 10), z_10);
  fe z_40 = fe_mul(fe_pow2k(z_20, 20), z_20);
  fe z_50 = fe_mul(fe_pow2k(z_40, 10), z_10);
  fe z_100 = fe_mul(fe_pow2k(z_50, 50), z_50);
  fe z_200 = fe_mul(fe_pow2k(z_100, 100), z_100);
  return fe_mul(fe_pow2k(z_200, 50), z_50);
}

FE_HD fe fe_inv(const fe& z) {  // z^(p-2)
  fe z11;
  fe z_250 = fe_chain_250(z, z11);
  return fe_mul(fe_pow2k(z_250, 5), z11);
}

FE_HD fe fe_pow_p58(const fe& z) {  // z^((p-5)/8)
  fe z11;
  fe z_250 = fe_chain_250(z, z11);
  return fe_mul(fe_pow2k(z_250, 2), z);
}

// Sequential carry, 2^255 -> 19 wrap.
FE_HD void fe_normalize(fe& h) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    int32_t c = h.v[i] >> fe_bits(i);
    h.v[i] &= (1 << fe_bits(i)) - 1;
    if (i < 9) h.v[i + 1] += c;
    else h.v[0] += 19 * c;
  }
}

// 1 when the normalized value v (< 2^255) is >= p, i.e. v + 19 >= 2^255.
FE_HD int32_t fe_ge_p(const fe& h) {
  int32_t q = (h.v[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; ++i) q = (h.v[i] + q) >> fe_bits(i);
  return q;
}

// The unique limbs of the value mod p. Adding p first lifts the small
// negative limbs that carried form allows.
FE_HD fe fe_canon(const fe& f) {
  const int32_t p_limbs[10] = {67108845, 33554431, 67108863, 33554431,
                               67108863, 33554431, 67108863, 33554431,
                               67108863, 33554431};
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + p_limbs[i];
  fe_normalize(h);
  fe_normalize(h);
  fe_normalize(h);
  int32_t q = fe_ge_p(h);
  h.v[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    int32_t c = h.v[i] >> fe_bits(i);
    h.v[i] &= (1 << fe_bits(i)) - 1;
    h.v[i + 1] += c;
  }
  h.v[9] &= (1 << 25) - 1;
  return h;
}

FE_HD bool fe_equal(const fe& a, const fe& b) {
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) diff |= a.v[i] ^ b.v[i];
  return diff == 0;
}

FE_HD bool fe_is_zero(const fe& a) {
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc |= a.v[i];
  return acc == 0;
}

// uint8[32] little-endian -> limbs of the low 255 bits (not reduced).
FE_HD fe fe_from_bytes(const uint8_t* b) {
  const int pos[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    int lo = pos[i] / 8;
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (lo + k < 32) v |= (uint64_t)b[lo + k] << (8 * k);
    h.v[i] = (int32_t)((v >> (pos[i] % 8)) & ((1u << fe_bits(i)) - 1));
  }
  return h;
}

// The JAX package's layout: 20 signed 13-bit limbs, limb i at bit 13 i,
// "carried" (each in [-2, 2^13 + 3]) or canonical. l[i * stride] is limb
// i, so one reader serves row-major rows (stride 1) and limb-major
// columns (stride N). The value sum l_i 2^(13 i) is gathered into the
// ten limbs as they sit (13-bit limb i lands in limb j with FE_POS[j] <=
// 13 i, shifted by at most 17 bits, so a sum stays below 2^31 in int64),
// then fe_from64's three carry passes bring it to carried form; the bits
// at 2^255 and above wrap as 19 through limb 9's carry. Signs are kept:
// a borrowed limb is a negative term, never masked.
FE_HD fe fe_from_limbs13(const int32_t* l, int stride) {
  const int pos[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
  int64_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    int b = 13 * i, j = 9;
#pragma unroll
    for (int k = 9; k > 0; --k)
      if (b < pos[k]) j = k - 1;
    t[j] += (int64_t)l[(size_t)i * stride] * ((int64_t)1 << (b - pos[j]));
  }
  return fe_from64(t);
}

// Canonical limbs (fe_canon's output) -> the 20 canonical 13-bit limbs of
// the same value, written to out[i * stride]. A 13-bit window spans at
// most two of the ten limbs (each is 25 or 26 bits wide).
FE_HD void fe_to_limbs13_canon(const fe& f, int32_t* out, int stride) {
  const int pos[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    int b = 13 * i, j = 9;
#pragma unroll
    for (int k = 9; k > 0; --k)
      if (b < pos[k]) j = k - 1;
    uint32_t v = (uint32_t)f.v[j] >> (b - pos[j]);
    if (j < 9) v |= (uint32_t)f.v[j + 1] << (pos[j + 1] - b);
    out[(size_t)i * stride] = (int32_t)(v & 8191u);
  }
}

FE_HD ge ge_identity() {
  ge r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  return r;
}

// Unified addition (add-2008-hwcd-3) with the 2d multiply.
FE_HD ge ge_add(const ge& p, const ge& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(fe_mul(p.T, q.T), fe_d2());
  fe zz = fe_mul(p.Z, q.Z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Addition where q.T already holds 2d*T (window-table entries).
FE_HD ge ge_add_t2d(const ge& p, const ge& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(p.T, q.T);
  fe zz = fe_mul(p.Z, q.Z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Mixed addition with an affine niels point (y+x, y-x, 2d*x*y), Z = 1.
FE_HD ge ge_madd(const ge& p, const fe& ypx, const fe& ymx, const fe& t2d) {
  fe a = fe_mul(fe_sub(p.Y, p.X), ymx);
  fe b = fe_mul(fe_add(p.Y, p.X), ypx);
  fe c = fe_mul(p.T, t2d);
  fe d = fe_add(p.Z, p.Z);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// dbl-2008-hwcd for a = -1: 4 squarings + 4 multiplies (T not read).
FE_HD ge ge_double(const ge& p) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe zz = fe_sq(p.Z);
  fe c = fe_add(zz, zz);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}
