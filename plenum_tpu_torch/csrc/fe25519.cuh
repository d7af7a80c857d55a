// GF(2^255 - 19) and twisted Edwards point arithmetic for the Ed25519
// kernels (csrc/ed25519.cu), field elements in registers: the serial point
// formulas keep a point in one thread, the quad formulas at the end spread
// it over four lanes.
//
// Layout: 10 signed int32 limbs in radix 2^25.5 (ref10's): limb i sits at
// bit 0, 26, 51, 77, ... and is 26 bits wide when i is even, 25 when odd.
// Products are 32x32->64 multiplies (IMAD.WIDE) summed in int64.
//
// "Carried" limbs satisfy |limb| < 2^26 + 2^7. fe_mul/fe_sq take carried
// inputs: products stay below 2^57.3 and each 10-term sum below 2^61; three
// parallel carry passes then bring the result back to carried form.
// fe_add/fe_sub of carried inputs need one pass. Every operation here
// computes the integers the plain PyTorch version in
// plenum_tpu_torch/ops/ed25519.py computes (the same sums, the same carry
// passes in the same order; a pass may run in 32 bits where the values
// fit), so kernel and plain version agree limb for limb. Squaring sums the
// same products as fe_mul(f, f), pairing the symmetric ones: the integers,
// and so the limbs, are identical.
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

// Three carry passes of 10 int64 column sums (each below 2^61) into
// carried limbs. After the first pass a value is below 2^41, so the
// second pass's carry and kept bits fit in 32 bits and its result below
// 2^27: the second pass takes the carries in int64 and adds in int32, the
// third is fe_carry. The integers are those of three fe_carry64 passes.
FE_HD fe fe_from64(int64_t t[10]) {
  fe_carry64(t);
  int32_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = (int32_t)(t[i] >> fe_bits(i));
  fe h;
#pragma unroll
  for (int i = 0; i < 10; ++i)
    h.v[i] = ((int32_t)t[i] & ((1 << fe_bits(i)) - 1)) +
             (i == 0 ? 19 * c[9] : c[i - 1]);
  fe_carry(h);
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

// fe_mul(f, f) with the symmetric products paired: 55 multiplies. A pair
// (j > i) adds 2 a b as (2 a) b, 2 a below 2^29: the same integer, one
// multiply-add.
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
      t[(i + j) % 10] += (int64_t)((j > i) ? 2 * a : a) * b;
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

// --- quad point formulas ---------------------------------------------------
// One point on a team of four adjacent lanes (a "quad"): lane c holds
// coordinate c (X, Y, Z, T) of the point. Every formula above is two
// stages of four independent field operations; in stage 1 each lane runs
// one of them, the quad all-gathers the four results (quad_gather), every
// lane forms the sums it needs, and in stage 2 lane c runs the product
// that becomes coordinate c. Each lane runs exactly the
// field operations the serial formulas run, on the same inputs, so the
// limbs are the serial ones.
//
// The per-lane math takes (lane, values); the exchange is an object `Q`
// with `lane`, `shfl(v, src)` (v of quad lane src) and `shfl_xor(v, m)`
// (v of lane ^ m): WarpQuad below on the card, HostQuad (four host
// threads meeting at a barrier) when the file is compiled as host C++.

FE_HD fe fe_select(bool c, const fe& a, const fe& b) {  // c ? a : b
  fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// The quad's four values in lane order: four 10-limb shuffles, one from
// each lane (this lane's own included). On the card this ran faster than
// three xor shuffles followed by the 80 selects that put their results in
// lane order.
template <class Q>
FE_HD void quad_gather(const Q& qd, const fe& own, fe g[4]) {
  for (int j = 0; j < 4; ++j) g[j] = qd.shfl(own, j);
}

// An addition's stage-1 left operand: lane 0 y - x, lane 1 y + x (one
// carry pass each, as fe_sub and fe_add), lanes 2 and 3 w.
FE_HD fe quad_yx(int lane, const fe& y, const fe& x, const fe& w) {
  if (lane == 0) return fe_sub(y, x);
  if (lane == 1) return fe_add(y, x);
  return w;
}

// The common tail from the gathered (a, b, d, c): e = b - a, f = d - c,
// g = d + c, h = b + a; lane c's stage-2 operands (e, f), (g, h), (f, g),
// (e, h).
FE_HD void quad_tail_add(int lane, const fe g4[4], fe& l, fe& r) {
  fe e = fe_sub(g4[1], g4[0]), f = fe_sub(g4[2], g4[3]);
  fe g = fe_add(g4[2], g4[3]), h = fe_add(g4[1], g4[0]);
  l = fe_select(lane == 1, g, fe_select(lane == 2, f, e));
  r = fe_select(lane == 0, f, fe_select(lane == 2, g, h));
}

// ge_double's tail from the gathered (X^2, (X+Y)^2, Z^2, Y^2).
FE_HD void quad_tail_double(int lane, const fe g4[4], fe& l, fe& r) {
  fe zz2 = fe_add(g4[2], g4[2]);
  fe h = fe_add(g4[0], g4[3]);
  fe e = fe_sub(h, g4[1]);
  fe g = fe_sub(g4[0], g4[3]);
  fe f = fe_add(zz2, g);
  l = fe_select(lane == 1, g, fe_select(lane == 2, f, e));
  r = fe_select(lane == 0, f, fe_select(lane == 2, g, h));
}

// ge_double on a quad: this lane's coordinate of 2p. Stage 1: lane 0 X^2,
// lane 1 (X+Y)^2, lane 2 Z^2, lane 3 Y^2 (lanes 1 and 3 take X or Y from
// lanes 0 and 1 in one shuffle).
template <class Q>
FE_HD fe quad_double(const Q& qd, const fe& own) {
  int lane = qd.lane;
  fe other = qd.shfl(own, lane == 1 ? 0 : 1);
  fe s = lane == 1 ? fe_add(other, own) : fe_select(lane == 3, other, own);
  fe g4[4], l, r;
  quad_gather(qd, fe_sq(s), g4);
  quad_tail_double(lane, g4, l, r);
  return fe_mul(l, r);
}

enum QuadAddKind {
  kQuadAddT2d,  // ge_add_t2d: the operand's T holds 2d*T
  kQuadAdd,     // ge_add: the extra multiply by 2d, on lane 3
  kQuadMadd,    // ge_madd: an affine niels operand, Z = 1
};

// An addition on a quad: this lane's coordinate of p + q. `rhs` is this
// lane's stage-1 right operand: Y2 - X2, Y2 + X2, Z2, T2 (or 2d*T2) for
// ge_add_t2d and ge_add (quad_yx of q's coordinates), y-x, y+x, unused,
// 2dxy for ge_madd. Stage 1: lane 0 a, lane 1 b, lane 2 d (2 Z Z2, or 2 Z
// for ge_madd), lane 3 c; lanes 0 and 1 swap X and Y first. ge_add's
// multiply of c by 2d is a stage of its own on lane 3, which the other
// lanes may fill: with `side`, lanes 0-2 turn *side into *side * 2d there.
template <class Q>
FE_HD fe quad_add(const Q& qd, const fe& own, const fe& rhs,
                  QuadAddKind kind, fe* side = nullptr) {
  int lane = qd.lane;
  fe other = qd.shfl_xor(own, 1);
  fe p;
  if (kind == kQuadMadd && lane == 2) {
    p = fe_add(own, own);
  } else {
    p = fe_mul(quad_yx(lane, fe_select(lane == 0, other, own),
                       fe_select(lane == 0, own, other), own),
               rhs);
    if (lane == 2) p = fe_add(p, p);
  }
  if (kind == kQuadAdd) {
    if (side) {
      fe m = fe_mul(lane == 3 ? p : *side, fe_d2());
      if (lane == 3) p = m;
      else *side = m;
    } else if (lane == 3) {
      p = fe_mul(p, fe_d2());
    }
  }
  fe g4[4], l, r;
  quad_gather(qd, p, g4);
  quad_tail_add(lane, g4, l, r);
  return fe_mul(l, r);
}

#ifdef __CUDACC__
// The exchange on the card: shuffles over this thread's quad only (width
// 4, the quad's four bits in the mask), so a quad that has left does not
// strand the others of its warp.
struct WarpQuad {
  int lane;
  unsigned mask;
  __device__ fe shfl(const fe& v, int src) const {
    fe r;
#pragma unroll
    for (int i = 0; i < 10; ++i) r.v[i] = __shfl_sync(mask, v.v[i], src, 4);
    return r;
  }
  __device__ fe shfl_xor(const fe& v, int m) const {
    fe r;
#pragma unroll
    for (int i = 0; i < 10; ++i) r.v[i] = __shfl_xor_sync(mask, v.v[i], m, 4);
    return r;
  }
};

__device__ __forceinline__ WarpQuad warp_quad() {
  int t = threadIdx.x & 31;
  return WarpQuad{t & 3, 0xFu << (t & ~3)};
}
#else
#include <barrier>
// The exchange on the host: four threads, one per lane, share `slots`;
// each publishes its value, all meet, each reads its source, all meet.
struct HostQuadSlots {
  fe v[4];
  std::barrier<> meet{4};
};

struct HostQuad {
  int lane;
  HostQuadSlots* s;
  fe shfl(const fe& v, int src) const {
    s->v[lane] = v;
    s->meet.arrive_and_wait();
    fe r = s->v[src];
    s->meet.arrive_and_wait();
    return r;
  }
  fe shfl_xor(const fe& v, int m) const { return shfl(v, lane ^ m); }
};
#endif
