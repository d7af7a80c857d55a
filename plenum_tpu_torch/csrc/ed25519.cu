// Batched Ed25519 verification: kernels K3 (keys) and K4 (signatures) of
// the compressed dispatch, K5 (staged keys) and K6 (staged signatures) of
// the limb-staged dispatch, and K8, the field squaring chain.
//
// Replaces (JAX package, jitted jax.numpy programs, and one Pallas probe):
//   K3 ed25519_decompress <- plenum_tpu/ops/ed25519.py:521 decompress_kernel
//                            and :424 _build_a_tables
//   K4 ed25519_verify     <- plenum_tpu/ops/ed25519.py:599 verify_kernel_bytes
//                            (:576 unpack_scalars_kernel, :660
//                            _banks_and_ladder); with K3 it is the whole of it
//   K5 ed25519_quarter_tables <- plenum_tpu/ops/ed25519.py:627 verify_kernel
//                            and :475 verify_kernel_indexed, their
//                            _build_a_tables over host-staged quarter rows
//   K6 ed25519_verify_staged  <- the same two, their _banks_and_ladder on
//                            staged digit arrays; K5 then K6 is the whole
//   K8 field_chain        <- probes/pallas_sqr_experiment.py:57
//                            make_pallas_chain (the pl.pallas_call at :69)
//
// Bound on an H100: 32-bit integer multiply issue. Per signature K4 and K6
// run ~1,500 field multiplies (64 doublings, 64 table additions, 32 comb
// additions, one 265-step inversion), i.e. ~120,000 32x32->64 multiply-adds
// against ~100 bytes (K4) or ~470 bytes (K6) of input; per key K3 runs
// ~2,400 (the square root, 192 doublings for the quarter points, 4 x 15
// table entries) against 32 bytes in and 10 KB of tables out, and K5 the
// table entries alone (~900) against 1,280 bytes in. K8 is 55 multiplies
// per squaring against 160 bytes per column. Memory is nowhere near the
// limit.
//
// Design: one thread per key (K3, K5), per signature (K4, K6) or per
// column (K8), all state in registers, no cross-thread traffic. What the
// TPU program did with one-hot matmuls on its matrix unit (selecting window-table and comb
// entries by digit) is a plain indexed load here: the per-key tables
// (10 KB each, written by K3) and the fixed-base comb table (32 x 256 niels
// points, 960 KB, resident in device memory) are gathered by digit
// straight from L2. Field elements use ref10's 10-limb radix-2^25.5 layout
// with 64-bit products (fe25519.cuh) in place of the TPU's 20x13-bit int32
// limbs; K5, K6 and K8 take the reference's 13-bit limbs as they are
// staged and convert them in registers (fe_from_limbs13, signs kept). K4
// and K6 share one ladder (verify_one), templated on how a signature's
// digits are read and how R is compared; K3 and K5 share the table build
// (build_key_tables), templated on where the quarter points come from.
// The verdict semantics are the reference's exactly: cofactorless,
// R compared as bytes (so a non-canonical R fails), keys rejected for
// y >= p, off-curve, or x = 0 with the sign bit set; an invalid key forces
// its signatures' verdicts to false.
//
// What holds it back today: a batch of 1,024 signatures is 8 blocks of 128
// threads on 132 SMs, so most of the card idles; and K3's per-key chain is
// serial in one thread. Spreading a signature's field multiplies over a few
// threads is later work.
//
// Plain C interface (bound with ctypes): each launcher returns
// cudaGetLastError() right after its launch.
#include <cstddef>
#include <cstdint>

#include "fe25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ED_HD __device__ __forceinline__
#else
#define ED_HD inline
#endif

// Layouts (int32 limbs, row-major):
//   aq       [U][4 quarters][4 coords X,Y,Z,T][20]  (13-bit limbs, K5 in)
//   quarters [U][4 quarters][4 coords X,Y,Z,T][10]
//   tables   [U][4 quarters][16 entries][4 coords X,Y,Z,2dT][10]
//   comb     [32 positions][256 digits][3 coords y+x,y-x,2dxy][10]
constexpr int kQuarterStride = 4 * 10;
constexpr int kEntryStride = 4 * 10;
constexpr int kTableStride = 16 * kEntryStride;        // per quarter
constexpr int kKeyTableStride = 4 * kTableStride;      // per key

ED_HD void fe_store(int32_t* dst, const fe& f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) dst[i] = f.v[i];
}

ED_HD fe fe_load(const int32_t* src) {
  fe f;
#pragma unroll
  for (int i = 0; i < 10; ++i) f.v[i] = src[i];
  return f;
}

ED_HD void ge_store(int32_t* dst, const ge& p) {
  fe_store(dst, p.X);
  fe_store(dst + 10, p.Y);
  fe_store(dst + 20, p.Z);
  fe_store(dst + 30, p.T);
}

ED_HD ge ge_load(const int32_t* src) {
  ge p;
  p.X = fe_load(src);
  p.Y = fe_load(src + 10);
  p.Z = fe_load(src + 20);
  p.T = fe_load(src + 30);
  return p;
}

// Store a table entry: (X, Y, Z, 2d*T).
ED_HD void entry_store(int32_t* dst, const ge& p) {
  fe_store(dst, p.X);
  fe_store(dst + 10, p.Y);
  fe_store(dst + 20, p.Z);
  fe_store(dst + 30, fe_mul(p.T, fe_d2()));
}

// Window tables of a key's four quarter points: per quarter tab[0] = the
// identity, tab[1] = q, tab[2j] = dbl(tab[j]), tab[2j+1] = tab[2j] + q.
// Entries go straight to memory; doubling reads back only X, Y, Z (the T
// slot holds 2d*T by then). `quarter(k)` yields quarter k as a carried
// point: K3 reads back the points it just stored, K5 converts the
// reference's 13-bit limb rows.
template <class QuarterLoader>
ED_HD void build_key_tables(const QuarterLoader& quarter, int32_t* tables) {
  for (int k = 0; k < 4; ++k) {
    ge q = quarter(k);
    int32_t* tab = tables + k * kTableStride;
    entry_store(tab, ge_identity());
    entry_store(tab + kEntryStride, q);
    for (int j = 1; j < 8; ++j) {
      ge src = ge_load(tab + j * kEntryStride);
      ge dbl = ge_double(src);
      entry_store(tab + 2 * j * kEntryStride, dbl);
      entry_store(tab + (2 * j + 1) * kEntryStride, ge_add(dbl, q));
    }
  }
}

// Quarter points in the port's layout: quarters [4][4 coords][10].
struct FeQuarters {
  const int32_t* rows;
  ED_HD ge operator()(int k) const { return ge_load(rows + k * kQuarterStride); }
};

// Quarter points in the reference's layout: int32 [4][4 coords][20] of
// 13-bit limbs (ext_quarters), carried or canonical.
struct Limb13Quarters {
  const int32_t* rows;
  ED_HD ge operator()(int k) const {
    const int32_t* q = rows + k * 4 * 20;
    ge p;
    p.X = fe_from_limbs13(q, 1);
    p.Y = fe_from_limbs13(q + 20, 1);
    p.Z = fe_from_limbs13(q + 40, 1);
    p.T = fe_from_limbs13(q + 60, 1);
    return p;
  }
};

// K3, one key: RFC 8032 §5.1.3 decompression of A, then -A's quarter
// points [2^(64k)](-A) and their 16-entry window tables.
ED_HD void decompress_one(const uint8_t* key, int32_t* quarters,
                          int32_t* tables, bool* valid) {
  int32_t sign = key[31] >> 7;
  fe y = fe_from_bytes(key);
  bool noncanon = fe_ge_p(y) != 0;
  fe one = fe_one();
  fe y2 = fe_sq(y);
  fe u = fe_sub(y2, one);
  fe v = fe_add(fe_mul(y2, fe_d()), one);
  fe v3 = fe_mul(fe_sq(v), v);
  fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  fe vxx = fe_mul(v, fe_sq(x));
  bool ok1 = fe_is_zero(fe_canon(fe_sub(vxx, u)));  // v x^2 =  u
  bool ok2 = fe_is_zero(fe_canon(fe_add(vxx, u)));  // v x^2 = -u
  if (!ok1) x = fe_mul(x, fe_sqrt_m1());
  fe xc = fe_canon(x);
  bool x_zero = fe_is_zero(xc);
  fe neg_xc = fe_canon(fe_sub(fe_zero(), xc));
  bool flip = (xc.v[0] & 1) != sign;
  // A = (x with the sign bit's parity, y); the ladder wants -A = (-x, y)
  fe negx = flip ? xc : neg_xc;
  *valid = (ok1 || ok2) && !noncanon && !(x_zero && sign == 1);

  ge pt;
  pt.X = negx;
  pt.Y = y;
  pt.Z = one;
  pt.T = fe_mul(negx, y);
  for (int k = 0; k < 4; ++k) {
    if (k > 0)
      for (int i = 0; i < 64; ++i) pt = ge_double(pt);
    ge_store(quarters + k * kQuarterStride, pt);
  }
  build_key_tables(FeQuarters{quarters}, tables);
}

// A signature's operands as K4 reads them: raw S, h and R bytes.
struct BytesSig {
  const uint8_t* s;
  const uint8_t* h;
  const uint8_t* r;
  // window t (LSB first) of 64-bit quarter q of h
  ED_HD int h_digit(int q, int t) const {
    int byte = h[8 * q + t / 2];
    return (t & 1) ? (byte >> 4) : (byte & 15);
  }
  ED_HD int s_digit(int w) const { return s[w]; }
  // R compared as bytes: y' with the low 255 bits, x's parity with bit 255
  ED_HD bool matches(const fe& x, const fe& y) const {
    return fe_equal(y, fe_from_bytes(r)) && (x.v[0] & 1) == (r[31] >> 7);
  }
};

// A signature's operands as K6 reads them: the reference's staged digit
// arrays, batch axis last (s_digits [32][N], h_digits [16][4][N]), and R
// as 20 13-bit limbs of y plus the sign. Digits are taken mod 16 and 256
// (the host's staging gives no others). The R compare is exact on the
// limbs as given, never reduced: canonical y' written as 13-bit limbs
// against ry limb for limb, x's parity against r_sign.
struct StagedSig {
  const int32_t* s_digits;
  const int32_t* h_digits;
  const int32_t* ry;  // this signature's 20 limbs
  int32_t r_sign;
  int n, i;
  ED_HD int h_digit(int q, int t) const {
    return h_digits[((size_t)t * 4 + q) * n + i] & 15;
  }
  ED_HD int s_digit(int w) const { return s_digits[(size_t)w * n + i] & 255; }
  ED_HD bool matches(const fe& x, const fe& y) const {
    int32_t yl[20];
    fe_to_limbs13_canon(y, yl, 1);
    int32_t diff = 0;
#pragma unroll
    for (int k = 0; k < 20; ++k) diff |= yl[k] ^ ry[k];
    return diff == 0 && (x.v[0] & 1) == r_sign;
  }
};

// K4 and K6, one signature: compress([S]B + [h](-A)) == R, A's tables
// given; `sig` supplies the digits and the compare.
template <class Sig>
ED_HD bool verify_one(const Sig& sig, const int32_t* key_tables,
                      const int32_t* comb) {
  ge acc = ge_identity();
  for (int t = 15; t >= 0; --t) {      // MSB-first 4-bit windows
    for (int i = 0; i < 4; ++i) acc = ge_double(acc);
    for (int q = 0; q < 4; ++q)
      acc = ge_add_t2d(acc, ge_load(key_tables + q * kTableStride +
                                    sig.h_digit(q, t) * kEntryStride));
  }
  for (int w = 0; w < 32; ++w) {       // fixed-base comb, 8-bit digits of S
    const int32_t* e = comb + ((size_t)w * 256 + sig.s_digit(w)) * 30;
    acc = ge_madd(acc, fe_load(e), fe_load(e + 10), fe_load(e + 20));
  }
  fe zinv = fe_inv(acc.Z);
  fe x = fe_canon(fe_mul(acc.X, zinv));
  fe y = fe_canon(fe_mul(acc.Y, zinv));
  return sig.matches(x, y);
}

// K8, one column: x^(2^k) by k squarings, from and back to 13-bit limbs
// (canonical on the way out).
ED_HD void field_chain_one(const int32_t* x, int32_t* out, int stride, int k) {
  fe z = fe_pow2k(fe_from_limbs13(x, stride), k);
  fe_to_limbs13_canon(fe_canon(z), out, stride);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(64)
k_ed25519_decompress(const uint8_t* __restrict__ keys,
                     int32_t* __restrict__ quarters,
                     int32_t* __restrict__ tables,
                     bool* __restrict__ valid, int n_keys) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_keys) return;
  decompress_one(keys + (size_t)u * 32, quarters + (size_t)u * 4 * kQuarterStride,
                 tables + (size_t)u * kKeyTableStride, valid + u);
}

__global__ void __launch_bounds__(128)
k_ed25519_verify(const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                 const uint8_t* __restrict__ r, const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ tables,
                 const bool* __restrict__ valid,
                 const int32_t* __restrict__ comb, bool* __restrict__ out,
                 int n, int n_keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int u = idx[i];
  if (u < 0 || u >= n_keys) {
    out[i] = false;
    return;
  }
  BytesSig sig{s + (size_t)i * 32, h + (size_t)i * 32, r + (size_t)i * 32};
  bool ok = verify_one(sig, tables + (size_t)u * kKeyTableStride, comb);
  out[i] = ok && valid[u];
}

__global__ void __launch_bounds__(64)
k_ed25519_quarter_tables(const int32_t* __restrict__ aq,
                         int32_t* __restrict__ tables, int n_rows) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_rows) return;
  build_key_tables(Limb13Quarters{aq + (size_t)u * 4 * 4 * 20},
                   tables + (size_t)u * kKeyTableStride);
}

__global__ void __launch_bounds__(128)
k_ed25519_verify_staged(const int32_t* __restrict__ s_digits,
                        const int32_t* __restrict__ h_digits,
                        const int32_t* __restrict__ ry,
                        const int32_t* __restrict__ r_sign,
                        const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ comb,
                        bool* __restrict__ out, int n, int n_rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int u = idx[i];
  if (u < 0 || u >= n_rows) {
    out[i] = false;
    return;
  }
  StagedSig sig{s_digits, h_digits, ry + (size_t)i * 20, r_sign[i], n, i};
  out[i] = verify_one(sig, tables + (size_t)u * kKeyTableStride, comb);
}

__global__ void __launch_bounds__(128)
k_field_chain(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
              int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  field_chain_one(x + i, out + i, n, k);
}

extern "C" int ed25519_decompress_launch(const void* keys, void* quarters,
                                         void* tables, void* valid, int n_keys,
                                         void* stream) {
  const int threads = 64;
  k_ed25519_decompress<<<(n_keys + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)keys, (int32_t*)quarters, (int32_t*)tables,
      (bool*)valid, n_keys);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_launch(const void* s, const void* h,
                                     const void* r, const void* idx,
                                     const void* tables, const void* valid,
                                     const void* comb, void* out, int n,
                                     int n_keys, void* stream) {
  const int threads = 128;
  k_ed25519_verify<<<(n + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)s, (const uint8_t*)h, (const uint8_t*)r,
      (const int32_t*)idx, (const int32_t*)tables, (const bool*)valid,
      (const int32_t*)comb, (bool*)out, n, n_keys);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_quarter_tables_launch(const void* aq, void* tables,
                                             int n_rows, void* stream) {
  const int threads = 64;
  k_ed25519_quarter_tables<<<(n_rows + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)aq, (int32_t*)tables, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_staged_launch(
    const void* s_digits, const void* h_digits, const void* ry,
    const void* r_sign, const void* idx, const void* tables, const void* comb,
    void* out, int n, int n_rows, void* stream) {
  const int threads = 128;
  k_ed25519_verify_staged<<<(n + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)s_digits, (const int32_t*)h_digits, (const int32_t*)ry,
      (const int32_t*)r_sign, (const int32_t*)idx, (const int32_t*)tables,
      (const int32_t*)comb, (bool*)out, n, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int field_chain_launch(const void* x, void* out, int n, int k,
                                  void* stream) {
  const int threads = 128;
  k_field_chain<<<(n + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n,
                                          k);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
