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
// Design: K3-K6 run each key or signature on a quad, four adjacent lanes
// of a warp (fe25519.cuh, "quad point formulas"); K8 each column on a
// quad too (fe_sq_lanes below: the lanes split a squaring's products and
// exchange their sums, every lane carrying all ten), or on one thread. Lane c of a quad holds coordinate c (X, Y, Z, T) of the running
// point. Every point formula is two stages of four independent field
// operations: in stage 1 each lane runs one, the quad all-gathers the four
// results by shuffles, and in stage 2 lane c runs the product that becomes
// coordinate c; ge_add's dependent 2d multiply is a stage of its own on
// lane 3. Each lane runs exactly the field operations of the serial
// formulas on the same inputs, so the tables and verdicts are limb for limb
// the plain versions'. The square root (K3) and the final inversion,
// canonicalisation and R compare (K4, K6) run in lock-step on all four
// lanes; lane 0 stores the verdict. What the TPU program did with one-hot
// matmuls on its matrix unit (selecting window-table and comb entries by
// digit) is a plain indexed load here: the per-key tables (10 KB each,
// written by K3 or K5, each lane storing its coordinate) and the
// fixed-base comb table (32 x 256 niels points, 960 KB, resident in device
// memory) are gathered by digit straight from L2, each lane loading only
// the coordinates it multiplies. Field elements use ref10's 10-limb
// radix-2^25.5 layout with 64-bit products (fe25519.cuh) in place of the
// TPU's 20x13-bit int32 limbs; K5, K6 and K8 take the reference's 13-bit
// limbs as they are staged and convert them in registers (fe_from_limbs13,
// signs kept). K4 and K6 share one ladder (verify_one), templated on how a
// signature's digits are read and how R is compared; K3 and K5 share the
// table build (build_quarter_table). The verdict semantics are the
// reference's exactly: cofactorless, R compared as bytes (so a
// non-canonical R fails), keys rejected for y >= p, off-curve, or x = 0
// with the sign bit set; an invalid key forces its signatures' verdicts to
// false.
//
// What bounds it now: a batch of 1,000 items is 4,000 threads in 125
// warps, fewer than the card's 528 warp schedulers, so each warp issues
// its quad's chain alone on its scheduler and every latency shows; per
// lane a signature is ~44,000 wide multiplies instead of ~128,500, a key
// ~60,000 instead of ~184,000. The lock-step chains do not shrink: the
// inversion (~15,000 per lane, a third of K4's) and the square root
// (~15,900 of K3's). The table build's 2d multiplies ride in its
// additions' 2d stage, which would otherwise leave three lanes idle.
// Left for later: two or more lanes per field multiply (a product's
// columns split over the quad, then over more lanes), so that more than
// 125 warps are in flight and the lock-step chains shrink too. K8 tried
// it on the squaring: the split shortens each lane's products, but every
// lane still runs the whole carry and the exchanges add their latency,
// so a column's chain shrinks by about a tenth (PERF.md). The quads here
// shuffle under each quad's own mask, which the compiler turns into a
// loop over the warp's quads around every shuffle (see WarpLanes).
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

// The window table of one quarter point q, this lane holding coordinate
// `q` of it: tab[0] = the identity, tab[1] = q, tab[2j] = dbl(tab[j]),
// tab[2j+1] = tab[2j] + q, each entry stored as (X, Y, Z, 2d*T). Lanes
// 0-2 store X, Y, Z. The 2d*T multiplies ride in each addition's 2d
// stage, which would leave lanes 0-2 idle: lane 0 takes the doubling's
// T, lane 1 the previous addition's (q's at first); the last one runs
// after the loop. A doubling reads back X, Y and Z only.
template <class Q>
ED_HD void build_quarter_table(const Q& qd, const fe& q, int32_t* tab) {
  int lane = qd.lane;
  fe other = qd.shfl_xor(q, 1);
  // q's stage-1 operand of ge_add: Y - X, Y + X, Z, T
  fe rhs = quad_yx(lane, fe_select(lane == 0, other, q),
                   fe_select(lane == 0, q, other), q);
  // the identity (0, 1, 1, 0): its 2d*T, fe_mul(0, 2d), is 0
  fe_store(tab + 10 * lane, fe_select(lane == 1 || lane == 2, fe_one(),
                                      fe_zero()));
  if (lane < 3) fe_store(tab + kEntryStride + 10 * lane, q);
  fe pending = qd.shfl(q, 3);  // T of the last entry not yet stored
  for (int j = 1; j < 8; ++j) {
    fe src = j == 1 || lane == 3 ? q
                                 : fe_load(tab + j * kEntryStride + 10 * lane);
    fe dbl = quad_double(qd, src);
    int32_t* even = tab + 2 * j * kEntryStride;
    if (lane < 3) fe_store(even + 10 * lane, dbl);
    fe t_dbl = qd.shfl(dbl, 3);  // every lane takes part in a shuffle
    fe side = lane == 0 ? t_dbl : pending;
    fe sum = quad_add(qd, dbl, rhs, kQuadAdd, &side);
    if (lane == 0) fe_store(even + 30, side);
    if (lane == 1) fe_store(even - kEntryStride + 30, side);
    if (lane < 3) fe_store(even + kEntryStride + 10 * lane, sum);
    pending = qd.shfl(sum, 3);
  }
  if (lane == 3) fe_store(tab + 15 * kEntryStride + 30, fe_mul(pending, fe_d2()));
}

// K5, one key row on a quad: the reference's staged quarter points
// int32 [4][4 coords][20] of 13-bit limbs (ext_quarters, carried or
// canonical); lane c converts coordinate c of each.
template <class Q>
ED_HD void quarter_tables_one(const Q& qd, const int32_t* rows,
                              int32_t* tables) {
  for (int k = 0; k < 4; ++k)
    build_quarter_table(qd, fe_from_limbs13(rows + k * 4 * 20 + 20 * qd.lane, 1),
                        tables + k * kTableStride);
}

// K3, one key on a quad: RFC 8032 §5.1.3 decompression of A (the square
// root in lock-step on all four lanes), then -A's quarter points
// [2^(64k)](-A) by quad doublings, each followed by its window table.
template <class Q>
ED_HD void decompress_one(const Q& qd, const uint8_t* key, int32_t* quarters,
                          int32_t* tables, bool* valid) {
  int lane = qd.lane;
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
  if (lane == 0) *valid = (ok1 || ok2) && !noncanon && !(x_zero && sign == 1);

  fe pt = lane == 0 ? negx : lane == 1 ? y : lane == 2 ? one : fe_mul(negx, y);
  for (int k = 0; k < 4; ++k) {
    if (k > 0)
      for (int i = 0; i < 64; ++i) pt = quad_double(qd, pt);
    fe_store(quarters + k * kQuarterStride + 10 * lane, pt);
    build_quarter_table(qd, pt, tables + k * kTableStride);
  }
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

// K4 and K6, one signature on a quad: compress([S]B + [h](-A)) == R, A's
// tables given; `sig` supplies the digits (every lane reads the same) and
// the compare. Each lane loads only the coordinates of a table or comb
// entry that it multiplies. The inversion, the canonicalisation and the
// compare run in lock-step on all four lanes.
template <class Q, class Sig>
ED_HD bool verify_one(const Q& qd, const Sig& sig, const int32_t* key_tables,
                      const int32_t* comb) {
  int lane = qd.lane;
  fe acc = fe_select(lane == 1 || lane == 2, fe_one(), fe_zero());
  for (int t = 15; t >= 0; --t) {      // MSB-first 4-bit windows
    for (int i = 0; i < 4; ++i) acc = quad_double(qd, acc);
    for (int q = 0; q < 4; ++q) {
      const int32_t* e =
          key_tables + q * kTableStride + sig.h_digit(q, t) * kEntryStride;
      fe a = fe_load(e + 10 * (lane < 2 ? 1 : lane));  // Y2, Y2, Z2, 2dT2
      fe b = lane < 2 ? fe_load(e) : a;                 // X2
      acc = quad_add(qd, acc, quad_yx(lane, a, b, a), kQuadAddT2d);
    }
  }
  for (int w = 0; w < 32; ++w) {       // fixed-base comb, 8-bit digits of S
    // niels (y+x, y-x, 2dxy): lane 0 takes y-x, lane 1 y+x, lane 3 2dxy
    const int32_t* e = comb + ((size_t)w * 256 + sig.s_digit(w)) * 30;
    fe rhs = lane == 2 ? fe_zero()
                       : fe_load(e + (lane == 0 ? 10 : lane == 3 ? 20 : 0));
    acc = quad_add(qd, acc, rhs, kQuadMadd);
  }
  fe px = qd.shfl(acc, 0), py = qd.shfl(acc, 1), pz = qd.shfl(acc, 2);
  fe zinv = fe_inv(pz);
  fe x = fe_canon(fe_mul(px, zinv));
  fe y = fe_canon(fe_mul(py, zinv));
  return sig.matches(x, y);
}

// K8, one column: x^(2^k) by k squarings, from and back to 13-bit limbs
// (canonical on the way out).
ED_HD void field_chain_one(const int32_t* x, int32_t* out, int stride, int k) {
  fe z = fe_pow2k(fe_from_limbs13(x, stride), k);
  fe_to_limbs13_canon(fe_canon(z), out, stride);
}

// --- K8 on a quad of lanes per column --------------------------------------
// Every lane holds the whole carried value f. A squaring's ten column sums
// t[k] (fe_sq's 55 products) are split so that every lane runs the same
// instructions on its own operands, with no branch on the lane:
//
// Lane parity p computes the coefficients k = 2m + p (slot m = 0..4). Even
// coefficient 2m is six of fe_sq's products f_i f_j (i <= j, i + j = 2m
// or 2m + 10); odd coefficient 2m + 1 is exactly the products f_i f_(j+1)
// of the same (i, j), but for (2m + 1, 9), whose j + 1 = 10 is a zero
// product on the odd lane. So the odd lane runs the even lane's steps on
// g[x] = f_(x+1) (g[9] = 0) where the even lane has g[x] = f_x. The factors
// follow: the 19 of a wrap (i + j >= 10) is the same on both lanes (i + j
// is even); the 2 of an odd pair (i, j both odd) only on the even lane
// (a[i] = 2 f_i there for odd i); the 2 of a symmetric pair on both,
// except on (i, i), a single product on the even lane but the pair
// (i, i + 1) on the odd one (a[i] (1 + p)). A step multiplies the same
// sizes as fe_sq's (a at most 4 f, b at most 19 f), so every sum is the
// same integer as fe_sq's and stays below 2^61.
//
// Lane h = lane >> 1 takes steps 3h ... 3h + 2 of each slot (their
// operands selected on h) and the halves add their sums by one shuffle.
// The parities then swap their five sums by one more, and every lane
// carries all ten (fe_from64) itself: the limbs are fe_sq's on every
// lane, and the next squaring needs no further exchange.
//
// The exchange is an object `X` with `lane` and `xor64(v, m)` (v of lane
// lane ^ m): WarpLanes on the card, HostLanes (host threads meeting at a
// barrier) when the file is compiled as host C++.
constexpr int kChainGroup = 4;

template <class X>
ED_HD fe fe_sq_lanes(const X& xc, const fe& f) {
  const int p = xc.lane & 1, h = xc.lane >> 1;
  int32_t a[10], a2[10], ad[10], g[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    a[i] = (i & 1) ? f.v[i] * (2 - p) : f.v[i];
    a2[i] = 2 * a[i];            // a symmetric pair's 2
    ad[i] = a[i] * (1 + p);      // step (i, i): 1 on the even lane, 2 odd
    g[i] = p ? (i < 9 ? f.v[i + 1] : 0) : f.v[i];
    g19[i] = 19 * g[i];
  }
  int64_t t[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    t[m] = 0;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      int32_t av[2], bv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {        // step s of slot m, half c's
        const int s = 3 * c + u;
        const bool low = s <= m;           // i + j = 2m, else 2m + 10
        const int i = low ? s : m + s;
        const int j = (low ? 2 * m : 2 * m + 10) - i;
        av[c] = i == j ? ad[i] : a2[i];
        bv[c] = low ? g[j] : g19[j];
      }
      t[m] += (int64_t)(h ? av[1] : av[0]) * (h ? bv[1] : bv[0]);
    }
  }
  int64_t full[10];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    t[m] += xc.xor64(t[m], 2);
    const int64_t o = xc.xor64(t[m], 1);
    full[2 * m] = p ? o : t[m];
    full[2 * m + 1] = p ? t[m] : o;
  }
  return fe_from64(full);
}

// One column on a quad: every lane loads and converts the column, runs
// the k squarings, and stores its share of the 20 limbs (limb i on lane
// i mod 4; nothing where out is null).
template <class X>
ED_HD void field_chain_lanes(const X& xc, const int32_t* x, int32_t* out,
                             int stride, int k) {
  fe z = fe_from_limbs13(x, stride);
  for (int i = 0; i < k; ++i) z = fe_sq_lanes(xc, z);
  fe c = fe_canon(z);
  int32_t l[20];
  fe_to_limbs13_canon(c, l, 1);
#pragma unroll
  for (int i = 0; i < 20; ++i)
    if (out && i % kChainGroup == xc.lane) out[(size_t)i * stride] = l[i];
}

#ifdef __CUDACC__

// K3-K6 run one item per quad: thread t of the grid is lane t & 3 of item
// t >> 2 (blocks hold a multiple of 4 threads, so a quad never straddles
// two blocks or warps). A tail quad past the last item leaves as a whole
// before its first shuffle, and every shuffle names only its own quad's
// lanes, so nothing waits on it; likewise a signature whose key index is
// outside the table is settled by its whole quad at once.
__device__ __forceinline__ int quad_item() {
  return (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 2);
}

__global__ void __launch_bounds__(128)
k_ed25519_decompress(const uint8_t* __restrict__ keys,
                     int32_t* __restrict__ quarters,
                     int32_t* __restrict__ tables,
                     bool* __restrict__ valid, int n_keys) {
  int u = quad_item();
  if (u >= n_keys) return;
  decompress_one(warp_quad(), keys + (size_t)u * 32,
                 quarters + (size_t)u * 4 * kQuarterStride,
                 tables + (size_t)u * kKeyTableStride, valid + u);
}

__global__ void __launch_bounds__(128)
k_ed25519_verify(const uint8_t* __restrict__ s, const uint8_t* __restrict__ h,
                 const uint8_t* __restrict__ r, const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ tables,
                 const bool* __restrict__ valid,
                 const int32_t* __restrict__ comb, bool* __restrict__ out,
                 int n, int n_keys) {
  int i = quad_item();
  if (i >= n) return;
  WarpQuad qd = warp_quad();
  int u = idx[i];
  if (u < 0 || u >= n_keys) {
    if (qd.lane == 0) out[i] = false;
    return;
  }
  BytesSig sig{s + (size_t)i * 32, h + (size_t)i * 32, r + (size_t)i * 32};
  bool ok = verify_one(qd, sig, tables + (size_t)u * kKeyTableStride, comb);
  if (qd.lane == 0) out[i] = ok && valid[u];
}

__global__ void __launch_bounds__(128)
k_ed25519_quarter_tables(const int32_t* __restrict__ aq,
                         int32_t* __restrict__ tables, int n_rows) {
  int u = quad_item();
  if (u >= n_rows) return;
  quarter_tables_one(warp_quad(), aq + (size_t)u * 4 * 4 * 20,
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
  int i = quad_item();
  if (i >= n) return;
  WarpQuad qd = warp_quad();
  int u = idx[i];
  if (u < 0 || u >= n_rows) {
    if (qd.lane == 0) out[i] = false;
    return;
  }
  StagedSig sig{s_digits, h_digits, ry + (size_t)i * 20, r_sign[i], n, i};
  bool ok = verify_one(qd, sig, tables + (size_t)u * kKeyTableStride, comb);
  if (qd.lane == 0) out[i] = ok;
}

// K8's exchange on the card: xor shuffles inside each quad (width 4)
// under the whole warp's mask. Every lane of the warp runs every shuffle
// (no lane leaves early), so each is one instruction: with each quad's
// own lanes as the mask, the compiler wraps every shuffle in a loop over
// the warp's distinct masks, one quad after another.
struct WarpLanes {
  int lane;
  __device__ int64_t xor64(int64_t v, int m) const {
    return __shfl_xor_sync(0xffffffffu, (long long)v, m, kChainGroup);
  }
};

// K8: column i on threads G i ... G i + G - 1 of the grid, G = 1 or
// kChainGroup. Blocks are whole warps; a quad past the last column runs
// the last column's chain and stores nothing.
template <int G>
__global__ void __launch_bounds__(128)
k_field_chain(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
              int k) {
  int i = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if constexpr (G == 1) {
    if (i >= n) return;
    field_chain_one(x + i, out + i, n, k);
  } else {
    bool live = i < n;
    if (!live) i = n - 1;
    WarpLanes xc{(int)(threadIdx.x % G)};
    field_chain_lanes(xc, x + i, live ? out + i : nullptr, n, k);
  }
}

// Blocks of `threads` threads (4 to 128, a multiple of 4), four per item.
static bool quad_blocks(int n_items, int threads, int* blocks) {
  if (threads < 4 || threads > 128 || threads % 4) return false;
  *blocks = (int)(((long long)n_items * 4 + threads - 1) / threads);
  return true;
}

extern "C" int ed25519_decompress_launch(const void* keys, void* quarters,
                                         void* tables, void* valid, int n_keys,
                                         int threads, void* stream) {
  int blocks;
  if (!quad_blocks(n_keys, threads, &blocks)) return (int)cudaErrorInvalidValue;
  k_ed25519_decompress<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keys, (int32_t*)quarters, (int32_t*)tables,
      (bool*)valid, n_keys);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_launch(const void* s, const void* h,
                                     const void* r, const void* idx,
                                     const void* tables, const void* valid,
                                     const void* comb, void* out, int n,
                                     int n_keys, int threads, void* stream) {
  int blocks;
  if (!quad_blocks(n, threads, &blocks)) return (int)cudaErrorInvalidValue;
  k_ed25519_verify<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s, (const uint8_t*)h, (const uint8_t*)r,
      (const int32_t*)idx, (const int32_t*)tables, (const bool*)valid,
      (const int32_t*)comb, (bool*)out, n, n_keys);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_quarter_tables_launch(const void* aq, void* tables,
                                             int n_rows, int threads,
                                             void* stream) {
  int blocks;
  if (!quad_blocks(n_rows, threads, &blocks)) return (int)cudaErrorInvalidValue;
  k_ed25519_quarter_tables<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)aq, (int32_t*)tables, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_staged_launch(
    const void* s_digits, const void* h_digits, const void* ry,
    const void* r_sign, const void* idx, const void* tables, const void* comb,
    void* out, int n, int n_rows, int threads, void* stream) {
  int blocks;
  if (!quad_blocks(n, threads, &blocks)) return (int)cudaErrorInvalidValue;
  k_ed25519_verify_staged<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s_digits, (const int32_t*)h_digits, (const int32_t*)ry,
      (const int32_t*)r_sign, (const int32_t*)idx, (const int32_t*)tables,
      (const int32_t*)comb, (bool*)out, n, n_rows);
  return (int)cudaGetLastError();
}

// per_item: 1 or 4 lanes per column; threads: 32, 64, 96 or 128 per
// block. Anything else is refused.
extern "C" int field_chain_launch(const void* x, void* out, int n, int k,
                                  int per_item, int threads, void* stream) {
  if ((per_item != 1 && per_item != kChainGroup) || threads < 32 ||
      threads > 128 || threads % 32)
    return (int)cudaErrorInvalidValue;
  int blocks = (int)(((long long)n * per_item + threads - 1) / threads);
  auto xs = (const int32_t*)x;
  auto os = (int32_t*)out;
  auto st = (cudaStream_t)stream;
  if (per_item == 1)
    k_field_chain<1><<<blocks, threads, 0, st>>>(xs, os, n, k);
  else
    k_field_chain<kChainGroup><<<blocks, threads, 0, st>>>(xs, os, n, k);
  return (int)cudaGetLastError();
}

#else
#include <barrier>
// K8's exchange on the host: four threads, one per lane, share `slots`;
// each publishes its value, all meet, each reads its partner's, all meet.
struct HostLanesSlots {
  int64_t v[4];
  std::barrier<>* meet;
};

struct HostLanes {
  int lane;
  HostLanesSlots* s;
  int64_t xor64(int64_t v, int m) const {
    s->v[lane] = v;
    s->meet->arrive_and_wait();
    int64_t r = s->v[lane ^ m];
    s->meet->arrive_and_wait();
    return r;
  }
};
#endif  // __CUDACC__
