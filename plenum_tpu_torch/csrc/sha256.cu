// Batched SHA-256 for the Merkle ledger: kernels K1, K2 and K7.
//
// Replaces (JAX package, jitted jax.numpy programs):
//   K1 sha256_words     <- plenum_tpu/ops/sha256.py:87  sha256_words
//   K2 merkle_wave      <- plenum_tpu/ops/sha256.py:142 merkle_wave: every
//                          level of a wave of up to 1,024 leaves in one
//                          launch of one block (k_merkle_wave); a wider
//                          wave, up to 2^20 leaves, in one launch of
//                          aligned tiles (k_merkle_wave_tiled)
//      interior hash    <- :123 hash_interior (k_sha256_interior: the
//                          pairs of two tensors, or a level's shifted
//                          pairing, in one launch)
//   K7 merkle_reduce    <- plenum_tpu/ops/sha256.py:129 merkle_reduce_pow2
//                          (every level of a 512-leaf subtree in one block)
//
// Bound on an H100: 32-bit integer issue. After the compiler's fusing
// (LOP3 for each whole boolean function, one funnel shift per rotate,
// IADD3 for the add chains) a 64-byte block is ~1,400 instructions, most
// on the ALU pipe, against 32 bytes of digest out and 64 bytes of words
// in: far more work per byte than the card's memory rate asks for, so the
// arithmetic, not the memory, is the floor. chip_smoke.py counts the
// instructions per pipe from this library's SASS for the bound it prints.
// At the ledger's sizes no kernel comes near it: a 1,000-txn batch fills
// a few SMs, so what bounds them in practice is each message's chain of
// 64 dependent rounds per block.
//
// K1 runs a group of kGroup lanes per message, in three steps per turn of
// up to kGroup blocks: the group copies the turn's words into shared
// memory in 16-byte chunks (lane l takes chunks l, l + kGroup, ...: one
// coalesced load per message instead of one strided load per block);
// lane b expands block b's whole schedule and stores W[t] + K[t] in shared
// memory (the schedule depends on the words only, never on the state);
// lane 0 then runs the rounds of every block of the turn, each round one
// shared-memory load besides the state update. The round chain loses the
// schedule's two sigmas and three adds, and a batch of N messages runs
// N kGroup / 32 warps instead of N / 32.
//
// The interior hash (k_sha256_interior) runs each parent on a group of
// kInteriorGroup = 4 lanes in three steps: the lanes copy the pair's 64
// bytes into shared memory (16 bytes each, one coalesced load per
// parent); lanes 0 and 1 expand the schedules of the message's two
// blocks side by side, W[t] + K[t] into shared memory; lane 0 runs both
// blocks' 128 rounds, each round one shared-memory load besides the
// state update. (The second block is the right child's last byte, 0x80,
// zeros and the length, so its schedule could be one of 256 rows of a
// table; on the H100 reading that row in the rounds was slower than lane
// 1's expansion, which costs the chain nothing: PERF.md.) One kernel serves hash_interior's two tensors (left, right, stride 1)
// and a level's pairing (cur, cur + 1 row, stride 2, a bound and a 0/1
// offset read on the device), with no copy before it.
//
// K2's wave and K7 keep a subtree's levels in one block: level 0 reads
// its children from device memory, every later level ping-pongs between
// two buffers of parents in shared memory, a barrier between levels
// (__syncthreads() while a level spans warps, __syncwarp() once it fits
// warp 0). k_merkle_wave (kWaveThreads threads) takes a wave whose widest
// level has at most kWaveThreads parents: a 1,024-leaf wave, the ledger's
// 1,000-txn batch, is one launch with no trip through device memory
// between levels; each level's parents are also stored to one flat
// output at that level's row offset. The wave's pairing is
// merkle_parent_one's: level l's boundary node and 0/1 offset flag are
// read on the device, and since the whole level lives in one block,
// thread 0 pairs the boundary with the level's first node. K7 (256
// threads) reduces each 512-leaf block of a power-of-two subtree to its
// root, and launches again over the block roots when N > 512.
//
// A wave wider than one block is still one launch (k_merkle_wave_tiled,
// kWaveThreads threads, 2^11 ... 2^20 leaves): each block hashes an
// aligned tile of kTileLevels levels in shared memory (tile_parents) and
// stores its nodes, then arrives at a counter in device memory
// (last_to_arrive); the last block to arrive reads the other tiles' top
// nodes through L2 and hashes the levels above them as k_merkle_wave's
// body. No block waits for another, so the grid may exceed the blocks the
// card holds at once. The counter is an int32 the wrapper allocates
// zeroed once per device and stream; the last block sets it back to 0.
//
// Plain C interface (bound with ctypes): each launcher returns
// cudaGetLastError() right after its launch.
//
// The per-item functions and the level loop are device functions under
// nvcc and plain inline functions otherwise, so the same code also
// compiles as host C++ for a differential check without a GPU; the level
// loop's barriers are a parameter (BlockSync on the card, HostBlock, one
// std::barrier over the block's host threads, on the host).
#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define SHA_CONST __constant__
#else
#define HD inline
#define SHA_CONST static const
#endif

SHA_CONST uint32_t SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

HD uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

HD void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// One round on the working variables v = (a, ..., h); kw = K[t] + W[t].
HD void sha256_round(uint32_t v[8], uint32_t kw) {
  uint32_t e = v[4], a = v[0];
  uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
  uint32_t ch = (e & v[5]) ^ (~e & v[6]);
  uint32_t t1 = v[7] + S1 + ch + kw;
  uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
  uint32_t maj = (a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]);
  v[7] = v[6]; v[6] = v[5]; v[5] = e; v[4] = v[3] + t1;
  v[3] = v[2]; v[2] = v[1]; v[1] = a; v[0] = t1 + S0 + maj;
}

// Schedule word t >= 16 from the 16-word ring w, which it updates.
HD uint32_t sha256_next_word(uint32_t w[16], int t) {
  uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
  uint32_t s0 = rotr32(x15, 7) ^ rotr32(x15, 18) ^ (x15 >> 3);
  uint32_t s1 = rotr32(x2, 17) ^ rotr32(x2, 19) ^ (x2 >> 10);
  uint32_t wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
  w[t & 15] = wt;
  return wt;
}

// One compression, the schedule run beside the rounds; w holds 16
// big-endian words and is used as the schedule ring (overwritten).
HD void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t)
    sha256_round(v, SHA_K[t] + (t < 16 ? w[t] : sha256_next_word(w, t)));
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// K1's expansion: block blk's 64 schedule words, stored as W[t] + K[t] at
// wk[t * stride].
HD void sha256_schedule(const uint32_t* blk, uint32_t* wk, int stride) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = blk[i];
#pragma unroll
  for (int t = 0; t < 64; ++t)
    wk[t * stride] = SHA_K[t] + (t < 16 ? w[t] : sha256_next_word(w, t));
}

// K1's rounds: one compression from an expanded schedule (W[t] + K[t] at
// wk[t * stride]). The same integers as sha256_compress.
HD void sha256_rounds(uint32_t st[8], const uint32_t* wk, int stride) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
#pragma unroll
  for (int t = 0; t < 64; ++t) sha256_round(v, wk[t * stride]);
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// Block `half` (0 or 1) of the RFC 6962 interior message 0x01 || l || r
// (65 bytes, padded to 2 blocks): the 1-byte prefix shifts every word by
// 8 bits.
HD void interior_block(const uint32_t* l, const uint32_t* r, int half,
                       uint32_t w[16]) {
  if (half == 0) {
    w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = (l[i - 1] << 24) | (l[i] >> 8);
    w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
    for (int i = 9; i < 16; ++i) w[i] = (r[i - 9] << 24) | (r[i - 8] >> 8);
  } else {
    w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
    for (int i = 1; i < 15; ++i) w[i] = 0;
    w[15] = 65 * 8;
  }
}

// RFC 6962 interior node: SHA256(0x01 || l || r), 65 bytes = 2 blocks.
HD void sha256_interior_one(const uint32_t* l, const uint32_t* r,
                            uint32_t* out) {
  uint32_t st[8], w[16];
  sha256_init(st);
  interior_block(l, r, 0, w);
  sha256_compress(st, w);
  interior_block(l, r, 1, w);
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}

// One parent of a merkle_wave level. The level's pairing runs over
// shifted[k] = (k - off < 0) ? bound : cur[k - off], off in {0, 1}.
HD void merkle_parent_one(const uint32_t* cur, const uint32_t* bound, int off,
                          int j, uint32_t* out) {
  int kl = 2 * j - off, kr = 2 * j + 1 - off;
  const uint32_t* left = kl < 0 ? bound : cur + 8 * kl;
  sha256_interior_one(left, cur + 8 * kr, out);
}

// The interior hash on a group of lanes (k_sha256_interior). `lr` holds
// the pair's 16 words, l then r. Block `half` of its message, expanded
// off the round chain: W[t] + K[t] at wk[t].
HD void interior_schedule(const uint32_t* lr, int half, uint32_t* wk) {
  uint32_t w[16];
  interior_block(lr, lr + 8, half, w);
  sha256_schedule(w, wk, 1);
}

// The rounds of both blocks from their expanded schedules -> the parent.
HD void interior_rounds(const uint32_t* wk1, const uint32_t* wk2,
                        uint32_t st[8]) {
  sha256_init(st);
  sha256_rounds(st, wk1, 1);
  sha256_rounds(st, wk2, 1);
}

// A node that another block of this launch stored, read through L2
// (ld.global.cg on the card, 16 bytes at a time: node rows are 32-byte
// aligned): never a stale L1 line.
HD void load_node_l2(const uint32_t* src, uint32_t dst[8]) {
#ifdef __CUDA_ARCH__
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = __ldcg(s), b = __ldcg(s + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
#else
  for (int i = 0; i < 8; ++i) dst[i] = src[i];
#endif
}

// The levels of a subtree in one block of kT threads, thread t's share.
// Level 0 pairs `width` children (a power of two, at most 2 kT) from
// `in`; level l > 0 pairs the previous level's parents from buf, which
// holds two buffers of kT digests (rows [0, kT) and [kT, 2 kT)). Level l
// uses bound bounds + 8 l and offset offs[l] & 1 where they are given,
// else offset 0 (K7). Where `out` is given, level l's width / 2^(l+1)
// parents are also stored there at row width - width / 2^l. Returns the
// buffer (0 or 1) that holds the last level's parent. `sync` is the
// block's barrier: block() for all kT threads, warp() for warp 0's.
// kL2: `in` holds nodes other blocks of this launch stored (the top of
// the tiled wave), so level 0 reads them through load_node_l2.
template <int kT, bool kL2 = false, class Sync>
HD int subtree_levels(const Sync& sync, int t, const uint32_t* in, int width,
                      const uint32_t* bounds, const int32_t* offs,
                      uint32_t* out, uint32_t (*buf)[8]) {
  const uint32_t* cur = in;
  int dst = 0;
  for (int w = width, level = 0; w > 1; w >>= 1, ++level) {
    if (level > 0) {           // w: the parents the previous level wrote
      if (w > 32) sync.block();
      else sync.warp();
      cur = buf[dst * kT];
      dst ^= 1;
    }
    if (t < w / 2) {
      uint32_t p[8];
      if (kL2 && level == 0) {
        int kl = 2 * t - (offs ? offs[0] & 1 : 0);
        uint32_t c[16];       // the bound: an input, at any alignment
        if (kl < 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) c[i] = bounds[i];
        } else {
          load_node_l2(cur + 8 * kl, c);
        }
        load_node_l2(cur + 8 * (kl + 1), c + 8);
        sha256_interior_one(c, c + 8, p);
      } else {
        merkle_parent_one(cur, bounds ? bounds + 8 * level : nullptr,
                          offs ? offs[level] & 1 : 0, t, p);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) buf[dst * kT + t][i] = p[i];
      if (out) {
#pragma unroll
        for (int i = 0; i < 8; ++i) out[8 * (width - w + t) + i] = p[i];
      }
    }
  }
  return dst;
}

// The tiles of a wide wave (k_merkle_wave_tiled). With the virtual base
// B = sum_l (offs[l] & 1) 2^l, level l's input node i is absolute node
// (B >> l) + i of its level; level l's parents are absolute
// [B >> (l+1), (B >> (l+1)) + n / 2^(l+1)) of level l + 1; parent a hashes
// absolute children 2a and 2a + 1, and a child at absolute (B >> l) - 1
// is level l's bound (only where offs[l] is 1; no child lies further
// left). Block q's parents at level l, with s = kT >> l parent slots, are
// [q s, (q + 1) s) intersected with that window: [*lo, *hi). Blocks
// q = (B >> T) ... (B >> T) + n / 2^T (T = log2(2 kT) levels, n / 2^T + 1
// blocks, the first and last partial) hash every parent of levels
// 0 ... T - 1 once, and every child a block reads is its own node or the
// bound. Mirrored by plenum_tpu_torch/ops/sha256.py tile_parents, which
// the CPU tests hold to these rules.
HD void tile_parents(int n, int base, int q, int level, int s, int* lo,
                     int* hi) {
  int f = base >> (level + 1);
  *lo = q * s > f ? q * s : f;
  *hi = (q + 1) * s < f + (n >> (level + 1)) ? (q + 1) * s
                                             : f + (n >> (level + 1));
}

// Block q's tile of a wide wave, thread t's share: levels 0 ... T - 1
// (kT parent slots at level 0, one at level T - 1). Slot j of level l is
// absolute parent q s + j, so children pair as local slots (2j, 2j + 1)
// of the previous level's buffer in buf (level 0: rows 2a - B and
// 2a + 1 - B of `in`), except the bound. Each parent is also stored at its row of the flat
// output (level l's parents from row n - n / 2^l on).
template <int kT, class Sync>
HD void tile_levels(const Sync& sync, int t, int q, int base,
                    const uint32_t* in, int n, const uint32_t* bounds,
                    uint32_t* out, uint32_t (*buf)[8]) {
  for (int s = kT, level = 0; s >= 1; s >>= 1, ++level) {
    if (level > 0) {           // 2 s: the slots the previous level wrote
      if (2 * s > 32) sync.block();
      else sync.warp();
    }
    int lo, hi, a = q * s + t;
    tile_parents(n, base, q, level, s, &lo, &hi);
    if (t < s && a >= lo && a < hi) {
      // children 2a (local slot 2t) and 2a + 1; the bound, 2 (B >> (l+1)),
      // is even, so only the left child can be it
      const uint32_t* kids = level == 0 ? in + 8 * (2 * a - base)
                                        : buf[((level - 1) & 1) * kT + 2 * t];
      uint32_t p[8];
      sha256_interior_one(
          2 * a == (base >> level) - 1 ? bounds + 8 * level : kids, kids + 8,
          p);
      uint32_t* o = out + 8 * ((n - (n >> level)) + a - (base >> (level + 1)));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        buf[(level & 1) * kT + t][i] = p[i];
        o[i] = p[i];
      }
    }
  }
}

#ifdef __CUDACC__

struct BlockSync {
  __device__ void block() const { __syncthreads(); }
  __device__ void warp() const { __syncwarp(); }
};

// K1: kGroup lanes per message, kWordsThreads / kGroup messages per block.
static constexpr int kWordsThreads = 128;
static constexpr int kGroup = 8;

struct WordsShared {
  // one turn's words of each message, 16-byte chunks
  uint4 words[kWordsThreads / kGroup][4 * kGroup];
  // W[t] + K[t] of block b of the turn at word t kGroup + b; kGroup words
  // of padding per message put the groups of one warp on other banks
  uint32_t wk[kWordsThreads / kGroup][64 * kGroup + kGroup];
};

__global__ void __launch_bounds__(kWordsThreads)
k_sha256_words(const uint32_t* __restrict__ msgs, uint32_t* __restrict__ out,
               int n, int nblocks) {
  __shared__ WordsShared sh;
  int lane = threadIdx.x % kGroup, slot = threadIdx.x / kGroup;
  int i = blockIdx.x * (kWordsThreads / kGroup) + slot;
  bool live = i < n;          // no early exit: the warp meets at __syncwarp
  const uint4* msg = reinterpret_cast<const uint4*>(msgs) + (size_t)i * 4 * nblocks;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(sh.words[slot]);
  uint32_t* wk = sh.wk[slot];
  uint32_t st[8];
  sha256_init(st);
  for (int b0 = 0; b0 < nblocks; b0 += kGroup) {
    int nb = min(kGroup, nblocks - b0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int c = lane + k * kGroup;
      if (live && c < 4 * nb) sh.words[slot][c] = msg[4 * b0 + c];
    }
    __syncwarp();
    if (live && lane < nb)
      sha256_schedule(words + 16 * lane, wk + lane, kGroup);
    __syncwarp();
    if (live && lane == 0)
      for (int b = 0; b < nb; ++b) sha256_rounds(st, wk + b, kGroup);
    __syncwarp();
  }
  if (live && lane == 0) {
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * (size_t)i;
    o[0] = make_uint4(st[0], st[1], st[2], st[3]);
    o[1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

// Never launched: the first, one-thread interior hash (k_merkle_level), kept
// under its own name so that chip_smoke.py counts the SHA-256 bounds of
// K2, K7 and the interior hash on the same work as before (its SASS per
// parent).
__global__ void k_interior_yardstick(const uint32_t* __restrict__ cur,
                                     const uint32_t* __restrict__ bound,
                                     const int32_t* __restrict__ off,
                                     uint32_t* __restrict__ out,
                                     int n_parents) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_parents) return;
  merkle_parent_one(cur, bound, off[0] & 1, j, out + (size_t)j * 8);
}

// The interior hash: kInteriorGroup lanes per parent, up to
// kInteriorThreads / kInteriorGroup parents per block. Parent j hashes
// rows (left, right) = (j stride - o, j stride - o) of `left` and `right`,
// o = off[0] & 1 (0 where off is null), the left row `bound` where it is
// negative: hash_interior's pairs are (left, right, stride 1), a level's
// (cur, cur + 1 row, stride 2). Per parent in shared memory: the pair's 16
// words, then W[t] + K[t] of block 1 and block 2; 148 words apart, so the
// eight parents of a warp read their schedules on eight banks.
static constexpr int kInteriorGroup = 4;
static constexpr int kInteriorThreads = 128;
static constexpr int kInteriorWords = 16 + 2 * 64 + 4;

__global__ void __launch_bounds__(kInteriorThreads)
k_sha256_interior(const uint32_t* __restrict__ left,
                  const uint32_t* __restrict__ right, int stride,
                  const uint32_t* __restrict__ bound,
                  const int32_t* __restrict__ off,
                  uint32_t* __restrict__ out, int n) {
  __shared__ uint4 sh[kInteriorThreads / kInteriorGroup][kInteriorWords / 4];
  int lane = threadIdx.x % kInteriorGroup, slot = threadIdx.x / kInteriorGroup;
  int j = blockIdx.x * (blockDim.x / kInteriorGroup) + slot;
  bool live = j < n;          // no early exit: the warp meets at __syncwarp
  uint32_t* s = reinterpret_cast<uint32_t*>(sh[slot]);
  if (live) {                 // lanes 0, 1: l's halves; 2, 3: r's
    long long row = (long long)j * stride - (off ? off[0] & 1 : 0);
    const uint32_t* src = lane >= 2 ? right + 8 * row
                          : row < 0 ? bound : left + 8 * row;
    sh[slot][lane] = reinterpret_cast<const uint4*>(src)[lane & 1];
  }
  __syncwarp();
  if (live && lane < 2) interior_schedule(s, lane, s + 16 + 64 * lane);
  __syncwarp();
  if (live && lane == 0) {
    uint32_t st[8];
    interior_rounds(s + 16, s + 80, st);
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * (size_t)j;
    o[0] = make_uint4(st[0], st[1], st[2], st[3]);
    o[1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

// K2's wave: every level of a wave of n <= 2 kWaveThreads children in one
// block, from level level0 of the wave on (bounds and offs are the wave's
// whole arrays); out points at level level0's rows of the flat output.
static constexpr int kWaveThreads = 512;

__global__ void __launch_bounds__(kWaveThreads)
k_merkle_wave(const uint32_t* __restrict__ cur,
              const uint32_t* __restrict__ bounds,
              const int32_t* __restrict__ offs, uint32_t* __restrict__ out,
              int n, int level0) {
  __shared__ uint32_t buf[2 * kWaveThreads][8];
  subtree_levels<kWaveThreads>(BlockSync{}, threadIdx.x, cur, n,
                               bounds + 8 * level0, offs + level0, out, buf);
}

// The arrival of one block of the tiled wave at `counter`; every
// thread calls it after its last store that another block reads, and
// every block of the grid calls it, one with no work too. True in every
// thread of the last of `blocks` blocks to arrive, which then reads the
// other blocks' stores through L2 (subtree_levels<kT, true>). After the
// barrier, thread 0's fence orders the whole block's stores before its
// arrival (fences are cumulative), as in a cooperative grid sync. The
// last block also sets the counter back to 0 for the next launch on the
// stream: every block has arrived by then.
__device__ bool last_to_arrive(int* counter, int blocks) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();          // the block's stores, before the arrival
    last = atomicAdd(counter, 1) == blocks - 1;
    if (last) {
      __threadfence();        // the others' stores, before the reads
      *counter = 0;
    }
  }
  __syncthreads();
  return last;
}

// A wave of n = 2^11 ... 2^20 children (2 kWaveThreads << kTileLevels) in
// one launch, from level level0 of the wave on (bounds and offs are the
// wave's whole arrays; out points at level level0's rows of the flat
// output): n / 2^kTileLevels + 1 blocks, block b hashing tile
// (B >> kTileLevels) + b (tile_levels), then the last block to arrive
// hashes levels kTileLevels ... log2 n - 1 from the n / 2^kTileLevels
// nodes of level kTileLevels - 1: k_merkle_wave's body at that level.
static constexpr int kTileLevels = 10;       // log2(2 kWaveThreads)

// (kWaveThreads, 1): with the thread count alone, ptxas held it to 64
// registers and spilled.
__global__ void __launch_bounds__(kWaveThreads, 1)
k_merkle_wave_tiled(const uint32_t* __restrict__ cur,
                    const uint32_t* __restrict__ bounds,
                    const int32_t* __restrict__ offs, uint32_t* out, int n,
                    int level0, int* counter) {
  __shared__ uint32_t buf[2 * kWaveThreads][8];
  __shared__ int base_sh;
  int t = threadIdx.x;
  bounds += 8 * level0;
  offs += level0;
  if (t < 32) {                // the virtual base B from the 0/1 offsets
    int depth = 31 - __clz(n);
    unsigned bit = t < depth ? (unsigned)(offs[t] & 1) << t : 0u;
    bit = __reduce_or_sync(0xffffffffu, bit);
    if (t == 0) base_sh = (int)bit;
  }
  __syncthreads();
  int base = base_sh;
  tile_levels<kWaveThreads>(BlockSync{}, t, (base >> kTileLevels) + blockIdx.x,
                            base, cur, n, bounds, out, buf);
  if (!last_to_arrive(counter, gridDim.x)) return;
  subtree_levels<kWaveThreads, true>(
      BlockSync{}, t, out + 8 * (n - (n >> (kTileLevels - 1))),
      n >> kTileLevels, bounds + 8 * kTileLevels, offs + kTileLevels,
      out + 8 * (n - (n >> kTileLevels)), buf);
}

// K7: block b reduces leaves [512 b, 512 b + w), w = min(n, 512), to
// out[b]. n is a power of two, so w is too.
static constexpr int kReduceThreads = 256;
static constexpr int kReduceLeaves = 2 * kReduceThreads;

__global__ void __launch_bounds__(kReduceThreads)
k_merkle_reduce(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int n) {
  __shared__ uint32_t buf[2 * kReduceThreads][8];
  int t = threadIdx.x;
  int width = min(n - (int)blockIdx.x * kReduceLeaves, kReduceLeaves);
  int src = subtree_levels<kReduceThreads>(
      BlockSync{}, t, in + (size_t)blockIdx.x * kReduceLeaves * 8, width,
      nullptr, nullptr, nullptr, buf);
  __syncwarp();               // the root's writer, thread 0, is in warp 0
  if (t < 8) out[(size_t)blockIdx.x * 8 + t] = buf[src * kReduceThreads][t];
}

extern "C" int sha256_words_launch(const void* msgs, void* out, int n,
                                   int nblocks, void* stream) {
  constexpr int per_block = kWordsThreads / kGroup;
  k_sha256_words<<<(n + per_block - 1) / per_block, kWordsThreads, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)msgs, (uint32_t*)out, n, nblocks);
  return (int)cudaGetLastError();
}

// threads: a multiple of kInteriorGroup up to kInteriorThreads per block
// (anything else is refused). Every row read is 16-byte aligned.
extern "C" int sha256_interior_launch(const void* left, const void* right,
                                      int stride, const void* bound,
                                      const void* off, void* out, int n,
                                      int threads, void* stream) {
  if (threads < kInteriorGroup || threads > kInteriorThreads ||
      threads % kInteriorGroup)
    return (int)cudaErrorInvalidValue;
  int blocks = (int)(((long long)n * kInteriorGroup + threads - 1) / threads);
  k_sha256_interior<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)left, (const uint32_t*)right, stride,
      (const uint32_t*)bound, (const int32_t*)off, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// n: the wave's width from level level0 on, a power of two in
// [2, 2 kWaveThreads]; anything else is refused.
extern "C" int merkle_wave_launch(const void* cur, const void* bounds,
                                  const void* offs, void* out, int n,
                                  int level0, void* stream) {
  if (n < 2 || n > 2 * kWaveThreads || (n & (n - 1)) || level0 < 0)
    return (int)cudaErrorInvalidValue;
  k_merkle_wave<<<1, kWaveThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cur, (const uint32_t*)bounds, (const int32_t*)offs,
      (uint32_t*)out, n, level0);
  return (int)cudaGetLastError();
}

// n: the wave's width from level level0 on, a power of two in
// (2 kWaveThreads, 2 kWaveThreads << kTileLevels]; anything else is
// refused. counter: the stream's arrival counter, 0 between launches.
extern "C" int merkle_wave_tiled_launch(const void* cur, const void* bounds,
                                        const void* offs, void* out, int n,
                                        int level0, void* counter,
                                        void* stream) {
  if (n <= 2 * kWaveThreads || n > (2 * kWaveThreads << kTileLevels) ||
      (n & (n - 1)) || level0 < 0)
    return (int)cudaErrorInvalidValue;
  k_merkle_wave_tiled<<<(n >> kTileLevels) + 1, kWaveThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)cur, (const uint32_t*)bounds, (const int32_t*)offs,
      (uint32_t*)out, n, level0, (int*)counter);
  return (int)cudaGetLastError();
}

extern "C" int merkle_reduce_launch(const void* in, void* out, int n,
                                    void* stream) {
  int blocks = (n + kReduceLeaves - 1) / kReduceLeaves;
  k_merkle_reduce<<<blocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

#else
#include <barrier>
// The level loop's barrier on the host: one std::barrier over all of the
// block's host threads stands in for both __syncthreads() and __syncwarp().
struct HostBlock {
  std::barrier<>* all;
  void block() const { all->arrive_and_wait(); }
  void warp() const { all->arrive_and_wait(); }
};
#endif  // __CUDACC__
