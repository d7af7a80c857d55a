// Batched SHA-256 for the Merkle ledger: kernels K1, K2 and K7.
//
// Replaces (JAX package, jitted jax.numpy programs):
//   K1 sha256_words     <- plenum_tpu/ops/sha256.py:87  sha256_words
//   K2 merkle_level     <- plenum_tpu/ops/sha256.py:142 merkle_wave (one
//                          launch per level) and :123 hash_interior (one
//                          launch with the pairs interleaved, offset 0)
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
//
// Design: one thread per message (K1) or per parent (K2). The TPU program
// advanced the whole batch in lockstep across vector lanes with the
// schedule in a [N, 64] array; here each thread keeps the eight working
// variables and a 16-word schedule ring in registers, the 64 rounds fully
// unrolled so every round constant is an immediate from constant memory
// and every rotate a funnel shift. Threads are independent, so a batch of
// N needs no synchronisation at all. K2 packs 0x01 || left || right into
// its two blocks inside the thread (the 1-byte prefix shifts every word by
// 8 bits) and reads the level's boundary node and 0/1 offset flag from
// device memory, so the host launches every level of a wave back to back
// with no sync in between.
//
// K7 reduces a complete power-of-two subtree to its root. Its levels
// depend on each other, so across the grid they would need one launch
// each (K2's way); inside a block they need only a barrier. One block of
// 256 threads takes 512 leaves: level 0 reads the leaves from device
// memory, every later level ping-pongs between two 256-digest buffers in
// shared memory (16 KB) with __syncthreads() between levels, and thread 0
// writes the block's root. A second launch of the same kernel reduces the
// block roots when N > 512, so N <= 262,144 takes at most two launches
// (against log2 N for K2). All 256 threads hash at level 0, which holds
// half of a block's 511 parents; the active count halves at every later
// level, so those levels run on ever fewer warps.
//
// Plain C interface (bound with ctypes): each launcher returns
// cudaGetLastError() right after its launch.
//
// The per-item functions are device functions under nvcc and plain inline
// functions otherwise, so the same code also compiles as host C++ for a
// differential check without a GPU.
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

// One compression; blk holds 16 big-endian words and is used as the
// schedule ring (overwritten).
HD void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      uint32_t s0 = rotr32(x15, 7) ^ rotr32(x15, 18) ^ (x15 >> 3);
      uint32_t s1 = rotr32(x2, 17) ^ rotr32(x2, 19) ^ (x2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + SHA_K[t] + wt;
    uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of one pre-padded message of nblocks 64-byte blocks.
HD void sha256_words_one(const uint32_t* msg, int nblocks, uint32_t* out) {
  uint32_t st[8];
  sha256_init(st);
  for (int b = 0; b < nblocks; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = msg[16 * b + i];
    sha256_compress(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}

// RFC 6962 interior node: SHA256(0x01 || l || r), 65 bytes = 2 blocks.
HD void sha256_interior_one(const uint32_t* l, const uint32_t* r,
                            uint32_t* out) {
  uint32_t cat[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) { cat[i] = l[i]; cat[8 + i] = r[i]; }
  uint32_t w[16];
  w[0] = 0x01000000u | (cat[0] >> 8);
#pragma unroll
  for (int i = 1; i < 16; ++i) w[i] = (cat[i - 1] << 24) | (cat[i] >> 8);
  uint32_t st[8];
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = (cat[15] << 24) | 0x00800000u;
#pragma unroll
  for (int i = 1; i < 15; ++i) w[i] = 0;
  w[15] = 65 * 8;
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

#ifdef __CUDACC__

static constexpr int kThreads = 128;

__global__ void k_sha256_words(const uint32_t* __restrict__ msgs,
                               uint32_t* __restrict__ out, int n, int nblocks) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sha256_words_one(msgs + (size_t)i * 16 * nblocks, nblocks, out + (size_t)i * 8);
}

__global__ void k_merkle_level(const uint32_t* __restrict__ cur,
                               const uint32_t* __restrict__ bound,
                               const int32_t* __restrict__ off,
                               uint32_t* __restrict__ out, int n_parents) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_parents) return;
  merkle_parent_one(cur, bound, off[0] & 1, j, out + (size_t)j * 8);
}

// K7: block b reduces leaves [512 b, 512 b + w), w = min(n, 512), to
// out[b]. n is a power of two, so w is too.
static constexpr int kReduceThreads = 256;
static constexpr int kReduceLeaves = 2 * kReduceThreads;

__global__ void __launch_bounds__(kReduceThreads)
k_merkle_reduce(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int n) {
  __shared__ uint32_t buf[2][kReduceThreads][8];
  int t = threadIdx.x;
  int width = min(n - (int)blockIdx.x * kReduceLeaves, kReduceLeaves);
  const uint32_t* leaves = in + (size_t)blockIdx.x * kReduceLeaves * 8;
  if (t < width / 2)
    sha256_interior_one(leaves + 16 * t, leaves + 16 * t + 8, buf[0][t]);
  __syncthreads();
  int src = 0;
  for (int w = width / 2; w > 1; w >>= 1) {
    if (t < w / 2)
      sha256_interior_one(buf[src][2 * t], buf[src][2 * t + 1],
                          buf[src ^ 1][t]);
    __syncthreads();
    src ^= 1;
  }
  if (t < 8) out[(size_t)blockIdx.x * 8 + t] = buf[src][0][t];
}

static int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

extern "C" int sha256_words_launch(const void* msgs, void* out, int n,
                                   int nblocks, void* stream) {
  k_sha256_words<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msgs, (uint32_t*)out, n, nblocks);
  return (int)cudaGetLastError();
}

extern "C" int merkle_level_launch(const void* cur, const void* bound,
                                   const void* off, void* out, int n_parents,
                                   void* stream) {
  k_merkle_level<<<blocks_for(n_parents), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cur, (const uint32_t*)bound, (const int32_t*)off,
      (uint32_t*)out, n_parents);
  return (int)cudaGetLastError();
}

extern "C" int merkle_reduce_launch(const void* in, void* out, int n,
                                    void* stream) {
  int blocks = (n + kReduceLeaves - 1) / kReduceLeaves;
  k_merkle_reduce<<<blocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
