// Sumcheck round accumulators in coefficient form: the hypercube sums of
// one round, returned as the round's field values.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (with its XLA
// finisher finish_gruen_acc), gkr_mimc_tpu/ops/kernels.py:cipher_coeff_acc
// and gkr_mimc_tpu/ops/kernels.py:identity_coeff_acc (both with
// finish_coeff_acc). On the TPU the sum is carried in the output block
// across sequential grid steps and finished outside the kernel; here
// blocks run in no order, so pass 1 writes one partial per block and pass 2
// reduces the partials of each group.
//
// The Gruen cipher round (namespace gruen below) keeps the TPU kernel's
// algorithm: its 8 raw products stay unreduced, their sum over the points
// is a digit contraction, here on the int8 tensor cores, and the Montgomery
// reduction runs once a coefficient in pass 2.
//
// The direct cipher round and the identity round reduce every product in
// registers (CIOS, fr::mul) and sum field values (csrc/reduce.cuh). Bound
// on the H100: integer multiply throughput, 9 + 8 + 16 = 33 Montgomery
// products a half-cube point against 192 B read for the direct cipher
// round, 4 against 128 B for the identity round. Design: one thread per
// point in a grid-stride loop, the running sums in registers, a block
// reduction, and a second small launch over the partials.
#include <cuda_runtime.h>

#include "fr.cuh"
#include "reduce.cuh"

namespace {

using rsum::kThreads;

// The eight raw products u^(7-k) v^k, k = 0..7, by the chain shared with
// the plain twins (ops/kernels.py _cipher_raws): 9 products for the powers,
// then one per raw.
struct CipherPowers {
  fr::Fe u, v, u3, u6, v3, v6, uv2, uv3;
  __device__ __forceinline__ CipherPowers(const fr::Fe& u_, const fr::Fe& v_) : u(u_), v(v_) {
    const fr::Fe u2 = fr::mul(u, u);
    u3 = fr::mul(u2, u);
    u6 = fr::mul(u3, u3);
    const fr::Fe v2 = fr::mul(v, v);
    v3 = fr::mul(v2, v);
    v6 = fr::mul(v3, v3);
    const fr::Fe uv = fr::mul(u, v);
    uv2 = fr::mul(uv, uv);
    uv3 = fr::mul(uv, uv2);
  }
  // raw k unreduced: the 512-bit product of the same two factors
  __device__ __forceinline__ void raw_wide(int k, uint32_t (&t)[2 * fr::L]) const {
    switch (k) {
      case 0: fr::mul_wide(u6, u, t); return;
      case 1: fr::mul_wide(u6, v, t); return;
      case 2: fr::mul_wide(uv2, u3, t); return;
      case 3: fr::mul_wide(uv3, u, t); return;
      case 4: fr::mul_wide(uv3, v, t); return;
      case 5: fr::mul_wide(uv2, v3, t); return;
      case 6: fr::mul_wide(v6, u, t); return;
      default: fr::mul_wide(v6, v, t); return;
    }
  }
  __device__ __forceinline__ fr::Fe raw(int k) const {
    switch (k) {
      case 0: return fr::mul(u6, u);
      case 1: return fr::mul(u6, v);
      case 2: return fr::mul(uv2, u3);
      case 3: return fr::mul(uv3, u);
      case 4: return fr::mul(uv3, v);
      case 5: return fr::mul(uv2, v3);
      case 6: return fr::mul(v6, u);
      default: return fr::mul(v6, v);
    }
  }
};

// u = x0[bot] + x1[bot] + ark and v = x0[top] + x1[top] + ark - u.
__device__ __forceinline__ void cipher_line(const int32_t* x0, const int32_t* x1, const fr::Fe& a,
                                            int64_t n_x, int64_t bot, int64_t half, fr::Fe& u,
                                            fr::Fe& v) {
  u = fr::add(fr::add(fr::load(x0, n_x, bot), fr::load(x1, n_x, bot)), a);
  const fr::Fe top =
      fr::add(fr::add(fr::load(x0, n_x, bot + half), fr::load(x1, n_x, bot + half)), a);
  v = fr::sub(top, u);
}

// ---------------------------------------------------------------------------
// The Gruen cipher round: 17 products a point, the reduction deferred past
// the sum over the points, the sum a digit contraction on the tensor cores.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (:740, call :777;
// raws :667-695, kernel :698-737) and its finisher finish_gruen_acc (:813).
// The TPU kernel does 9 full products for the powers and leaves the 8 raws
// u^(7-m) v^m unreduced (512-bit products of two lazy factors); it sums
// S[y] * raw_m[y] over the points as a matrix product of their digits on
// the MXU, and its finisher carries the digit sums into one wide integer a
// coefficient, reduces it by three wide REDCs (S carries R, each raw R^2)
// and scales by C(7, m) R^2 in one Montgomery product.
//
// Bound on the H100: 32-bit integer multiply throughput. Per point, 9 full
// products (264 32-bit multiply results each) and 8 unreduced ones (128):
// 3,400 results against 96 B read; the contraction's 32 x 512 = 16,384
// byte MACs a point are ~8 % of that time at the tensor cores' int8 rate.
// The design before this one reduced every S * raw product in registers
// (25 products, 6,600 results a point) and ran at 4x its bound.
//
// Design, pass 1 (one block of 256 threads an SM, 215,680 B of dynamic
// shared memory): a tile is 256 points, one a thread. Each thread computes
// its point's powers on fr::mul and its 8 raws on fr::mul_wide, and writes
// them to shared memory as 32-bit words, point-contiguous: row 16 m + w
// holds word w of raw m. It writes S[y] as 35 byte windows W_j (byte q of
// W_j is byte j - q of S, zero outside 0..31), one row each. Then warp m
// contracts raw m with the windows over the tile's points:
// mma.sync.m16n8k32 u8 x u8 -> s32 with A = raw words (16 rows = the raw's
// 16 words; the 32 bytes of k are 8 points x 4 bytes) and B = windows
// (5 tiles of 8 columns), both through ldmatrix. Summed over q, the product
// of byte 4 w + q of a raw and byte j - q of S has weight 2^(8 (4 w + j)),
// so digit sum D_m[w][j] holds every byte pair (a, b) of raw m and S once,
// at byte column 4 w + j. A point adds at most 4 * 255^2 to a digit sum,
// so the s32 sums are flushed to 64-bit sums in shared memory every 32
// tiles (8,192 points, 2^31 / (4 * 255^2) = 8,256). The block ends by
// adding the digit sums of each raw into its 100 byte columns and writes
// them as its partial. Pass 2 (one block a group) adds the partials of the
// group's blocks, carries the columns into one 832-bit integer a raw,
// reduces it by three REDCs and one fr::mul by C(7, m) R^2 mod p, and
// returns Q canonical. All sums are of integers, so any order of blocks,
// warps and points gives the same bits.
// ---------------------------------------------------------------------------

namespace gruen {

constexpr int kTile = 256;                   // points a tile, one a thread
constexpr int kRawWords = 2 * fr::L;         // words of an unreduced raw
constexpr int kRows = 8 * kRawWords;         // shared rows of the raws: 16 m + w
constexpr int kLiveWins = 35;                // windows of S with a nonzero byte
constexpr int kWins = 40;                    // 5 tiles of 8 columns
constexpr int kStride = kTile + 4;           // words a row: the 8 rows of an ldmatrix hit distinct banks
constexpr int kCols = 100;                   // byte columns 4 w + j of a raw's sum
constexpr int kFlushTiles = 32;              // 8,192 points; 8,192 * 4 * 255^2 < 2^31
constexpr int kWideWords = 26;               // 832 bits hold a raw's sum (below 2^800)
constexpr size_t kSmemBytes =
    sizeof(uint32_t) * (kRows + kWins) * kStride + sizeof(uint64_t) * 8 * kRawWords * kWins;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a * b on one 16 x 8 tile: a 16 x 32 u8 (row), b 32 x 8 u8 (col).
__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Window j of w: byte q is byte j - q of w (little-endian), zero outside
// bytes 0..31. prmt picks from limb j/4 - 1 (bytes 0..3) and limb j/4
// (bytes 4..7).
__device__ __forceinline__ uint32_t window(const fr::Fe& w, int j) {
  const int a = j >> 2, b = j & 3;
  const uint32_t lo = a > 0 ? w.v[a > 0 ? a - 1 : 0] : 0u;
  const uint32_t hi = a < fr::L ? w.v[a < fr::L ? a : 0] : 0u;
  return __byte_perm(lo, hi, (4 + b) | (3 + b) << 4 | (2 + b) << 8 | (1 + b) << 12);
}

// Adds this lane's s32 digit sums of raw m into the 64-bit sums (each sum
// has one owner lane) and zeroes them.
__device__ __forceinline__ void flush(uint64_t* sums, int32_t (&acc)[5][4], int m, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 5; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = g + 8 * (i >> 1), j = 8 * nt + 2 * t + (i & 1);
      sums[(m * kRawWords + w) * kWins + j] += static_cast<uint32_t>(acc[nt][i]);
      acc[nt][i] = 0;
    }
}

// Pass 1. partial: (g * bpg, 8, kCols) byte-column sums a block.
__global__ void __launch_bounds__(kTile, 1)
    acc_kernel(const int32_t* s, const int32_t* x0, const int32_t* x1, const int32_t* ark,
               uint64_t* partial, int64_t half, int64_t g, int64_t bpg) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* raws = smem;                    // (kRows, kStride)
  uint32_t* wins = raws + kRows * kStride;  // (kWins, kStride)
  uint64_t* sums = reinterpret_cast<uint64_t*>(wins + kWins * kStride);  // (8, kRawWords, kWins)
  const int tid = threadIdx.x, lane = tid & 31, m = tid >> 5;
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const int64_t n_s = g * half;
  const fr::Fe a = fr::load(ark, g, grp);
  for (int i = tid; i < (kWins - kLiveWins) * kStride; i += kTile) wins[kLiveWins * kStride + i] = 0u;
  for (int i = tid; i < 8 * kRawWords * kWins; i += kTile) sums[i] = 0u;
  __syncthreads();

  // this lane's rows for ldmatrix: matrices 0-3 from lanes 0-7, 8-15, ...
  const int mat = lane >> 3, r8 = lane & 7;
  const uint32_t* a_row = raws + (kRawWords * m + r8 + 8 * (mat & 1)) * kStride + 4 * (mat >> 1);
  const uint32_t* b_row = wins + (r8 + 8 * (mat >> 1)) * kStride + 4 * (mat & 1);
  int32_t acc[5][4] = {};
  const int64_t tiles = (half + kTile - 1) / kTile;
  int since_flush = 0;
  for (int64_t tile = bi; tile < tiles; tile += bpg) {
    const int64_t y = tile * kTile + tid;
    if (y < half) {
      fr::Fe u, v;
      cipher_line(x0, x1, a, n_x, grp * 2 * half + y, half, u, v);
      const fr::Fe w = fr::load(s, n_s, grp * half + y);
#pragma unroll
      for (int j = 0; j < kLiveWins; ++j) wins[j * kStride + tid] = window(w, j);
      const CipherPowers pw(u, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t t[kRawWords];
        pw.raw_wide(k, t);
#pragma unroll
        for (int q = 0; q < kRawWords; ++q) raws[(kRawWords * k + q) * kStride + tid] = t[q];
      }
    } else {  // past the end: zero raws add nothing, whatever the windows hold
#pragma unroll 8
      for (int r = 0; r < kRows; ++r) raws[r * kStride + tid] = 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int ks = 0; ks < kTile / 8; ++ks) {  // 8 points a step
      uint32_t af[4], b01[4], b23[4], b4[2];
      ldsm_x4(af, a_row + 8 * ks);
      ldsm_x4(b01, b_row + 8 * ks);
      ldsm_x4(b23, b_row + 16 * kStride + 8 * ks);
      ldsm_x2(b4, b_row + 32 * kStride + 8 * ks);
      mma_u8(acc[0], af, b01[0], b01[1]);
      mma_u8(acc[1], af, b01[2], b01[3]);
      mma_u8(acc[2], af, b23[0], b23[1]);
      mma_u8(acc[3], af, b23[2], b23[3]);
      mma_u8(acc[4], af, b4[0], b4[1]);
    }
    if (++since_flush == kFlushTiles) {
      flush(sums, acc, m, lane);
      since_flush = 0;
    }
    __syncthreads();
  }
  flush(sums, acc, m, lane);
  __syncthreads();
  for (int i = tid; i < 8 * kCols; i += kTile) {
    const int mm = i / kCols, c = i - mm * kCols;
    uint64_t t = 0u;
#pragma unroll
    for (int w = 0; w < kRawWords; ++w) {
      const int j = c - 4 * w;
      if (j >= 0 && j < kWins) t += sums[(mm * kRawWords + w) * kWins + j];
    }
    partial[static_cast<int64_t>(blockIdx.x) * 8 * kCols + i] = t;
  }
}

// t <- (t + m p) / R, word by word, for the unique m < R with t + m p = 0
// mod R; t + m p stays below 2^(32 kWideWords).
__device__ __forceinline__ void redc_shift(uint32_t (&t)[kWideWords]) {
  const uint32_t p[fr::L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
#pragma unroll
  for (int i = 0; i < fr::L; ++i) {
    const uint32_t mi = t[i] * FR_NP0;
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < fr::L; ++j) {
      const uint64_t x = static_cast<uint64_t>(t[i + j]) + static_cast<uint64_t>(mi) * p[j] + c;
      t[i + j] = static_cast<uint32_t>(x);
      c = x >> 32;
    }
#pragma unroll
    for (int k = i + fr::L; k < kWideWords; ++k) {
      const uint64_t x = static_cast<uint64_t>(t[k]) + c;
      t[k] = static_cast<uint32_t>(x);
      c = x >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) t[k] = k + fr::L < kWideWords ? t[k + fr::L < kWideWords ? k + fr::L : 0] : 0u;
}

// Pass 2: one block a group. scale: (8, 8) rows C(7, m) R^2 mod p; out:
// (8, 8, g) canonical.
__global__ void __launch_bounds__(kTile)
    finish_kernel(const uint64_t* partial, const int32_t* scale, int32_t* out, int64_t g, int64_t bpg) {
  __shared__ uint64_t cols[8 * kCols];
  const int64_t grp = blockIdx.x;
  for (int i = threadIdx.x; i < 8 * kCols; i += kTile) {
    uint64_t t = 0u;
    for (int64_t b = 0; b < bpg; ++b) t += partial[(grp * bpg + b) * 8 * kCols + i];
    cols[i] = t;
  }
  __syncthreads();
  if (threadIdx.x >= 8) return;
  const int m = threadIdx.x;
  // sum_c cols[c] 2^(8 c) as 32-bit words; the sum is below 2^800
  uint32_t t[kWideWords];
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * k + b;
      const uint64_t x = (c < kCols ? cols[m * kCols + c] : 0u) + carry;
      word |= static_cast<uint32_t>(x & 0xFFu) << (8 * b);
      carry = x >> 8;
    }
    t[k] = word;
  }
  // S carries R and each raw R^2: three REDCs leave the plain value, below
  // 2p (2^786 / R^3 + p); one product by C(7, m) R^2 gives C(7, m) Q_m R
  redc_shift(t);
  redc_shift(t);
  redc_shift(t);
  fr::Fe v;
#pragma unroll
  for (int l = 0; l < fr::L; ++l) v.v[l] = t[l];
  fr::store(out + m * g, 8 * g, grp, fr::canonical(fr::mul(v, fr::load(scale + m * fr::L, 1, 0))));
}

}  // namespace gruen

// Pass 1 of the direct (pre-Gruen) cipher round in coefficient form. With
// e = eq[bot], de = eq[top] - e, P(t) = (e + t de) (u + t v)^7, so
// P_m = <e, C(7,m) raw_m> + <de, C(7,m-1) raw_(m-1)>, m = 0..8: per point
// each raw is scaled by its binomial (adds only) and feeds two sums.
__global__ void __launch_bounds__(kThreads)
    cipher_coeff_acc_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1,
                            const int32_t* ark, int32_t* partial, int64_t half, int64_t g,
                            int64_t bpg) {
  constexpr uint32_t kBinom[8] = {1, 7, 21, 35, 35, 21, 7, 1};
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const fr::Fe a = fr::load(ark, g, grp);
  fr::Fe acc[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) acc[m] = fr::zero();
  for (int64_t y = bi * kThreads + threadIdx.x; y < half; y += bpg * kThreads) {
    const int64_t bot = grp * 2 * half + y;
    fr::Fe u, v;
    cipher_line(x0, x1, a, n_x, bot, half, u, v);
    const fr::Fe e = fr::load(eq, n_x, bot);
    const fr::Fe de = fr::sub(fr::load(eq, n_x, bot + half), e);
    const CipherPowers pw(u, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const fr::Fe c = fr::mul_small(pw.raw(k), kBinom[k]);
      acc[k] = fr::add(acc[k], fr::mul(e, c));
      acc[k + 1] = fr::add(acc[k + 1], fr::mul(de, c));
    }
  }
  rsum::store_partial<9>(partial, acc);
}

// Pass 1 of the identity round in coefficient form. With e = eq[bot],
// de = eq[top] - e, u = x[bot], v = x[top] - u:
// acc = (<e,u>, <e,v> + <de,u>, <de,v>).
__global__ void __launch_bounds__(kThreads)
    identity_acc_kernel(const int32_t* eq, const int32_t* x, int32_t* partial, int64_t half,
                        int64_t g, int64_t bpg) {
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  fr::Fe acc[3] = {fr::zero(), fr::zero(), fr::zero()};
  for (int64_t y = bi * kThreads + threadIdx.x; y < half; y += bpg * kThreads) {
    const int64_t bot = grp * 2 * half + y;
    const fr::Fe e = fr::load(eq, n_x, bot);
    const fr::Fe de = fr::sub(fr::load(eq, n_x, bot + half), e);
    const fr::Fe u = fr::load(x, n_x, bot);
    const fr::Fe v = fr::sub(fr::load(x, n_x, bot + half), u);
    acc[0] = fr::add(acc[0], fr::mul(e, u));
    acc[1] = fr::add(acc[1], fr::add(fr::mul(e, v), fr::mul(de, u)));
    acc[2] = fr::add(acc[2], fr::mul(de, v));
  }
  rsum::store_partial<3>(partial, acc);
}

bool bad_geometry(int64_t half, int64_t g, int64_t bpg) { return half <= 0 || g <= 0 || bpg <= 0; }

}  // namespace

// s: (8, g * half); x0, x1: (8, g * 2 * half); ark: (8, g); scale: (8, 8)
// rows C(7, m) R^2 mod p; partial: (g * bpg, 8, 100) 64-bit scratch; out:
// (8, 8, g) canonical.
extern "C" int gkr_gruen_acc(const void* s, const void* x0, const void* x1, const void* ark,
                             const void* scale, void* partial, void* out, int64_t half, int64_t g,
                             int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gruen::acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(gruen::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gruen::acc_kernel<<<static_cast<unsigned>(g * bpg), gruen::kTile, gruen::kSmemBytes, st>>>(
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<uint64_t*>(partial), half, g, bpg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gruen::finish_kernel<<<static_cast<unsigned>(g), gruen::kTile, 0, st>>>(
      static_cast<const uint64_t*>(partial), static_cast<const int32_t*>(scale),
      static_cast<int32_t*>(out), g, bpg);
  return static_cast<int>(cudaGetLastError());
}

// eq, x0, x1: (8, g * 2 * half); ark: (8, g); partial: (g * bpg, 9, 8)
// scratch; out: (8, 9, g).
extern "C" int gkr_cipher_coeff_acc(const void* eq, const void* x0, const void* x1,
                                    const void* ark, void* partial, void* out, int64_t half,
                                    int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cipher_coeff_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<9>(partial, out, g, bpg, st);
}

// eq, x: (8, g * 2 * half); partial: (g * bpg, 3, 8) scratch; out: (8, 3, g).
extern "C" int gkr_identity_acc(const void* eq, const void* x, void* partial, void* out,
                                int64_t half, int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  identity_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<3>(partial, out, g, bpg, st);
}
