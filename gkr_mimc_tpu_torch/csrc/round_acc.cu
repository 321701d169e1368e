// Sumcheck round accumulators: the hypercube sums of one round, returned as
// the round's field values.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (with its XLA
// finisher finish_gruen_acc), gkr_mimc_tpu/ops/kernels.py:cipher_coeff_acc
// (with finish_coeff_acc), gkr_mimc_tpu/ops/kernels.py:cipher_partial_evals
// and cipher_partial_evals_g, and
// gkr_mimc_tpu/ops/kernels.py:identity_coeff_acc (with finish_coeff_acc).
// On the TPU the sum is carried in the output block across sequential grid
// steps and finished outside the kernel; here blocks run in no order, so
// pass 1 writes one partial per block and pass 2 reduces the partials of
// each group.
//
// The three cipher rounds (namespace deferred below) share one pass 1, the
// TPU kernels' algorithm: the 8 raw products of a point stay unreduced,
// their weighted sum over the points is a digit contraction, here on the
// int8 tensor cores, and the Montgomery reduction runs once a sum in
// pass 2. The Gruen round weighs the raws by one row (the suffix eq S),
// the direct rounds by two (eq at the bottom and at the top of the round's
// variable); pass 2 turns the sums into the Gruen round's Q, the
// round polynomial's coefficients, or its values at t.
//
// The identity round reduces every product in registers (CIOS, fr::mul)
// and sums field values (csrc/reduce.cuh). Bound on the H100: 4 Montgomery
// products a half-cube point against 128 B read. Design: one thread per
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
// The cipher rounds: 17 products a point, the reduction deferred past the
// sum over the points, the sum a digit contraction on the tensor cores.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (:740, call :777;
// raws :667-695, kernel :698-737) with its finisher finish_gruen_acc
// (:813), cipher_coeff_acc (:644, call :630; _weighted_acc_update :506,
// _cipher_coeff_kernel :539) with finish_coeff_acc (:1057), and
// cipher_partial_evals (:377, call :392) and cipher_partial_evals_g
// (:1211). The TPU kernels do 9 full products for the powers and leave the
// 8 raws u^(7-m) v^m unreduced (512-bit products of two lazy factors);
// they sum weight[y] * raw_m[y] over the points as a matrix product of
// their digits on the MXU, and the finisher carries the digit sums into
// one wide integer a sum, reduces it by three wide REDCs (the weight
// carries R, each raw R^2) and scales it. The TPU's evaluation-form kernel
// computes the S-box again at every t; here it is the same contraction,
// since the round polynomial P(t) = sum_m c_m t^m and the sum over the
// points commutes with evaluation at t.
//
// Weights (W rows): the Gruen round's suffix eq S (W = 1, Q_m = C(7, m)
// <S, raw_m>); the direct rounds' e = eq[bot] and et = eq[top] (W = 2).
// With de = et - e, P(t) = sum (e + t de) (u + t v)^7 has coefficients
// c_m = C(7, m) A_m + C(7, m - 1) (T_(m-1) - A_(m-1)), A_m = <e, raw_m>,
// T_m = <et, raw_m>; et, not de, is contracted so that both weight rows
// are table values below 2p.
//
// Bound on the H100: 32-bit integer multiply throughput. Per point, 9 full
// products (264 32-bit multiply results each) and 8 unreduced ones (128):
// 3,400 results against 96 B (W = 1) or 128 B (W = 2) read; the
// contraction's W x 32 x 512 byte MACs a point are ~8 % (W = 1) or ~14 %
// (W = 2) of that time at the tensor cores' int8 rate. The designs before
// this one reduced every weighted product in registers: 25 products a
// point for the Gruen round, 33 for the coefficients, 45 for the values at
// t = 0..8.
//
// Design, pass 1 (one block of 256 threads an SM, 181,120 B (W = 1) or
// 220,800 B (W = 2) of dynamic shared memory): a tile is 256 points, one a
// thread. Each thread computes its point's powers on fr::mul and its 8
// raws on fr::mul_wide, and writes them to shared memory as 32-bit words,
// point-contiguous: row 16 m + w holds word w of raw m. It writes each
// weight as 35 byte windows (byte q of window j is byte j - q of the
// weight, zero outside 0..31), one row each: row 35 r + j holds window j
// of weight row r, and zero rows pad them to whole tiles of 8 columns
// (5 tiles for W = 1, 9 for W = 2). Then warp m contracts raw m with the
// windows over the tile's points: mma.sync.m16n8k32 u8 x u8 -> s32 with
// A = raw words (16 rows = the raw's 16 words; the 32 bytes of k are 8
// points x 4 bytes) and B = windows, both through ldmatrix. Summed over q,
// the product of byte 4 w + q of a raw and byte j - q of a weight has
// weight 2^(8 (4 w + j)), so digit sum D_m[w][35 r + j] holds every byte
// pair (a, b) of raw m and weight r once, at byte column 4 w + j. A point
// adds at most 4 * 255^2 to a digit sum, so the s32 sums are flushed every
// 32 tiles (8,192 points, 2^31 / (4 * 255^2) = 8,256) into 64-bit byte
// columns in shared memory (shared atomic adds: the lanes of a warp share
// columns). The block writes its columns, 100 a raw and weight row, as its
// partial. Pass 2 (one block a group) adds the partials of the group's
// blocks, carries the columns into one 832-bit integer a sum and reduces
// it by three REDCs to the sum's plain value, then finishes it in
// Montgomery form, canonical: small multiples by C(7, m) and adds form
// Q_m (the Gruen round) or the coefficients c_m (the direct rounds), one
// fr::mul by R^2 mod p each, and the evaluations take Horner's rule at t
// on adds. All sums are of integers, so
// any order of blocks, warps and points gives the same bits.
// ---------------------------------------------------------------------------

namespace deferred {

constexpr int kTile = 256;                   // points a tile, one a thread
constexpr int kRawWords = 2 * fr::L;         // words of an unreduced raw
constexpr int kRows = 8 * kRawWords;         // shared rows of the raws: 16 m + w
constexpr int kLiveWins = 35;                // windows of a weight with a nonzero byte
constexpr int kStride = kTile + 4;           // words a row: the 8 rows of an ldmatrix hit distinct banks
constexpr int kCols = 100;                   // byte columns 4 w + j of a sum (94 the last nonzero)
constexpr int kFlushTiles = 32;              // 8,192 points; 8,192 * 4 * 255^2 < 2^31
constexpr int kWideWords = 26;               // 832 bits hold a sum (below 2^800)

// W weight rows: tiles of 8 window columns, shared memory of pass 1
template <int W>
struct Shape {
  static constexpr int kNTiles = (kLiveWins * W + 7) / 8;  // 5 or 9
  static constexpr int kWins = 8 * kNTiles;                // window rows, the live ones first
  static constexpr int kSums = 8 * W;                      // sums a block: raw m, weight r at m W + r
  static constexpr size_t kSmemBytes =
      sizeof(uint32_t) * (kRows + kWins) * kStride + sizeof(uint64_t) * kSums * kCols;
};

// R^2 mod p: one Montgomery product by it takes a plain value to its
// Montgomery form
__device__ __forceinline__ fr::Fe r2() {
  return fr::Fe{{0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u,
                 0x0216d0b1u}};
}

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

// Adds this lane's s32 digit sums of raw m into the 64-bit byte columns
// and zeroes them. Window column 35 r + j of word w goes to column 4 w + j
// of sum m W + r; the padding columns (r = W) hold zeros.
template <int W>
__device__ __forceinline__ void flush(uint64_t* cols, int32_t (&acc)[Shape<W>::kNTiles][4], int m, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Shape<W>::kNTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = g + 8 * (i >> 1), col = 8 * nt + 2 * t + (i & 1);
      const int r = col / kLiveWins, j = col - r * kLiveWins;
      if (r < W)
        atomicAdd(reinterpret_cast<unsigned long long*>(cols + (m * W + r) * kCols + 4 * w + j),
                  static_cast<unsigned long long>(static_cast<uint32_t>(acc[nt][i])));
      acc[nt][i] = 0;
    }
}

// Pass 1. wt: the weights, (8, g * half) for W = 1 (entry grp * half + y),
// (8, g * 2 half) for W = 2 (entries bot and bot + half); x0, x1:
// (8, g * 2 half); partial: (g * bpg, 8 W, kCols) byte-column sums a block.
template <int W>
__global__ void __launch_bounds__(kTile, 1)
    acc_kernel(const int32_t* wt, const int32_t* x0, const int32_t* x1, const int32_t* ark,
               uint64_t* partial, int64_t half, int64_t g, int64_t bpg) {
  using S = Shape<W>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* raws = smem;                    // (kRows, kStride)
  uint32_t* wins = raws + kRows * kStride;  // (S::kWins, kStride)
  uint64_t* cols = reinterpret_cast<uint64_t*>(wins + S::kWins * kStride);  // (S::kSums, kCols)
  const int tid = threadIdx.x, lane = tid & 31, m = tid >> 5;
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const int64_t n_w = W == 1 ? g * half : n_x;
  const fr::Fe a = fr::load(ark, g, grp);
  for (int i = tid; i < (S::kWins - W * kLiveWins) * kStride; i += kTile) wins[W * kLiveWins * kStride + i] = 0u;
  for (int i = tid; i < S::kSums * kCols; i += kTile) cols[i] = 0u;
  __syncthreads();

  // this lane's rows for ldmatrix: matrices 0-3 from lanes 0-7, 8-15, ...
  const int mat = lane >> 3, r8 = lane & 7;
  const uint32_t* a_row = raws + (kRawWords * m + r8 + 8 * (mat & 1)) * kStride + 4 * (mat >> 1);
  const uint32_t* b_row = wins + (r8 + 8 * (mat >> 1)) * kStride + 4 * (mat & 1);
  int32_t acc[S::kNTiles][4] = {};
  const int64_t tiles = (half + kTile - 1) / kTile;
  int since_flush = 0;
  for (int64_t tile = bi; tile < tiles; tile += bpg) {
    const int64_t y = tile * kTile + tid;
    if (y < half) {
      const int64_t bot = grp * 2 * half + y;
      fr::Fe u, v;
      cipher_line(x0, x1, a, n_x, bot, half, u, v);
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const fr::Fe w = fr::load(wt, n_w, (W == 1 ? grp * half + y : bot) + r * half);
#pragma unroll
        for (int j = 0; j < kLiveWins; ++j) wins[(kLiveWins * r + j) * kStride + tid] = window(w, j);
      }
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
      uint32_t af[4];
      ldsm_x4(af, a_row + 8 * ks);
#pragma unroll
      for (int p = 0; p < S::kNTiles / 2; ++p) {  // two tiles of 8 windows a load
        uint32_t b[4];
        ldsm_x4(b, b_row + 16 * p * kStride + 8 * ks);
        mma_u8(acc[2 * p], af, b[0], b[1]);
        mma_u8(acc[2 * p + 1], af, b[2], b[3]);
      }
      if (S::kNTiles & 1) {
        uint32_t b[2];
        ldsm_x2(b, b_row + 16 * (S::kNTiles / 2) * kStride + 8 * ks);
        mma_u8(acc[S::kNTiles - 1], af, b[0], b[1]);
      }
    }
    if (++since_flush == kFlushTiles) {
      flush<W>(cols, acc, m, lane);
      since_flush = 0;
    }
    __syncthreads();
  }
  flush<W>(cols, acc, m, lane);
  __syncthreads();
  for (int i = tid; i < S::kSums * kCols; i += kTile)
    partial[static_cast<int64_t>(blockIdx.x) * S::kSums * kCols + i] = cols[i];
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

// Sums nsums x kCols byte columns over the bpg partials of group grp into
// cols (all threads of the block), then returns, in threads below nsums,
// the plain value of sum threadIdx.x: the columns carried into one wide
// integer, three REDCs (the weight carries R and each raw R^2), below 2p
// (2^786 / R^3 + p).
__device__ __forceinline__ fr::Fe sum_plain(const uint64_t* partial, uint64_t* cols, int nsums, int64_t grp,
                                            int64_t bpg) {
  for (int i = threadIdx.x; i < nsums * kCols; i += blockDim.x) {
    uint64_t t = 0u;
    for (int64_t b = 0; b < bpg; ++b) t += partial[(grp * bpg + b) * nsums * kCols + i];
    cols[i] = t;
  }
  __syncthreads();
  fr::Fe v = fr::zero();
  if (static_cast<int>(threadIdx.x) >= nsums) return v;
  const uint64_t* c = cols + threadIdx.x * kCols;
  // sum_c c[c] 2^(8 c) as 32-bit words; the sum is below 2^800
  uint32_t t[kWideWords];
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cc = 4 * k + b;
      const uint64_t x = (cc < kCols ? c[cc] : 0u) + carry;
      word |= static_cast<uint32_t>(x & 0xFFu) << (8 * b);
      carry = x >> 8;
    }
    t[k] = word;
  }
  redc_shift(t);
  redc_shift(t);
  redc_shift(t);
#pragma unroll
  for (int l = 0; l < fr::L; ++l) v.v[l] = t[l];
  return v;
}

// C(7, k), k = 0..7
__device__ __forceinline__ uint32_t binom7(int k) {
  const int d = k < 4 ? k : 7 - k;
  return d == 0 ? 1u : d == 1 ? 7u : d == 2 ? 21u : 35u;
}

// Pass 2 of the Gruen round: one block a group. out: (8, 8, g) canonical,
// Q_m = C(7, m) <S, raw_m> in Montgomery form.
__global__ void __launch_bounds__(kTile)
    gruen_finish_kernel(const uint64_t* partial, int32_t* out, int64_t g, int64_t bpg) {
  __shared__ uint64_t cols[8 * kCols];
  const int64_t grp = blockIdx.x;
  const fr::Fe v = sum_plain(partial, cols, 8, grp, bpg);
  if (threadIdx.x >= 8) return;
  const int m = threadIdx.x;
  fr::store(out + m * g, 8 * g, grp, fr::canonical(fr::mul(fr::mul_small(v, binom7(m)), r2())));
}

// Pass 2 of the direct rounds: one block a group. t0 < 0: out (8, 9, g)
// the coefficients c_0..c_8; else out (8, 9 - t0, g) the values P(t) at
// t = t0..8. Canonical Montgomery form.
__global__ void __launch_bounds__(kTile)
    coeff_finish_kernel(const uint64_t* partial, int32_t* out, int64_t g, int64_t bpg, int t0) {
  __shared__ uint64_t cols[16 * kCols];
  __shared__ fr::Fe plain[16];  // A_m at 2 m, T_m at 2 m + 1
  __shared__ fr::Fe coef[9];
  const int64_t grp = blockIdx.x;
  const int tid = threadIdx.x;
  const fr::Fe v = sum_plain(partial, cols, 16, grp, bpg);
  if (tid < 16) plain[tid] = v;
  __syncthreads();
  if (tid < 9) {  // c_m = C(7, m) A_m + C(7, m - 1) (T_(m-1) - A_(m-1)), to Montgomery form
    const int m = tid;
    fr::Fe c = m < 8 ? fr::mul_small(plain[2 * m], binom7(m)) : fr::zero();
    if (m > 0) c = fr::add(c, fr::mul_small(fr::sub(plain[2 * m - 1], plain[2 * m - 2]), binom7(m - 1)));
    coef[m] = fr::mul(c, r2());
  }
  __syncthreads();
  if (t0 < 0) {
    if (tid < 9) fr::store(out + tid * g, 9 * g, grp, fr::canonical(coef[tid]));
    return;
  }
  const int n_out = 9 - t0;
  if (tid >= n_out) return;
  const uint32_t t = static_cast<uint32_t>(t0 + tid);
  fr::Fe p = coef[8];  // Horner's rule; a multiple by t >= 1 is adds (mul_small), P(0) = c_0
#pragma unroll
  for (int m = 7; m >= 0; --m) p = fr::add(t == 0u ? fr::zero() : fr::mul_small(p, t), coef[m]);
  fr::store(out + tid * g, n_out * g, grp, fr::canonical(p));
}

template <int W>
int launch_acc(const void* wt, const void* x0, const void* x1, const void* ark, void* partial, int64_t half,
               int64_t g, int64_t bpg, cudaStream_t st) {
  constexpr size_t smem = Shape<W>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(acc_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  acc_kernel<W><<<static_cast<unsigned>(g * bpg), kTile, smem, st>>>(
      static_cast<const int32_t*>(wt), static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const int32_t*>(ark), static_cast<uint64_t*>(partial), half, g, bpg);
  return static_cast<int>(cudaGetLastError());
}

// The direct rounds: pass 1 on two weight rows, then coeff_finish_kernel.
int direct_round(const void* eq, const void* x0, const void* x1, const void* ark, void* partial, void* out,
                 int64_t half, int64_t g, int64_t bpg, int t0, cudaStream_t st) {
  const int err = launch_acc<2>(eq, x0, x1, ark, partial, half, g, bpg, st);
  if (err != 0) return err;
  coeff_finish_kernel<<<static_cast<unsigned>(g), kTile, 0, st>>>(static_cast<const uint64_t*>(partial),
                                                                  static_cast<int32_t*>(out), g, bpg, t0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace deferred

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

// s: (8, g * half); x0, x1: (8, g * 2 * half); ark: (8, g); partial:
// (g * bpg, 8, 100) 64-bit scratch; out: (8, 8, g) canonical.
extern "C" int gkr_gruen_acc(const void* s, const void* x0, const void* x1, const void* ark, void* partial,
                             void* out, int64_t half, int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = deferred::launch_acc<1>(s, x0, x1, ark, partial, half, g, bpg, st);
  if (err != 0) return err;
  deferred::gruen_finish_kernel<<<static_cast<unsigned>(g), deferred::kTile, 0, st>>>(
      static_cast<const uint64_t*>(partial), static_cast<int32_t*>(out), g, bpg);
  return static_cast<int>(cudaGetLastError());
}

// eq, x0, x1: (8, g * 2 * half); ark: (8, g); partial: (g * bpg, 16, 100)
// 64-bit scratch; out: (8, 9, g) canonical.
extern "C" int gkr_cipher_coeff_acc(const void* eq, const void* x0, const void* x1,
                                    const void* ark, void* partial, void* out, int64_t half,
                                    int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  return deferred::direct_round(eq, x0, x1, ark, partial, out, half, g, bpg, -1,
                                static_cast<cudaStream_t>(stream));
}

// The round polynomial's values at t = skip_t0..8 (t = 1..8 with the claim
// trick, where the caller derives P(0) = claim - P(1)). eq, x0, x1:
// (8, g * 2 * half); ark: (8, g); n_evals = 9 (degree 7 + 2); partial:
// (g * bpg, 16, 100) 64-bit scratch; out: (8, n_evals - skip_t0, g)
// canonical.
extern "C" int gkr_cipher_partial_evals(const void* eq, const void* x0, const void* x1,
                                        const void* ark, void* partial, void* out, int64_t half,
                                        int64_t g, int64_t bpg, int64_t n_evals, int64_t skip_t0,
                                        void* stream) {
  if (bad_geometry(half, g, bpg) || n_evals != 9) return static_cast<int>(cudaErrorInvalidValue);
  return deferred::direct_round(eq, x0, x1, ark, partial, out, half, g, bpg, skip_t0 ? 1 : 0,
                                static_cast<cudaStream_t>(stream));
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
