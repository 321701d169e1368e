// Sumcheck round accumulators: the hypercube sums of one round, returned as
// the round's field values.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (with its XLA
// finisher finish_gruen_acc), gkr_mimc_tpu/ops/kernels.py:cipher_coeff_acc
// (with finish_coeff_acc), gkr_mimc_tpu/ops/kernels.py:cipher_partial_evals
// and cipher_partial_evals_g, gkr_mimc_tpu/ops/kernels.py:identity_coeff_acc
// (with finish_coeff_acc), and identity_partial_evals and
// identity_partial_evals_g. On the TPU the sum is carried in the output
// block across sequential grid steps and finished outside the kernel; here
// blocks run in no order, so pass 1 writes one partial per block (the
// identity round adds it into its group's sums by integer atomics) and
// pass 2 finishes each group.
//
// Every round here defers the Montgomery reduction past the sum over the
// points (namespace deferred), the TPU kernels' algorithm: the products of
// a point stay unreduced, their weighted sum over the points is a digit
// contraction, here on the int8 tensor cores, and the reduction runs once
// a sum in pass 2. The three cipher rounds share one pass 1 over the 8 raw
// products of the S-box: the Gruen round weighs the raws by one row (the
// suffix eq S), the direct rounds by two (eq at the bottom and at the top
// of the round's variable); pass 2 turns the sums into the Gruen round's
// Q, the round polynomial's coefficients, or its values at t. The identity
// round's pass 1 contracts the table itself (its bottom and top halves)
// with the same two rows of eq, and its pass 2 gives the coefficients or
// the values at t of the degree-2 round polynomial.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

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

// Sums nsums x Cols byte columns over the bpg partials of group grp into
// cols (all threads of the block), then returns, in threads below nsums,
// the plain value of sum threadIdx.x: the columns carried into one wide
// integer and Redcs REDCs, one for each factor of R the sum carries. The
// cipher rounds: three (the weight carries R and each raw R^2), below 2p
// (2^786 / R^3 + p). The identity round: two (eq and the table carry R
// each), below 2p (2^534 / R^2 + p).
template <int Cols, int Redcs>
__device__ __forceinline__ fr::Fe sum_plain(const uint64_t* partial, uint64_t* cols, int nsums, int64_t grp,
                                            int64_t bpg) {
  for (int i = threadIdx.x; i < nsums * Cols; i += blockDim.x) {
    uint64_t t = 0u;
    for (int64_t b = 0; b < bpg; ++b) t += partial[(grp * bpg + b) * nsums * Cols + i];
    cols[i] = t;
  }
  __syncthreads();
  fr::Fe v = fr::zero();
  if (static_cast<int>(threadIdx.x) >= nsums) return v;
  const uint64_t* c = cols + threadIdx.x * Cols;
  // sum_c c[c] 2^(8 c) as 32-bit words; the sum is below 2^800
  uint32_t t[kWideWords];
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int cc = 4 * k + b;
      const uint64_t x = (cc < Cols ? c[cc] : 0u) + carry;
      word |= static_cast<uint32_t>(x & 0xFFu) << (8 * b);
      carry = x >> 8;
    }
    t[k] = word;
  }
#pragma unroll
  for (int i = 0; i < Redcs; ++i) redc_shift(t);
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
  const fr::Fe v = sum_plain<kCols, 3>(partial, cols, 8, grp, bpg);
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
  const fr::Fe v = sum_plain<kCols, 3>(partial, cols, 16, grp, bpg);
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

// ---------------------------------------------------------------------------
// The identity round: the round polynomial of eq * x (degree 2) on the same
// deferred contraction, the table itself in the place of the raws.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:identity_coeff_acc (:651, call :630;
// _identity_coeff_kernel :560, _weighted_acc_update :506) with
// finish_coeff_acc (:1057), identity_partial_evals (:411, call :424;
// _identity_pe_kernel :342, _finish_evals :370) and
// identity_partial_evals_g (:1223, call :1198). The TPU kernels sum the
// unreduced products of eq and x as digit columns and reduce once a sum;
// so does this one, for both forms in one pass 1. With eb, et the bottom
// and top halves of eq and xb, xt those of x (lazy Montgomery values below
// 2p), it sums four unreduced 512-bit products over the points:
// A = <eb, xb>, C = <et, xb>, B = <eb, xt>, D = <et, xt>. The round
// polynomial P(t) = sum (eb + t (et - eb)) (xb + t (xt - xb)) has the
// coefficients c0 = A, c1 = B + C - 2A, c2 = A - B - C + D, and the values
// P(0) = A, P(1) = D, P(2) = 4D - 2B - 2C + A.
//
// Bound on the H100: device memory. A point reads 128 B and needs
// 4 x 32 x 32 byte MACs: at n = 2^22, 268 MB, 0.080 ms at 3.35 TB/s,
// against ~9 us of int8 operations. The design before this one reduced
// every product in registers (4 CIOS products a point for the
// coefficients, 2 for the values at t = 1, 2) and summed field values by
// warp shuffles.
//
// Design, pass 1 (128 threads, 4 warps, 3 blocks an SM, 63,104 B of
// dynamic shared memory; a tile is 128 points): the table is limb-major
// and point-contiguous, so row w of the contraction's A operand (word w of
// xb, rows 0-7; of xt, rows 8-15) is the table's row w as it lies in device
// memory; cp.async copies it into shared memory a tile ahead, into the
// other of two stages, in 16-byte pieces past L1 (4-byte words where a row
// does not start on 16 bytes: half = 1, 2), with no pass through
// registers. Each thread loads its point's eb and et into registers a
// tile ahead and writes their 70 byte windows (window j of eq half r at
// shared row 35 r + j, as in acc_kernel<2>; two zero rows make 9 tiles of 8
// columns). The four warps share a tile's 16 k-steps of 8 points (warp k
// takes steps 4 k .. 4 k + 3): one mma.sync m16n8k32 a step and window tile
// gives every (x half, word) x (eq half, window) digit sum, so 8 points
// cost one warp 9 MMAs. Digit D[g + 8 h][35 r + j] is byte column 4 g + j
// (at most 62) of sum 2 h + r. A warp's s32 sums grow by at most
// 32 x 4 x 255^2 a tile and are flushed every 16 tiles (2,048 points a
// block, 512 a warp; an s32 sum holds 8,256 points) into the warp's own
// 64-bit columns in shared memory, a window tile at a time, lanes t < 2
// then t >= 2 (no two lanes of such a step share a column), so no atomics
// there. The block adds the sum of its warps' columns, 4 sums x 64, into
// its group's sums in device memory (64-bit atomic adds into the caller's
// scratch, zeroed first), so pass 2 reads 256 words a group however many
// blocks there were. Pass 2 (one block a group) carries each sum into one
// wide integer and reduces it by two REDCs to its plain value, then forms
// the coefficients by adds and subtractions mod 2p, one fr::mul by R^2 each
// to Montgomery form, and the values at t by Horner's rule on adds;
// canonical. The time of each pass: scripts/torch_identity_passes.py.
//
// Where it could go wrong, and what holds it:
// - Headroom: a sum is below half x (2p)^2 < 2^533 for a group of 2^24
//   entries (the lazy edges, eq = x = 2p - 1, reach it); kWideWords = 26
//   words hold it and the REDCs' t + m p; after two REDCs it is below
//   2^533 / R^2 + p < 2p. A byte column takes at most 32 byte pairs a
//   point (2^43 points before 2^64).
// - Ragged halves (1 point, 64 points) and a group's tiles not a multiple
//   of its blocks: cp.async fills zeros and eq loads as zero past the end,
//   and the blocks take tiles grid-stride.
// - Blocks, warps and points in any order, the blocks' atomic adds too:
//   every sum is of integers, so the bits do not depend on it. No field
//   value is summed in a warp.
// ---------------------------------------------------------------------------

constexpr int kIdTile = 128;                      // points a tile, one a thread for the windows
constexpr int kIdWarps = kIdTile / 32;            // 4
constexpr int kIdSteps = kIdTile / 8 / kIdWarps;  // k-steps of 8 points a warp a tile: 4
constexpr int kIdRows = 2 * fr::L;                // A rows: the words of x[bot], then of x[top]
constexpr int kIdStride = kIdTile + 4;            // words a row: the 8 rows of an ldmatrix hit distinct banks
constexpr int kIdCols = 64;                       // byte columns 4 w + j of a sum (62 the last nonzero)
constexpr int kIdSums = 4;                        // sum 2 h + r: x half h against eq half r
constexpr int kIdFlushTiles = 16;                 // a warp's s32 sums: 16 x 32 x 4 x 255^2 < 2^31
using IdShape = Shape<2>;                         // the two eq halves' windows: 9 tiles of 8 columns
constexpr size_t kIdSmemBytes = sizeof(uint32_t) * (2 * kIdRows + IdShape::kWins) * kIdStride +
                                sizeof(uint64_t) * kIdWarps * kIdSums * kIdCols;

// 4 bytes from device memory to shared memory, no registers; zeros unless
// valid.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes from device memory to shared memory (both 16-byte aligned),
// past L1; zeros unless valid.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const int32_t* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// All but the latest group of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// Adds this lane's s32 digit sums into its warp's 64-bit byte columns
// cols (kIdSums, kIdCols) and zeroes them. Row g + 8 h, window column
// 35 r + j goes to column 4 g + j of sum 2 h + r; the padding columns
// (r = 2) hold zeros. Lanes (g, t) and (g', t') of one window tile meet
// only if 4 g + 2 t = 4 g' + 2 t', t - t' = +-2: so a tile's adds run in
// two rounds, t < 2 then t >= 2, each closed by __syncwarp.
__device__ __forceinline__ void identity_flush(uint64_t* cols, int32_t (&acc)[IdShape::kNTiles][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < IdShape::kNTiles; ++nt)
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if ((t >> 1) == round) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * nt + 2 * t + (i & 1);
          const int r = col / kLiveWins, j = col - r * kLiveWins;
          if (r < 2) cols[(2 * (i >> 1) + r) * kIdCols + 4 * g + j] += static_cast<uint32_t>(acc[nt][i]);
          acc[nt][i] = 0;
        }
      }
      __syncwarp();
    }
}

// Pass 1 of the identity round. eq, x: (8, g * 2 half); sums:
// (g, kIdSums, kIdCols) byte-column sums a group, zero before the launch.
__global__ void __launch_bounds__(kIdTile, 3)
    identity_acc_kernel(const int32_t* eq, const int32_t* x, uint64_t* sums, int64_t half, int64_t g,
                        int64_t bpg) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs = smem;                                    // 2 stages of (kIdRows, kIdStride)
  uint32_t* wins = xs + 2 * kIdRows * kIdStride;          // (IdShape::kWins, kIdStride)
  uint64_t* cols = reinterpret_cast<uint64_t*>(wins + IdShape::kWins * kIdStride);  // (kIdWarps, kIdSums, kIdCols)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const int64_t tiles = (half + kIdTile - 1) / kIdTile;
  for (int i = tid; i < (IdShape::kWins - 2 * kLiveWins) * kIdStride; i += kIdTile)
    wins[2 * kLiveWins * kIdStride + i] = 0u;
  for (int i = tid; i < kIdWarps * kIdSums * kIdCols; i += kIdTile) cols[i] = 0u;
  __syncthreads();

  // A tile's x rows by cp.async into a stage: 16-byte pieces, 4 a thread,
  // where every row starts on 16 bytes (half a multiple of 4, x aligned),
  // else each thread its point's 16 words. Each thread's point's eq halves
  // into registers. Zeros past the end.
  const bool pieces = half % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fr::Fe eb = fr::zero(), et = fr::zero();
  auto fetch = [&](int64_t tile, uint32_t* stage) {
    const int64_t y = tile * kIdTile + tid;
    const bool in = y < half;
    const int64_t bot = grp * 2 * half + (in ? y : 0);
    if (pieces) {
#pragma unroll
      for (int k = 0; k < kIdRows / 4; ++k) {
        const int c = tid + kIdTile * k, row = c / (kIdTile / 4), q = c % (kIdTile / 4);
        const int64_t y0 = tile * kIdTile + 4 * q;
        cp_async16(stage + row * kIdStride + 4 * q,
                   x + (row % fr::L) * n_x + grp * 2 * half + (row / fr::L) * half + (y0 < half ? y0 : 0),
                   y0 < half);
      }
    } else {
#pragma unroll
      for (int w = 0; w < fr::L; ++w) {
        cp_async4(stage + w * kIdStride + tid, x + w * n_x + bot, in);
        cp_async4(stage + (fr::L + w) * kIdStride + tid, x + w * n_x + bot + half, in);
      }
    }
#pragma unroll
    for (int w = 0; w < fr::L; ++w) {
      eb.v[w] = in ? static_cast<uint32_t>(eq[w * n_x + bot]) : 0u;
      et.v[w] = in ? static_cast<uint32_t>(eq[w * n_x + bot + half]) : 0u;
    }
  };

  // this lane's rows for ldmatrix: matrices 0-3 from lanes 0-7, 8-15, ...
  const int mat = lane >> 3, r8 = lane & 7;
  const int a_off = (r8 + 8 * (mat & 1)) * kIdStride + 4 * (mat >> 1);
  const uint32_t* b_row = wins + (r8 + 8 * (mat >> 1)) * kIdStride + 4 * (mat & 1);
  int32_t acc[IdShape::kNTiles][4] = {};
  int stage = 0, since_flush = 0;
  if (bi < tiles) fetch(bi, xs);
  cp_async_commit();
  for (int64_t tile = bi; tile < tiles; tile += bpg) {
#pragma unroll
    for (int j = 0; j < kLiveWins; ++j) {
      wins[j * kIdStride + tid] = window(eb, j);
      wins[(kLiveWins + j) * kIdStride + tid] = window(et, j);
    }
    if (tile + bpg < tiles) fetch(tile + bpg, xs + (stage ^ 1) * kIdRows * kIdStride);
    cp_async_commit();
    cp_async_wait_prior();  // this thread's copies of this tile
    __syncthreads();        // every thread's copies and windows
    const uint32_t* a_row = xs + stage * kIdRows * kIdStride + a_off;
#pragma unroll
    for (int s = 0; s < kIdSteps; ++s) {
      const int ks = warp * kIdSteps + s;
      uint32_t af[4];
      ldsm_x4(af, a_row + 8 * ks);
#pragma unroll
      for (int p = 0; p < IdShape::kNTiles / 2; ++p) {  // two tiles of 8 windows a load
        uint32_t b[4];
        ldsm_x4(b, b_row + 16 * p * kIdStride + 8 * ks);
        mma_u8(acc[2 * p], af, b[0], b[1]);
        mma_u8(acc[2 * p + 1], af, b[2], b[3]);
      }
      uint32_t b[2];
      ldsm_x2(b, b_row + 16 * (IdShape::kNTiles / 2) * kIdStride + 8 * ks);
      mma_u8(acc[IdShape::kNTiles - 1], af, b[0], b[1]);
    }
    if (++since_flush == kIdFlushTiles) {
      identity_flush(cols + warp * kIdSums * kIdCols, acc, lane);
      since_flush = 0;
    }
    __syncthreads();  // before the next tile's windows and copies overwrite these
    stage ^= 1;
  }
  identity_flush(cols + warp * kIdSums * kIdCols, acc, lane);
  __syncthreads();
  for (int i = tid; i < kIdSums * kIdCols; i += kIdTile) {
    uint64_t t = 0u;
#pragma unroll
    for (int w = 0; w < kIdWarps; ++w) t += cols[w * kIdSums * kIdCols + i];
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + grp * kIdSums * kIdCols + i),
              static_cast<unsigned long long>(t));
  }
}

// Pass 2 of the identity round: one block a group. t0 < 0: out (8, 3, g)
// the coefficients c_0..c_2; else out (8, 3 - t0, g) the values P(t) at
// t = t0..2. Canonical Montgomery form.
__global__ void __launch_bounds__(kTile)
    identity_finish_kernel(const uint64_t* sums, int32_t* out, int64_t g, int t0) {
  __shared__ uint64_t cols[kIdSums * kIdCols];
  __shared__ fr::Fe plain[kIdSums];  // A, C, B, D: sum 2 h + r of x half h and eq half r
  __shared__ fr::Fe coef[3];
  const int64_t grp = blockIdx.x;
  const int tid = threadIdx.x;
  const fr::Fe v = sum_plain<kIdCols, 2>(sums, cols, kIdSums, grp, 1);
  if (tid < kIdSums) plain[tid] = v;
  __syncthreads();
  if (tid < 3) {  // c_0 = A, c_1 = B + C - 2A, c_2 = A - B - C + D, to Montgomery form
    const fr::Fe a = plain[0], bc = fr::add(plain[2], plain[1]);
    fr::Fe c = a;
    if (tid == 1) c = fr::sub(bc, fr::add(a, a));
    if (tid == 2) c = fr::add(fr::sub(a, bc), plain[3]);
    coef[tid] = fr::mul(c, r2());
  }
  __syncthreads();
  if (t0 < 0) {
    if (tid < 3) fr::store(out + tid * g, 3 * g, grp, fr::canonical(coef[tid]));
    return;
  }
  const int n_out = 3 - t0;
  if (tid >= n_out) return;
  const uint32_t t = static_cast<uint32_t>(t0 + tid);
  fr::Fe p = coef[2];  // Horner's rule; a multiple by t >= 1 is adds (mul_small), P(0) = c_0
#pragma unroll
  for (int m = 1; m >= 0; --m) p = fr::add(t == 0u ? fr::zero() : fr::mul_small(p, t), coef[m]);
  fr::store(out + tid * g, n_out * g, grp, fr::canonical(p));
}

// The identity round: the group sums zeroed, pass 1, identity_finish_kernel.
int identity_round(const void* eq, const void* x, void* sums, void* out, int64_t half, int64_t g, int64_t bpg,
                   int t0, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(uint64_t) * g * kIdSums * kIdCols, st);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(identity_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kIdSmemBytes));
  if (err == cudaSuccess)  // all of the SM's shared memory, so that three blocks fit
    err = cudaFuncSetAttribute(identity_acc_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  identity_acc_kernel<<<static_cast<unsigned>(g * bpg), kIdTile, kIdSmemBytes, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x), static_cast<uint64_t*>(sums), half, g, bpg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  identity_finish_kernel<<<static_cast<unsigned>(g), kTile, 0, st>>>(static_cast<const uint64_t*>(sums),
                                                                     static_cast<int32_t*>(out), g, t0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace deferred

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

// eq, x: (8, g * 2 * half); sums: (g, 4, 64) 64-bit scratch; out: (8, 3, g)
// canonical; bpg blocks a group.
extern "C" int gkr_identity_acc(const void* eq, const void* x, void* sums, void* out, int64_t half, int64_t g,
                                int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  return deferred::identity_round(eq, x, sums, out, half, g, bpg, -1, static_cast<cudaStream_t>(stream));
}

// The round polynomial's values at t = skip_t0..2 (t = 1, 2 with the claim
// trick). eq, x: (8, g * 2 * half); n_evals = 3 (degree 1 + 2); sums:
// (g, 4, 64) 64-bit scratch; out: (8, n_evals - skip_t0, g) canonical.
extern "C" int gkr_identity_partial_evals(const void* eq, const void* x, void* sums, void* out, int64_t half,
                                          int64_t g, int64_t bpg, int64_t n_evals, int64_t skip_t0,
                                          void* stream) {
  if (bad_geometry(half, g, bpg) || n_evals != 3) return static_cast<int>(cudaErrorInvalidValue);
  return deferred::identity_round(eq, x, sums, out, half, g, bpg, skip_t0 ? 1 : 0,
                                  static_cast<cudaStream_t>(stream));
}
