// Every tail round of a cipher or identity sumcheck layer in one launch.
//
// Replaces the reference's tail program, gkr_mimc_tpu/sumcheck/prover.py
// _tail_body (:559): once a layer's tables hold at most 2^tail_bits entries,
// it runs all remaining rounds as one fixed-shape masked lax.scan, each
// round evaluating the gate (ops/kernels.py cipher_layer :89, call :93),
// interpolating, hashing the coefficients (mimc_hash_fs :253, call :269) and
// folding. Per lane and round j = 0..s-1 on tables of n = m / 2^j entries
// (E = d + 2 evaluations, d the gate's degree):
//   a_t = a_bot + t (a_top - a_bot) for every table, t = 0..E-1 (the adds
//         of ops/kernels.py stack_t);
//   P(t) = sum over the n/2 pairs of eq_t * gate(x_t), the cipher gate
//         ((x1_t + ark) + x0_t)^7 (csrc/sbox.cu's operand order) or the
//         identity x0_t;
//   c    = the Lagrange matrix (poly/lagrange.py) applied to P(0..E-1);
//   r    = MimcHash(c_0..c_(E-1)), canonical;
//   every table folds: bot + r (top - bot).
// After the last round the tables hold one entry each: the final values.
// Every value is the residue mod 2p (or, for a product, the REDC) that the
// plain twin computes, so the outputs are its bits: field sums are exact
// mod 2p in any order, and every product sees the twin's representatives.
//
// Bound on the H100: latency. A round's work is a few thousand products
// (at m = 2^8 on the cipher gate: 128 pairs x 9 points x 5, then 81 for
// the interpolation), microseconds at the card's rate, but each round
// waits for its challenge: 9 words x 91 dependent S-boxes, ~1.5 ms
// (csrc/mimc.cuh). The floor of a layer's tail is its s hashes.
//
// Design: one block a lane, 256 threads. The 1 + K tables are loaded once
// into shared memory, limb-major, and fold in place, halving (no mask, no
// stale half carried). A round: thread (t, j) of E groups of 256 / E
// threads sums pairs j, j + 256/E, ... at point t; one thread a point adds
// its group's partials; E^2 threads form the interpolation products and E
// threads add them into the coefficients; warp 0 hashes them with the
// chain of csrc/mimc.cuh (all 16 pairs of the warp on the same chain); the
// challenge goes out through shared memory and every thread folds its
// share of the tables. What the kernel removes is the host side: the eager
// rounds it replaces launched ~1,400 small kernels each.
#include <cuda_runtime.h>

#include "mimc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLog = 10;  // m <= 2^10: (1 + K) * m * 32 B of tables, 96 KB at most

// tables (1 + K, 8, m) | partial sums (8, kThreads) | coefficients (8, E) | challenge (8)
template <int K>
constexpr int64_t shared_bytes(int64_t m) {
  constexpr int E = K == 2 ? 9 : 3;
  return 4 * (fr::L * ((1 + K) * m + kThreads + E + 1));
}

// K = 2: the cipher gate over (x0, x1); K = 1: the identity gate over x0.
template <int K>
__global__ void __launch_bounds__(kThreads)
    tail_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1, const int32_t* ark,
                const int32_t* lag, const int32_t* arks, int32_t* coeffs_out, int32_t* rs_out,
                int32_t* finals_out, int m, int64_t g) {
  constexpr int T = 1 + K;           // tables
  constexpr int E = K == 2 ? 9 : 3;  // evaluations a round: degree + 2
  constexpr int kPer = kThreads / E;  // threads a point t
  extern __shared__ int32_t smem[];
  int32_t* tab = smem;                         // (T, 8, m)
  int32_t* part = tab + T * fr::L * m;         // (8, kThreads)
  int32_t* co = part + fr::L * kThreads;       // (8, E)
  int32_t* rr = co + fr::L * E;                // (8,)
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;

  // tables (8, G, m) group-major -> this lane's (8, m) rows
  const int32_t* src[3] = {eq, x0, x1};
#pragma unroll
  for (int q = 0; q < T; ++q)
    for (int idx = tid; idx < fr::L * m; idx += kThreads) {
      const int l = idx / m, i = idx % m;
      tab[q * fr::L * m + idx] = src[q][(l * g + lane) * m + i];
    }
  fr::Fe a = fr::zero();
  if constexpr (K == 2) a = fr::load(ark, 1, 0);

  int round = 0;
  for (int n = m; n > 1; n >>= 1, ++round) {
    const int half = n >> 1;
    __syncthreads();  // the tables as the last fold left them
    // 1. gate sums: thread (t, j) sums pairs j, j + kPer, ... at point t
    const int t = tid / kPer, j = tid % kPer;
    fr::Fe acc = fr::zero();
    if (t < E) {
      for (int i = j; i < half; i += kPer) {
        fr::Fe v[T];
#pragma unroll
        for (int q = 0; q < T; ++q) {
          const fr::Fe bot = fr::load(tab + q * fr::L * m, m, i);
          const fr::Fe d = fr::sub(fr::load(tab + q * fr::L * m, m, i + half), bot);
          v[q] = bot;
          for (int u = 0; u < t; ++u) v[q] = fr::add(v[q], d);
        }
        fr::Fe gate = v[1];
        if constexpr (K == 2) gate = fr::pow7(fr::add(fr::add(v[K], a), v[1]));
        acc = fr::add(acc, fr::mul(v[0], gate));
      }
    }
    fr::store(part, kThreads, tid, acc);
    __syncthreads();
    // thread t < E: P(t), the sum of its group's partials (into co, for now)
    if (tid < E) {
      fr::Fe sum = fr::load(part, kThreads, tid * kPer);
      for (int q = 1; q < kPer; ++q) sum = fr::add(sum, fr::load(part, kThreads, tid * kPer + q));
      fr::store(co, E, tid, sum);
    }
    __syncthreads();
    // 2. interpolation: thread i * E + c forms P(i) lag[i][c]; thread c adds them
    if (tid < E * E) {
      const int i = tid / E, c = tid % E;
      fr::store(part, kThreads, tid, fr::mul(fr::load(co, E, i), fr::load(lag, E * E, i * E + c)));
    }
    __syncthreads();
    if (tid < E) {
      fr::Fe c = fr::load(part, kThreads, tid);
      for (int i = 1; i < E; ++i) c = fr::add(c, fr::load(part, kThreads, i * E + tid));
      fr::store(co, E, tid, c);
      // coeffs_out (s, 8, E, G)
      fr::store(coeffs_out + round * fr::L * E * g, E * g, tid * g + lane, c);
    }
    __syncthreads();
    // 3. the challenge: warp 0, every pair on the same chain
    if (tid < 32) {
      fr::Fe state = fr::zero();
#pragma unroll 1
      for (int w = 0; w < E; ++w) state = mimc::update(state, fr::load(co, E, w), arks, tid & 1);
      if (tid == 0) {
        const fr::Fe r = fr::canonical(state);
        fr::store(rr, 1, 0, r);
        fr::store(rs_out + round * fr::L * g, g, lane, r);  // rs_out (s, 8, G)
      }
    }
    __syncthreads();
    // 4. fold every table in place: entry i <- bot + r (top - bot); only
    // this thread reads entry i, and entries i + half are not written
    const fr::Fe r = fr::load(rr, 1, 0);
    for (int idx = tid; idx < T * half; idx += kThreads) {
      const int q = idx / half, i = idx % half;
      int32_t* base = tab + q * fr::L * m;
      const fr::Fe bot = fr::load(base, m, i);
      fr::store(base, m, i, fr::add(bot, fr::mul(fr::sub(fr::load(base, m, i + half), bot), r)));
    }
  }
  __syncthreads();
  if (tid < T) fr::store(finals_out + tid * fr::L * g, g, lane, fr::load(tab + tid * fr::L * m, m, 0));
}

template <int K>
int launch(const void* eq, const void* x0, const void* x1, const void* ark, const void* lag,
           const void* arks, void* coeffs, void* rs, void* finals, int64_t m, int64_t g,
           cudaStream_t stream) {
  const int64_t bytes = shared_bytes<K>(m);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_kernel<K><<<static_cast<unsigned>(g), kThreads, bytes, stream>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const int32_t*>(ark), static_cast<const int32_t*>(lag), static_cast<const int32_t*>(arks),
      static_cast<int32_t*>(coeffs), static_cast<int32_t*>(rs), static_cast<int32_t*>(finals),
      static_cast<int>(m), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k = 2 (cipher gate: x0, x1, ark (8,)) or 1 (identity gate: x0; x1 and
// ark unused). eq, x0, x1: (8, g, m), 2 <= m <= 2^10 a power of two; lag:
// (8, E, E) Montgomery Lagrange matrix (E = 9 or 3); arks: (91, 8)
// Montgomery rows. Outputs: coeffs (s, 8, E, g), rs (s, 8, g) canonical,
// finals (1 + k, 8, g), s = log2(m).
extern "C" int gkr_tail_rounds(const void* eq, const void* x0, const void* x1, const void* ark,
                               const void* lag, const void* arks, void* coeffs, void* rs, void* finals,
                               int64_t m, int64_t g, int64_t k, void* stream) {
  if (m < 2 || m > (1 << kMaxLog) || (m & (m - 1)) || g < 1 || (k != 1 && k != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k == 2 ? launch<2>(eq, x0, x1, ark, lag, arks, coeffs, rs, finals, m, g, s)
                : launch<1>(eq, x0, x1, ark, lag, arks, coeffs, rs, finals, m, g, s);
}
