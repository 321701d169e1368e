// The fused scalar stage of one Gruen head round, in G independent lanes.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:gruen_round_scalar (kernel body
// _gruen_round_kernel). Per lane, from the round sums Q_0..Q_7 (already
// scaled by C(7, m)), alpha = 1 - q_k, beta = 2 q_k - 1, the eq prefix ck
// and q_k:
//   P_m = ck * (alpha Q_m + beta Q_{m-1}), m = 0..8 (Q_{-1} = Q_8 = 0);
//   r   = MimcHash(P_0, ..., P_8), canonical (the transcript challenge);
//   ck' = ck * eq1(q_k, r), eq1(q, r) = 1 - q - r + 2 q r.
// The values and the order of operations are those of the unfused stage
// (sumcheck/prover.py before the fusion, now ops/kernels.py
// gruen_round_scalar_plain), so P and ck' are the same bits as there.
//
// Replaces the TPU kernel gruen_round_scalar (call :1460), whose hash runs
// the S-box chain of fieldcore.pow7 on the MXU. Bound on the H100: the
// dependent chain, not bytes. A lane moves about 1 KB, but its hash is
// 9 words x 91 rounds = 819 dependent x^7 S-boxes on one element. Design:
// a pair of neighbouring threads per lane runs the combine, the chain and
// eq1 with everything in registers; the chain (csrc/mimc.cuh) is three
// products deep an S-box, the middle two one a thread, on the
// product-scanning fr::mul_fips. What the fusion removes is the host side:
// the unfused stage was ~40 small field ops, ~700 launches of plain torch
// kernels, per head round; this is one launch.
#include <cuda_runtime.h>

#include "mimc.cuh"

namespace {

constexpr int kThreads = 64;  // 32 lanes a block, two threads a lane
constexpr int kCoeffs = 8;  // Q_0..Q_7; P has kCoeffs + 1 words

__global__ void __launch_bounds__(kThreads)
    gruen_round_kernel(const int32_t* q, const int32_t* alpha, const int32_t* beta,
                       const int32_t* ck, const int32_t* qk, const int32_t* arks, int32_t* p_out,
                       int32_t* r_out, int32_t* ck_out, int64_t g) {
  const int64_t pair = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 1;
  const bool odd = threadIdx.x & 1;
  // threads past the last lane run lane g - 1 too (the S-box's shuffle
  // takes every thread of the warp) and store nothing
  const int64_t lane = pair < g ? pair : g - 1;
  const bool owner = pair < g && !odd;
  const fr::Fe a = fr::load(alpha, g, lane);
  const fr::Fe b = fr::load(beta, g, lane);
  const fr::Fe c = fr::load(ck, g, lane);
  fr::Fe state = fr::zero();
  fr::Fe beta_prev = fr::zero();  // beta * Q_{m-1}
  // Kept rolled: unrolling 9 words of the 91-round chain gives ptxas a
  // body of ~10^6 instructions.
#pragma unroll 1
  for (int m = 0; m <= kCoeffs; ++m) {
    fr::Fe alpha_cur = fr::zero();  // alpha * Q_m
    fr::Fe beta_cur = fr::zero();
    if (m < kCoeffs) {
      // q (8, 8, G): limb l of Q_m in lane g at l*8*G + m*G + g
      const fr::Fe qm = fr::load(q + m * g, kCoeffs * g, lane);
      alpha_cur = fr::mul(qm, a);
      beta_cur = fr::mul(qm, b);
    }
    // add of a zero term returns the other term's bits: P_0 and P_8 are
    // the same bits as the unfused stage's zero-padded sum
    const fr::Fe word = fr::mul(fr::add(alpha_cur, beta_prev), c);
    beta_prev = beta_cur;
    // p_out (8, 9, G)
    if (owner) fr::store(p_out + m * g, (kCoeffs + 1) * g, lane, word);
    state = mimc::update(state, word, arks, odd);
  }
  if (!owner) return;
  const fr::Fe r = fr::canonical(state);
  fr::store(r_out, g, lane, r);
  const fr::Fe qv = fr::load(qk, g, lane);
  const fr::Fe t = fr::mul(qv, r);
  const fr::Fe eq1 = fr::add(fr::sub(fr::sub(fr::one(), qv), r), fr::add(t, t));
  fr::store(ck_out, g, lane, fr::mul(c, eq1));
}

}  // namespace

// q: (8, 8, g); alpha, beta, ck, qk: (8, g); arks: (91, 8) Montgomery rows.
// p_out: (8, 9, g) lazy; r_out: (8, g) canonical; ck_out: (8, g) lazy.
extern "C" int gkr_gruen_round(const void* q, const void* alpha, const void* beta, const void* ck,
                               const void* qk, const void* arks, void* p_out, void* r_out,
                               void* ck_out, int64_t g, void* stream) {
  if (g <= 0) return 0;
  const int64_t blocks = (2 * g + kThreads - 1) / kThreads;
  gruen_round_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(alpha),
      static_cast<const int32_t*>(beta), static_cast<const int32_t*>(ck),
      static_cast<const int32_t*>(qk), static_cast<const int32_t*>(arks),
      static_cast<int32_t*>(p_out), static_cast<int32_t*>(r_out), static_cast<int32_t*>(ck_out), g);
  return static_cast<int>(cudaGetLastError());
}
