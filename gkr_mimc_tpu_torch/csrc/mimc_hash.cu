// MimcHash of K field elements in G independent lanes.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:mimc_hash_fs (G = 1, the Fiat-Shamir
// transcript hash of every sumcheck round) and
// gkr_mimc_tpu/ops/kernels.py:mimc_hash_fs_g (G lanes in lockstep, the
// verifier's batched challenge recompute). Semantics
// (gkr_mimc_tpu/hashes/mimc.py:29-49, 75-78): state starts at 0; for each
// word, res = word, then 91 rounds of res = (res + state + ark_i)^7, then
// state = res + 2 * state + word. The output is canonical (< p).
//
// Bound on the H100: latency. A 9-word hash is 819 dependent x^7 S-boxes
// on one element; nothing in a lane runs in parallel but the two middle
// products of each S-box. Design: a pair of neighbouring threads per lane
// runs the whole K * 91 chain with state and word in registers
// (csrc/mimc.cuh: three products deep, the middle two one a thread), so G
// lanes cost the time of one until the card is full. Unlike the TPU
// kernel's 128-column message block there is no cap on K.
#include <cuda_runtime.h>

#include "mimc.cuh"

namespace {

constexpr int kThreads = 64;  // 32 lanes a block, two threads a lane

__global__ void __launch_bounds__(kThreads)
    mimc_hash_kernel(const int32_t* msgs, const int32_t* arks, int32_t* out, int64_t k,
                     int64_t g) {
  const int64_t pair = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 1;
  const bool odd = threadIdx.x & 1;
  // threads past the last lane run lane g - 1's chain too: the S-box's
  // shuffle takes every thread of the warp
  const int64_t lane = pair < g ? pair : g - 1;
  fr::Fe state = fr::zero();
#pragma unroll 1
  for (int64_t w = 0; w < k; ++w) {
    // msgs (8, K, G): limb l of word w in lane g at l*K*G + w*G + g
    state = mimc::update(state, fr::load(msgs + w * g, k * g, lane), arks, odd);
  }
  if (pair < g && !odd) fr::store(out, g, lane, fr::canonical(state));
}

}  // namespace

// msgs: (8, k, g); arks: (91, 8) Montgomery rows; out: (8, g) canonical.
extern "C" int gkr_mimc_hash(const void* msgs, const void* arks, void* out, int64_t k, int64_t g,
                             void* stream) {
  if (g <= 0) return 0;
  const int64_t blocks = (2 * g + kThreads - 1) / kThreads;
  mimc_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(msgs),
                                                          static_cast<const int32_t*>(arks),
                                                          static_cast<int32_t*>(out), k, g);
  return static_cast<int>(cudaGetLastError());
}
