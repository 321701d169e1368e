// MiMC witness: all cipher-layer tables of the MiMC GKR circuit in one launch.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:mimc_witness. On the TPU the round
// axis rides a sequential grid dimension with the running state in VMEM
// scratch; here that axis is a loop inside the thread, with the state in
// registers: s_{r+1} = (s_r + block + ark_r)^7, s_0 = state.
//
// Bound on the H100: the output, rounds * 32 B per element (91 tables,
// 12 GB at 2^22 elements), written once; the 4 Montgomery products per
// round are ~1.5 G products at 2^22. Design: one thread per element, reads
// block and state once, keeps s in registers for every round and writes
// each round's limbs coalesced (neighbouring threads, neighbouring
// addresses). The round constants are broadcast loads through the cache.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    witness_kernel(const int32_t* block, const int32_t* state, const int32_t* arks,
                   int32_t* out, int64_t n, int64_t rounds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const fr::Fe b = fr::load(block, n, i);
  fr::Fe s = fr::load(state, n, i);
  for (int64_t r = 0; r < rounds; ++r) {
    const fr::Fe ark = fr::load(arks + r * fr::L, 1, 0);
    s = fr::pow7(fr::add(fr::add(s, b), ark));
    fr::store(out + r * fr::L * n, n, i, s);
  }
}

}  // namespace

// block, state: (8, n); arks: (rounds, 8) Montgomery rows; out: (rounds, 8, n).
extern "C" int gkr_witness(const void* block, const void* state, const void* arks, void* out,
                           int64_t n, int64_t rounds, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  witness_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(block), static_cast<const int32_t*>(state),
      static_cast<const int32_t*>(arks), static_cast<int32_t*>(out), n, rounds);
  return static_cast<int>(cudaGetLastError());
}
