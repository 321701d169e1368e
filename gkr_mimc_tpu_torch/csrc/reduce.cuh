// Block reductions of field sums, for the per-t cipher kernel of the
// multiply probe (csrc/partial_evals.cu); the prover's round kernels sum
// integers instead (csrc/round_acc.cu, namespace deferred).
//
// A round kernel sums NS field values over a group's half hypercube. Pass 1
// runs one thread per point in a grid-stride loop with the NS running sums
// in registers, reduces them over the block (warp shuffles, then shared
// memory) and writes one partial per block; pass 2 (finish_kernel) sums the
// partials of each group. Field addition mod 2p is exact, so any reduction
// order gives the same bits; no float and no atomics touch a field value.
#pragma once

#include <cuda_runtime.h>

#include "fr.cuh"

namespace rsum {
namespace {  // internal linkage: each source that includes this gets its own copy

constexpr int kThreads = 256;

template <int NS>
__device__ __forceinline__ void warp_reduce(fr::Fe (&acc)[NS]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      fr::Fe o;
#pragma unroll
      for (int l = 0; l < fr::L; ++l) o.v[l] = __shfl_down_sync(0xffffffffu, acc[s].v[l], off);
      acc[s] = fr::add(acc[s], o);
    }
  }
}

// Sum of acc over a block of THREADS threads; valid in thread 0. Every
// thread must call it.
template <int NS, int THREADS = kThreads>
__device__ __forceinline__ void block_reduce(fr::Fe (&acc)[NS]) {
  constexpr int kBlockWarps = THREADS / 32;
  __shared__ uint32_t part[kBlockWarps][NS][fr::L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce<NS>(acc);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int l = 0; l < fr::L; ++l) part[warp][s][l] = acc[s].v[l];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int l = 0; l < fr::L; ++l) acc[s].v[l] = lane < kBlockWarps ? part[lane][s][l] : 0u;
    warp_reduce<NS>(acc);
  }
}

// Block reduce, then thread 0 writes the block's NS sums to
// partial[blockIdx.x] ((blocks, NS, 8) scratch).
template <int NS, int THREADS = kThreads>
__device__ __forceinline__ void store_partial(int32_t* partial, fr::Fe (&acc)[NS]) {
  block_reduce<NS, THREADS>(acc);
  if (threadIdx.x != 0) return;
  const int64_t b = blockIdx.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) fr::store(partial + (b * NS + s) * fr::L, 1, 0, acc[s]);
}

// Pass 2: one block per group sums its bpg partials. out: (8, NS, g).
template <int NS>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const int32_t* partial, int32_t* out, int64_t g, int64_t bpg) {
  const int64_t grp = blockIdx.x;
  fr::Fe acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = fr::zero();
  for (int64_t b = threadIdx.x; b < bpg; b += kThreads) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      acc[s] = fr::add(acc[s], fr::load(partial + ((grp * bpg + b) * NS + s) * fr::L, 1, 0));
  }
  block_reduce<NS>(acc);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    fr::store(out + s * g, NS * g, grp, acc[s]);
  }
}

// Launch pass 2 after a pass 1 on `st`; returns the first launch error.
template <int NS>
inline int finish(const void* partial, void* out, int64_t g, int64_t bpg,
                  cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<NS><<<static_cast<unsigned>(g), kThreads, 0, st>>>(
      static_cast<const int32_t*>(partial), static_cast<int32_t*>(out), g, bpg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace rsum
