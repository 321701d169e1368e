// Sumcheck round accumulators: the hypercube sums of one round, returned as
// the round's field values.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (with its XLA
// finisher finish_gruen_acc) and gkr_mimc_tpu/ops/kernels.py:
// identity_coeff_acc (with finish_coeff_acc). On the TPU the sum is carried
// in the output block across sequential grid steps and finished by a wide
// REDC outside the kernel; here blocks run in no order, so pass 1 writes
// one partial per block and pass 2 reduces the partials of each group.
// Field addition mod 2p is exact, so any reduction order gives the same
// bits; no float and no atomics touch a field value.
//
// Bound on the H100: integer multiply throughput. The cipher round does
// 9 + 8 + 8 = 25 Montgomery products per half-cube point against 96 B
// read. Design: one thread per point in a grid-stride loop, the 8 (or 3)
// running sums in registers, a warp-shuffle then shared-memory reduction
// per block, and a second small launch over the partials that also applies
// the binomial constants C(7, m), so no finisher is needed.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Sum of acc over the block; valid in thread 0. Every thread must call it.
template <int NS>
__device__ __forceinline__ void block_reduce(fr::Fe (&acc)[NS]) {
  __shared__ uint32_t part[kWarps][NS][fr::L];
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
      for (int l = 0; l < fr::L; ++l) acc[s].v[l] = lane < kWarps ? part[lane][s][l] : 0u;
    warp_reduce<NS>(acc);
  }
}

template <int NS>
__device__ __forceinline__ void store_partial(int32_t* partial, const fr::Fe (&acc)[NS]) {
  if (threadIdx.x != 0) return;
  const int64_t b = blockIdx.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) fr::store(partial + (b * NS + s) * fr::L, 1, 0, acc[s]);
}

// Pass 1 of the Gruen cipher round. Per point y of group grp's half cube:
// u = x0[y] + x1[y] + ark, v = x0[y + half] + x1[y + half] + ark - u, and
// acc[m] += S[y] * u^(7-m) v^m, m = 0..7.
__global__ void __launch_bounds__(kThreads)
    gruen_acc_kernel(const int32_t* s, const int32_t* x0, const int32_t* x1, const int32_t* ark,
                     int32_t* partial, int64_t half, int64_t g, int64_t bpg) {
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const int64_t n_s = g * half;
  const fr::Fe a = fr::load(ark, g, grp);
  fr::Fe acc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m] = fr::zero();
  for (int64_t y = bi * kThreads + threadIdx.x; y < half; y += bpg * kThreads) {
    const int64_t bot = grp * 2 * half + y;
    const fr::Fe u = fr::add(fr::add(fr::load(x0, n_x, bot), fr::load(x1, n_x, bot)), a);
    const fr::Fe top =
        fr::add(fr::add(fr::load(x0, n_x, bot + half), fr::load(x1, n_x, bot + half)), a);
    const fr::Fe v = fr::sub(top, u);
    const fr::Fe w = fr::load(s, n_s, grp * half + y);
    // the product chain shared with the plain twin (ops/kernels.py)
    const fr::Fe u2 = fr::mul(u, u);
    const fr::Fe u3 = fr::mul(u2, u);
    const fr::Fe u6 = fr::mul(u3, u3);
    const fr::Fe v2 = fr::mul(v, v);
    const fr::Fe v3 = fr::mul(v2, v);
    const fr::Fe v6 = fr::mul(v3, v3);
    const fr::Fe uv = fr::mul(u, v);
    const fr::Fe uv2 = fr::mul(uv, uv);
    const fr::Fe uv3 = fr::mul(uv, uv2);
    acc[0] = fr::add(acc[0], fr::mul(w, fr::mul(u6, u)));
    acc[1] = fr::add(acc[1], fr::mul(w, fr::mul(u6, v)));
    acc[2] = fr::add(acc[2], fr::mul(w, fr::mul(uv2, u3)));
    acc[3] = fr::add(acc[3], fr::mul(w, fr::mul(uv3, u)));
    acc[4] = fr::add(acc[4], fr::mul(w, fr::mul(uv3, v)));
    acc[5] = fr::add(acc[5], fr::mul(w, fr::mul(uv2, v3)));
    acc[6] = fr::add(acc[6], fr::mul(w, fr::mul(v6, u)));
    acc[7] = fr::add(acc[7], fr::mul(w, fr::mul(v6, v)));
  }
  block_reduce<8>(acc);
  store_partial<8>(partial, acc);
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
  block_reduce<3>(acc);
  store_partial<3>(partial, acc);
}

// Pass 2: one block per group sums its bpg partials; sum s is multiplied by
// scale[s] (Montgomery rows) when scale is given. out: (8, NS, g).
template <int NS>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const int32_t* partial, const int32_t* scale, int32_t* out, int64_t g,
                  int64_t bpg) {
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
    const fr::Fe r = scale ? fr::mul(acc[s], fr::load(scale + s * fr::L, 1, 0)) : acc[s];
    fr::store(out + s * g, NS * g, grp, r);
  }
}

}  // namespace

// s: (8, g * half); x0, x1: (8, g * 2 * half); ark: (g) as (8, g);
// binom: (8, 8) rows C(7, m) in Montgomery form; partial: (g * bpg, 8, 8)
// scratch; out: (8, 8, g).
extern "C" int gkr_gruen_acc(const void* s, const void* x0, const void* x1, const void* ark,
                             const void* binom, void* partial, void* out, int64_t half, int64_t g,
                             int64_t bpg, void* stream) {
  if (half <= 0 || g <= 0 || bpg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gruen_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<8><<<static_cast<unsigned>(g), kThreads, 0, st>>>(
      static_cast<const int32_t*>(partial), static_cast<const int32_t*>(binom),
      static_cast<int32_t*>(out), g, bpg);
  return static_cast<int>(cudaGetLastError());
}

// eq, x: (8, g * 2 * half); partial: (g * bpg, 3, 8) scratch; out: (8, 3, g).
extern "C" int gkr_identity_acc(const void* eq, const void* x, void* partial, void* out,
                                int64_t half, int64_t g, int64_t bpg, void* stream) {
  if (half <= 0 || g <= 0 || bpg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  identity_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(partial), half, g, bpg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<3><<<static_cast<unsigned>(g), kThreads, 0, st>>>(
      static_cast<const int32_t*>(partial), nullptr, static_cast<int32_t*>(out), g, bpg);
  return static_cast<int>(cudaGetLastError());
}
