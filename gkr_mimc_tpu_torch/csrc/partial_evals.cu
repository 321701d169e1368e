// The multiply A/B probe of ops/probes.py (cipher_pe_variant, the
// counterpart of scripts/micro_pe_mxu.py, which runs the TPU's
// evaluation-form cipher kernel with its other multiply): the cipher
// round's sums at t = 0..8, one t at a time, on fr::mul_ptx, at 128, 256
// or 512 threads a block. This file serves that probe only; no prover path
// runs it. The production rounds in evaluation form, cipher and identity,
// are the deferred contractions of csrc/round_acc.cu evaluated at t in
// their finishers. It stays a source of its own, so that its three large
// instantiations build in parallel with the other kernels.
//
// Per half-cube point the restriction of each table to the round's
// variable is walked along t by adds: a_0 = a[bot], a_1 = a[top],
// a_t = a_(t-1) + (a[top] - a[bot]), the same order as the plain version
// (ops/kernels.py cipher_evals_per_t). At each t the gate
// (x0 + x1 + ark)^7 costs 4 products and its eq weight one. Design: one
// thread per point in a grid-stride loop, the 9 running sums in registers,
// a block reduction and a second launch over the partials
// (csrc/reduce.cuh).
#include <cuda_runtime.h>

#include "fr.cuh"
#include "reduce.cuh"

namespace {

constexpr int kEvals = 9;  // the cipher gate's degree 7, plus 2

__device__ __forceinline__ fr::Fe pow7_ptx(const fr::Fe& x) {
  const fr::Fe x2 = fr::mul_ptx(x, x);
  const fr::Fe x3 = fr::mul_ptx(x2, x);
  const fr::Fe x6 = fr::mul_ptx(x3, x3);
  return fr::mul_ptx(x6, x);
}

// Pass 1: acc[t] += eq_t * (x0_t + x1_t + ark)^7, t = 0..8.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    partial_evals_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1, const int32_t* ark,
                         int32_t* partial, int64_t half, int64_t g, int64_t bpg) {
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const fr::Fe a = fr::load(ark, g, grp);
  fr::Fe acc[kEvals];
#pragma unroll
  for (int c = 0; c < kEvals; ++c) acc[c] = fr::zero();
  for (int64_t y = bi * THREADS + threadIdx.x; y < half; y += bpg * THREADS) {
    const int64_t bot = grp * 2 * half + y;
    const fr::Fe eb = fr::load(eq, n_x, bot), et = fr::load(eq, n_x, bot + half);
    const fr::Fe ub = fr::load(x0, n_x, bot), ut = fr::load(x0, n_x, bot + half);
    const fr::Fe wb = fr::load(x1, n_x, bot), wt = fr::load(x1, n_x, bot + half);
    const fr::Fe de = fr::sub(et, eb), du = fr::sub(ut, ub), dw = fr::sub(wt, wb);
    fr::Fe e = eb, u = ub, w = wb;
#pragma unroll
    for (int t = 0; t < kEvals; ++t) {
      if (t == 1) {
        e = et;
        u = ut;
        w = wt;
      } else if (t > 1) {
        e = fr::add(e, de);
        u = fr::add(u, du);
        w = fr::add(w, dw);
      }
      acc[t] = fr::add(acc[t], fr::mul_ptx(e, pow7_ptx(fr::add(fr::add(w, a), u))));
    }
  }
  rsum::store_partial<kEvals, THREADS>(partial, acc);
}

template <int THREADS>
int launch(const void* eq, const void* x0, const void* x1, const void* ark, void* partial, void* out,
           int64_t half, int64_t g, int64_t bpg, cudaStream_t st) {
  partial_evals_kernel<THREADS><<<static_cast<unsigned>(g * bpg), THREADS, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const int32_t*>(ark), static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<kEvals>(partial, out, g, bpg, st);
}

}  // namespace

// The cipher round in evaluation form at t = 0..8 (9 evaluations, no
// claim trick), 5 products a t, on fr::mul_ptx, at `threads` = 128, 256
// or 512 a block: the multiply A/B probe only, never the prover's path.
// eq, x0, x1: (8, g * 2 * half); ark: (8, g); partial: (g * bpg, 9, 8)
// scratch; out: (8, 9, g), the sums lazy (below 2p).
extern "C" int gkr_cipher_partial_evals_ptx(const void* eq, const void* x0, const void* x1, const void* ark,
                                            void* partial, void* out, int64_t half, int64_t g, int64_t bpg,
                                            int64_t threads, void* stream) {
  if (half <= 0 || g <= 0 || bpg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128: return launch<128>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    case 256: return launch<256>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    case 512: return launch<512>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
