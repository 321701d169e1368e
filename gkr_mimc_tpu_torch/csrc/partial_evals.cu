// Sumcheck round sums in evaluation form: the round polynomial at
// t = 0..n_evals-1 (or 1..n_evals-1 with the claim trick, where the caller
// derives P(0) = claim - P(1)).
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_partial_evals and
// identity_partial_evals (G = 1), and cipher_partial_evals_g and
// identity_partial_evals_g (G lanes, via _pe_call_g); one kernel each
// serves every G, since (8, G, n) grouped tables are the same memory as
// group-major (8, G * n). On the TPU the column sums ride in the output
// block across a sequential grid and a wide REDC finishes them; here pass 1
// writes one partial per block and pass 2 sums them (csrc/reduce.cuh).
//
// Per half-cube point the restriction of each table to the round's
// variable is walked along t by adds: a_0 = a[bot], a_1 = a[top],
// a_t = a_(t-1) + (a[top] - a[bot]), the same order as the plain twin.
//
// Bound on the H100: integer multiply throughput. The cipher round does
// (4 + 1) Montgomery products per t (the S-box x^7 and the eq weight),
// 40 or 45 per point against 192 B read; the identity round 2 or 3 per
// point against 128 B, about as many bytes as products, so it sits near
// the byte bound. Design: one thread per point in a grid-stride loop, the
// n_out running sums in registers (t unrolled at compile time), a block
// reduction and a second launch over the partials.
//
// The kernel is a template over its multiply and its block size: the
// production instantiation is fr::mul at 256 threads. A second entry,
// gkr_cipher_partial_evals_ptx, runs the cipher round on fr::mul_ptx at
// 128, 256 or 512 threads for the multiply A/B probe (ops/probes.py, the
// counterpart of scripts/micro_pe_mxu.py, which runs the TPU kernel with
// its other multiply). That entry is compiled from this file by
// csrc/partial_evals_ptx.cu (GKR_PARTIAL_EVALS_PTX defined), so its three
// large instantiations build in parallel with the production ones.
#include <cuda_runtime.h>

#include "fr.cuh"
#include "reduce.cuh"

namespace {

using rsum::kThreads;

// The multiplies a round can run on: the product and the S-box x^7.
struct MulStd {
  __device__ __forceinline__ static fr::Fe mul(const fr::Fe& a, const fr::Fe& b) { return fr::mul(a, b); }
  __device__ __forceinline__ static fr::Fe pow7(const fr::Fe& x) { return fr::pow7(x); }
};
struct MulPtx {
  __device__ __forceinline__ static fr::Fe mul(const fr::Fe& a, const fr::Fe& b) { return fr::mul_ptx(a, b); }
  __device__ __forceinline__ static fr::Fe pow7(const fr::Fe& x) {
    const fr::Fe x2 = fr::mul_ptx(x, x);
    const fr::Fe x3 = fr::mul_ptx(x2, x);
    const fr::Fe x6 = fr::mul_ptx(x3, x3);
    return fr::mul_ptx(x6, x);
  }
};

// Pass 1: acc[col] += eq_t * gate(x0_t, x1_t) at t = T0 + col, where the
// gate is (x0 + x1 + ark)^7 (CIPHER) or x0 (identity; x1 unused).
template <int NOUT, int T0, bool CIPHER, int THREADS = kThreads, typename Mul = MulStd>
__global__ void __launch_bounds__(THREADS)
    partial_evals_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1,
                         const int32_t* ark, int32_t* partial, int64_t half, int64_t g,
                         int64_t bpg) {
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const fr::Fe a = CIPHER ? fr::load(ark, g, grp) : fr::zero();
  fr::Fe acc[NOUT];
#pragma unroll
  for (int c = 0; c < NOUT; ++c) acc[c] = fr::zero();
  for (int64_t y = bi * THREADS + threadIdx.x; y < half; y += bpg * THREADS) {
    const int64_t bot = grp * 2 * half + y;
    const fr::Fe eb = fr::load(eq, n_x, bot), et = fr::load(eq, n_x, bot + half);
    const fr::Fe ub = fr::load(x0, n_x, bot), ut = fr::load(x0, n_x, bot + half);
    fr::Fe wb = fr::zero(), wt = fr::zero();
    if (CIPHER) {
      wb = fr::load(x1, n_x, bot);
      wt = fr::load(x1, n_x, bot + half);
    }
    const fr::Fe de = fr::sub(et, eb), du = fr::sub(ut, ub), dw = fr::sub(wt, wb);
    fr::Fe e = eb, u = ub, w = wb;
#pragma unroll
    for (int c = 0; c < NOUT; ++c) {
      const int t = T0 + c;
      if (t == 1) {
        e = et;
        u = ut;
        w = wt;
      } else if (t > 1) {
        e = fr::add(e, de);
        u = fr::add(u, du);
        if (CIPHER) w = fr::add(w, dw);
      }
      const fr::Fe gate = CIPHER ? Mul::pow7(fr::add(fr::add(w, a), u)) : u;
      acc[c] = fr::add(acc[c], Mul::mul(e, gate));
    }
  }
  rsum::store_partial<NOUT, THREADS>(partial, acc);
}

template <int NOUT, int T0, bool CIPHER, int THREADS = kThreads, typename Mul = MulStd>
int launch(const void* eq, const void* x0, const void* x1, const void* ark, void* partial,
           void* out, int64_t half, int64_t g, int64_t bpg, cudaStream_t st) {
  partial_evals_kernel<NOUT, T0, CIPHER, THREADS, Mul>
      <<<static_cast<unsigned>(g * bpg), THREADS, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<NOUT>(partial, out, g, bpg, st);
}

bool bad_geometry(int64_t half, int64_t g, int64_t bpg) { return half <= 0 || g <= 0 || bpg <= 0; }

}  // namespace

#ifndef GKR_PARTIAL_EVALS_PTX

// eq, x0, x1: (8, g * 2 * half); ark: (8, g); n_evals = 9 (degree 7 + 2);
// partial: (g * bpg, n_out, 8) scratch; out: (8, n_out, g) with
// n_out = n_evals - skip_t0.
extern "C" int gkr_cipher_partial_evals(const void* eq, const void* x0, const void* x1,
                                        const void* ark, void* partial, void* out, int64_t half,
                                        int64_t g, int64_t bpg, int64_t n_evals, int64_t skip_t0,
                                        void* stream) {
  if (bad_geometry(half, g, bpg) || n_evals != 9) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skip_t0) return launch<8, 1, true>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
  return launch<9, 0, true>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
}

// eq, x: (8, g * 2 * half); n_evals = 3 (degree 1 + 2); partial:
// (g * bpg, n_out, 8) scratch; out: (8, n_out, g).
extern "C" int gkr_identity_partial_evals(const void* eq, const void* x, void* partial, void* out,
                                          int64_t half, int64_t g, int64_t bpg, int64_t n_evals,
                                          int64_t skip_t0, void* stream) {
  if (bad_geometry(half, g, bpg) || n_evals != 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skip_t0) return launch<2, 1, false>(eq, x, nullptr, nullptr, partial, out, half, g, bpg, st);
  return launch<3, 0, false>(eq, x, nullptr, nullptr, partial, out, half, g, bpg, st);
}

#else

// The cipher round of gkr_cipher_partial_evals at t = 0..8 (9 evaluations,
// no claim trick) on fr::mul_ptx, at `threads` = 128, 256 or 512 a block:
// the multiply A/B probe only, never the prover's path. Arguments and
// output as gkr_cipher_partial_evals.
extern "C" int gkr_cipher_partial_evals_ptx(const void* eq, const void* x0, const void* x1,
                                            const void* ark, void* partial, void* out, int64_t half,
                                            int64_t g, int64_t bpg, int64_t threads, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128: return launch<9, 0, true, 128, MulPtx>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    case 256: return launch<9, 0, true, 256, MulPtx>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    case 512: return launch<9, 0, true, 512, MulPtx>(eq, x0, x1, ark, partial, out, half, g, bpg, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // GKR_PARTIAL_EVALS_PTX
