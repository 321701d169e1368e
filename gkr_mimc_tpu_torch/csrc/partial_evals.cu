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
#include <cuda_runtime.h>

#include "fr.cuh"
#include "reduce.cuh"

namespace {

using rsum::kThreads;

// Pass 1: acc[col] += eq_t * gate(x0_t, x1_t) at t = T0 + col, where the
// gate is (x0 + x1 + ark)^7 (CIPHER) or x0 (identity; x1 unused).
template <int NOUT, int T0, bool CIPHER>
__global__ void __launch_bounds__(kThreads)
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
  for (int64_t y = bi * kThreads + threadIdx.x; y < half; y += bpg * kThreads) {
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
      const fr::Fe gate = CIPHER ? fr::pow7(fr::add(fr::add(w, a), u)) : u;
      acc[c] = fr::add(acc[c], fr::mul(e, gate));
    }
  }
  rsum::store_partial<NOUT>(partial, acc);
}

template <int NOUT, int T0, bool CIPHER>
int launch(const void* eq, const void* x0, const void* x1, const void* ark, void* partial,
           void* out, int64_t half, int64_t g, int64_t bpg, cudaStream_t st) {
  partial_evals_kernel<NOUT, T0, CIPHER><<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<NOUT>(partial, nullptr, out, g, bpg, st);
}

bool bad_geometry(int64_t half, int64_t g, int64_t bpg) { return half <= 0 || g <= 0 || bpg <= 0; }

}  // namespace

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
