// Sumcheck round accumulators in coefficient form: the hypercube sums of
// one round, returned as the round's field values.
//
// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_gruen_acc (with its XLA
// finisher finish_gruen_acc), gkr_mimc_tpu/ops/kernels.py:cipher_coeff_acc
// and gkr_mimc_tpu/ops/kernels.py:identity_coeff_acc (both with
// finish_coeff_acc). On the TPU the sum is carried in the output block
// across sequential grid steps and finished by a wide REDC outside the
// kernel; here blocks run in no order, so pass 1 writes one partial per
// block and pass 2 reduces the partials of each group (csrc/reduce.cuh).
// The TPU kernels' bf16 digit matmuls are a TPU idiom and are not carried
// over: each product is a CIOS Montgomery multiply in registers.
//
// Bound on the H100: integer multiply throughput. The Gruen cipher round
// does 9 + 8 + 8 = 25 Montgomery products per half-cube point against 96 B
// read; the direct cipher round 9 + 8 + 16 = 33 against 192 B; the
// identity round 4 against 128 B. Design: one thread per point in a
// grid-stride loop, the running sums in registers, a block reduction, and a
// second small launch over the partials that also applies the binomial
// constants C(7, m) of the Gruen round, so no finisher is needed.
#include <cuda_runtime.h>

#include "fr.cuh"
#include "reduce.cuh"

namespace {

using rsum::kThreads;

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
  __device__ __forceinline__ fr::Fe raw(int k) const {
    switch (k) {
      case 0: return fr::mul(u6, u);
      case 1: return fr::mul(u6, v);
      case 2: return fr::mul(uv2, u3);
      case 3: return fr::mul(uv3, u);
      case 4: return fr::mul(uv3, v);
      case 5: return fr::mul(uv2, v3);
      case 6: return fr::mul(v6, u);
      default: return fr::mul(v6, v);
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

// Pass 1 of the Gruen cipher round. Per point y of group grp's half cube:
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
    fr::Fe u, v;
    cipher_line(x0, x1, a, n_x, grp * 2 * half + y, half, u, v);
    const fr::Fe w = fr::load(s, n_s, grp * half + y);
    const CipherPowers pw(u, v);
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m] = fr::add(acc[m], fr::mul(w, pw.raw(m)));
  }
  rsum::store_partial<8>(partial, acc);
}

// Pass 1 of the direct (pre-Gruen) cipher round in coefficient form. With
// e = eq[bot], de = eq[top] - e, P(t) = (e + t de) (u + t v)^7, so
// P_m = <e, C(7,m) raw_m> + <de, C(7,m-1) raw_(m-1)>, m = 0..8: per point
// each raw is scaled by its binomial (adds only) and feeds two sums.
__global__ void __launch_bounds__(kThreads)
    cipher_coeff_acc_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1,
                            const int32_t* ark, int32_t* partial, int64_t half, int64_t g,
                            int64_t bpg) {
  constexpr uint32_t kBinom[8] = {1, 7, 21, 35, 35, 21, 7, 1};
  const int64_t grp = blockIdx.x / bpg;
  const int64_t bi = blockIdx.x - grp * bpg;
  const int64_t n_x = g * 2 * half;
  const fr::Fe a = fr::load(ark, g, grp);
  fr::Fe acc[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) acc[m] = fr::zero();
  for (int64_t y = bi * kThreads + threadIdx.x; y < half; y += bpg * kThreads) {
    const int64_t bot = grp * 2 * half + y;
    fr::Fe u, v;
    cipher_line(x0, x1, a, n_x, bot, half, u, v);
    const fr::Fe e = fr::load(eq, n_x, bot);
    const fr::Fe de = fr::sub(fr::load(eq, n_x, bot + half), e);
    const CipherPowers pw(u, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const fr::Fe c = fr::mul_small(pw.raw(k), kBinom[k]);
      acc[k] = fr::add(acc[k], fr::mul(e, c));
      acc[k + 1] = fr::add(acc[k + 1], fr::mul(de, c));
    }
  }
  rsum::store_partial<9>(partial, acc);
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
  rsum::store_partial<3>(partial, acc);
}

bool bad_geometry(int64_t half, int64_t g, int64_t bpg) { return half <= 0 || g <= 0 || bpg <= 0; }

}  // namespace

// s: (8, g * half); x0, x1: (8, g * 2 * half); ark: (8, g);
// binom: (8, 8) rows C(7, m) in Montgomery form; partial: (g * bpg, 8, 8)
// scratch; out: (8, 8, g).
extern "C" int gkr_gruen_acc(const void* s, const void* x0, const void* x1, const void* ark,
                             const void* binom, void* partial, void* out, int64_t half, int64_t g,
                             int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gruen_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<8>(partial, binom, out, g, bpg, st);
}

// eq, x0, x1: (8, g * 2 * half); ark: (8, g); partial: (g * bpg, 9, 8)
// scratch; out: (8, 9, g).
extern "C" int gkr_cipher_coeff_acc(const void* eq, const void* x0, const void* x1,
                                    const void* ark, void* partial, void* out, int64_t half,
                                    int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cipher_coeff_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<9>(partial, nullptr, out, g, bpg, st);
}

// eq, x: (8, g * 2 * half); partial: (g * bpg, 3, 8) scratch; out: (8, 3, g).
extern "C" int gkr_identity_acc(const void* eq, const void* x, void* partial, void* out,
                                int64_t half, int64_t g, int64_t bpg, void* stream) {
  if (bad_geometry(half, g, bpg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  identity_acc_kernel<<<static_cast<unsigned>(g * bpg), kThreads, 0, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(partial), half, g, bpg);
  return rsum::finish<3>(partial, nullptr, out, g, bpg, st);
}
