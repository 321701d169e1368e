// Elementwise multiply passes: the sumcheck fold, the Gruen suffix-table
// doubling step, the multi-claim eq contraction and the eq-table doubling
// multiply. Each computes, per output element, a Montgomery multiply(-add)
// with a per-group scalar or a small table.
//
// Bound on the H100: device-memory bytes for fold, suffix_step and
// mul_scalar (one read and one write of 32 B per element against one
// Montgomery product); integer multiply throughput for multi_eq (J = 91
// products per 32 B written, on tables that stay in the 50 MB L2). Design:
// one thread per output element, limb-major loads so a warp reads 32
// neighbouring words per limb; the per-group scalar is a broadcast load.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 4;

struct Tables {
  const int32_t* in[kMaxTables];
  int32_t* out[kMaxTables];
};

// Replaces gkr_mimc_tpu/ops/kernels.py:fold_tables_band and the three
// folds that compute the same function and differ only in how the TPU's
// matrix unit multiplies: fold_tables_gm (group-major), fold_tables (one
// instance) and fold_tables_g (grouped (16, G, n) tables). Per group g of
// each table (group-major, G * n entries): out = bot + r_g * (top - bot),
// halving it. blockIdx.y picks the table, so nt tables go in one launch.
__global__ void __launch_bounds__(kThreads)
    fold_kernel(Tables t, const int32_t* r, int64_t half, int64_t g) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_out = g * half;
  if (o >= n_out) return;
  const int64_t grp = o / half;
  const int64_t bot = o + grp * half;  // grp * 2 * half + (o - grp * half)
  const int32_t* in = t.in[blockIdx.y];
  const fr::Fe rr = fr::load(r, g, grp);
  const fr::Fe b = fr::load(in, 2 * n_out, bot);
  const fr::Fe top = fr::load(in, 2 * n_out, bot + half);
  fr::store(t.out[blockIdx.y], n_out, o, fr::add(b, fr::mul(fr::sub(top, b), rr)));
}

// Replaces gkr_mimc_tpu/ops/kernels.py:suffix_step_band. Per group g:
// t (m entries) -> [t - q_g * t ; q_g * t] (2m entries), the two halves
// concatenated (MSB-first variable order), not interleaved.
__global__ void __launch_bounds__(kThreads)
    suffix_step_kernel(const int32_t* t, const int32_t* q, int32_t* out, int64_t m, int64_t g) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_in = g * m;
  if (i >= n_in) return;
  const int64_t grp = i / m;
  const fr::Fe x = fr::load(t, n_in, i);
  const fr::Fe qt = fr::mul(x, fr::load(q, g, grp));
  const int64_t lo = i + grp * m;  // grp * 2m + (i - grp * m)
  fr::store(out, 2 * n_in, lo, fr::sub(x, qt));
  fr::store(out, 2 * n_in, lo + m, qt);
}

// Replaces gkr_mimc_tpu/ops/kernels.py:multi_eq_accum:
// out[c * B + t] = sum_j mh[c, j] * lo[j, t]. The TPU kernel keeps all J lo
// tables in VMEM (about 3 MB here at J = 91, B = 2^10), more than a
// block's 227 KB of shared memory; here each thread reads its column of lo
// from global memory, where the whole lo set stays in L2.
__global__ void __launch_bounds__(kThreads)
    multi_eq_kernel(const int32_t* mh, const int32_t* lo, int32_t* out, int64_t c, int64_t j,
                    int64_t b) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= c * b) return;
  const int64_t ci = o / b;
  const int64_t t = o - ci * b;
  const int32_t* mh_c = mh + ci * fr::L * j;  // mh (C, 8, J)
  fr::Fe acc = fr::zero();
  for (int64_t jj = 0; jj < j; ++jj) {
    const fr::Fe h = fr::load(mh_c, j, jj);
    const fr::Fe w = fr::load(lo + jj * b, j * b, t);  // lo (8, J, B)
    acc = fr::add(acc, fr::mul(h, w));
  }
  fr::store(out, c * b, o, acc);
}

// Replaces gkr_mimc_tpu/ops/kernels.py:mul_scalar, the eq-table doubling
// multiply: out = x * r over an (8, n) table, r one element.
__global__ void __launch_bounds__(kThreads)
    mul_scalar_kernel(const int32_t* x, const int32_t* r, int32_t* out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  fr::store(out, n, i, fr::mul(fr::load(x, n, i), fr::load(r, 1, 0)));
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" const char* gkr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ins[k], outs[k]: (8, g * 2 * half) -> (8, g * half); r: (8, g); nt <= 4.
extern "C" int gkr_fold(const void* const* ins, void* const* outs, int64_t nt, const void* r,
                        int64_t half, int64_t g, void* stream) {
  if (nt < 1 || nt > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  if (half <= 0 || g <= 0) return 0;
  Tables t = {};
  for (int64_t k = 0; k < nt; ++k) {
    t.in[k] = static_cast<const int32_t*>(ins[k]);
    t.out[k] = static_cast<int32_t*>(outs[k]);
  }
  const dim3 grid(blocks_for(g * half), static_cast<unsigned>(nt));
  fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int32_t*>(r), half, g);
  return static_cast<int>(cudaGetLastError());
}

// t: (8, g * m); q: (8, g); out: (8, g * 2 * m).
extern "C" int gkr_suffix_step(const void* t, const void* q, void* out, int64_t m, int64_t g,
                               void* stream) {
  if (m <= 0 || g <= 0) return 0;
  suffix_step_kernel<<<blocks_for(g * m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t), static_cast<const int32_t*>(q), static_cast<int32_t*>(out),
      m, g);
  return static_cast<int>(cudaGetLastError());
}

// mh: (c, 8, j); lo: (8, j, b); out: (8, c * b).
extern "C" int gkr_multi_eq(const void* mh, const void* lo, void* out, int64_t c, int64_t j,
                            int64_t b, void* stream) {
  if (c <= 0 || b <= 0) return 0;
  multi_eq_kernel<<<blocks_for(c * b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mh), static_cast<const int32_t*>(lo), static_cast<int32_t*>(out),
      c, j, b);
  return static_cast<int>(cudaGetLastError());
}

// x: (8, n); r: (8,); out: (8, n).
extern "C" int gkr_mul_scalar(const void* x, const void* r, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  mul_scalar_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(r), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
