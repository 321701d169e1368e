// The S-box passes of the generic circuits: x^7 over a table, and one
// cipher-gate layer (l + r + ark)^7.
//
// Bound on the H100: integer multiply throughput. Each element costs four
// Montgomery products (square, mul, square, mul: 4 x 264 32-bit multiply
// results) against 64 B (pow7) or 96 B (cipher_layer) of device memory;
// at 3.35 TB/s the bytes take about a third of the multiply time. There is
// no reduction, so the design is the one of csrc/elementwise.cu: one
// thread per element, limb-major loads so a warp reads 32 neighbouring
// words per limb, the ark a broadcast load.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;

// Replaces gkr_mimc_tpu/ops/kernels.py:pow7 (the S-box of SBoxGate and of
// the GMiMC and Poseidon hashers): out = x^7 over an (8, n) table.
__global__ void __launch_bounds__(kThreads) pow7_kernel(const int32_t* x, int32_t* out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  fr::store(out, n, i, fr::pow7(fr::load(x, n, i)));
}

// Replaces gkr_mimc_tpu/ops/kernels.py:cipher_layer (CipherGate.eval_batch,
// circuit/gates/cipher.go:25-42): out = ((r + ark) + l)^7 over (8, n)
// tables, the TPU kernel's operand order. Addition mod 2p is exact, so any
// order gives the same bits.
__global__ void __launch_bounds__(kThreads)
    cipher_layer_kernel(const int32_t* l, const int32_t* r, const int32_t* ark, int32_t* out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const fr::Fe s = fr::add(fr::add(fr::load(r, n, i), fr::load(ark, 1, 0)), fr::load(l, n, i));
  fr::store(out, n, i, fr::pow7(s));
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// x, out: (8, n).
extern "C" int gkr_pow7(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  pow7_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// l, r, out: (8, n); ark: (8,).
extern "C" int gkr_cipher_layer(const void* l, const void* r, const void* ark, void* out, int64_t n,
                                void* stream) {
  if (n <= 0) return 0;
  cipher_layer_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(l), static_cast<const int32_t*>(r), static_cast<const int32_t*>(ark),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
