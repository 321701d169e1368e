// The multiply probe's per-t cipher kernel (ops/probes.py cipher_pe_variant,
// the counterpart of scripts/micro_pe_mxu.py _cipher_pe_kernel2, which runs
// the TPU's evaluation-form cipher kernel with its other multiply): the
// cipher round's sums S_t = sum_y eq_t(y) (x0_t(y) + x1_t(y) + ark)^7 at
// t = 0..8 of one group, every product reduced (the per-t design: 45
// products a point), lazy below 2p. This file serves that probe only; the
// prover's rounds in evaluation form are the deferred contractions of
// csrc/round_acc.cu.
//
// Bound: the card's 32-bit multiply rate. The products run on fr::square
// (x^2, x^6: 208 results) and fr::mul_ptx (x^3, x^7, the eq weight: 264),
// 1,208 results a (point, t) (ops/probes.py PE_MIX, which the bound
// reads). At that many products a thread the kernel issues about as fast
// as the SM's integer pipes take instructions, so its time follows its
// instruction count.
//
// Design. A thread walks points in a grid-stride loop and, for each point,
// the nine t's in a loop that is not unrolled: the point's six loads and
// its two differences serve nine terms, and the loop body is one term's
// code. t walks by adds, e_t = e_(t-1) + (e_top - e_bot) from e_0 = e_bot
// (fr::add and fr::sub are exact mod 2p, so e_1 = e_top exactly), and so
// does the gate's input s = x1 + ark + x0. The sums are plain integers,
// eight words and a carry word for each t, no subtraction a point: the
// thread keeps them in shared memory (word w of t's sum of thread i at
// sacc[(t * 9 + w) * THREADS + i], so a warp's accesses fall in 32 banks)
// and its registers for the products; 16 warps an SM at every block size.
// At the end a warp adds its lanes' sums by shuffles, and lane 0 adds each
// word into a zeroed (9, 9) table of 64-bit sums by one atomicAdd. Integer
// sums do not depend on their order, so the result is deterministic. A
// second launch resolves each t's carries and takes the sum mod 2p: mod p
// by one REDC of its top word, then the representative below 2p of the
// sum's parity. tests/test_torch_probes_pe.py models the walk, the sums and
// the finish on Python ints and asserts their headroom. PERF.md (section
// 6) times the designs tried: t spread over block columns (one or three
// t's a thread), two points a thread, 16 to 32 warps an SM, fr::mul for
// the products.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kEvals = 9;          // the cipher gate's degree 7, plus 2
constexpr int kWords = fr::L + 1;  // an integer sum: eight words and a carry word

// R^2 mod p (R = 2^256): REDC(h, R^2) = h R mod p
#define PE_R2 {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u}

// acc += x: one carry chain.
__device__ __forceinline__ void acc_add(uint32_t (&acc)[kWords], const fr::Fe& x) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]),
        "+r"(acc[7]), "+r"(acc[8])
      : "r"(x.v[0]), "r"(x.v[1]), "r"(x.v[2]), "r"(x.v[3]), "r"(x.v[4]), "r"(x.v[5]), "r"(x.v[6]), "r"(x.v[7]));
}

// acc += o, both nine words (a warp's sums stay below 2^288).
__device__ __forceinline__ void acc_add_wide(uint32_t (&acc)[kWords], const uint32_t (&o)[kWords]) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, %17;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]),
        "+r"(acc[7]), "+r"(acc[8])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(o[8]));
}

// e x^7 of one (point, t), in the plain version's order: x^2 and x^6 by
// fr::square, x^3, x^7 and the eq weight by fr::mul_ptx.
__device__ __forceinline__ fr::Fe term(const fr::Fe& e, const fr::Fe& x) {
  const fr::Fe x3 = fr::mul_ptx(fr::square(x), x);
  return fr::mul_ptx(e, fr::mul_ptx(fr::square(x3), x));
}

// sums: (9, 9) 64-bit, zeroed; dynamic shared memory 9 x 9 x THREADS words.
template <int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
    pe_per_t_kernel(const int32_t* eq, const int32_t* x0, const int32_t* x1, const int32_t* ark,
                    unsigned long long* sums, int64_t half) {
  extern __shared__ uint32_t sacc[];
  const int64_t n = 2 * half;
  const fr::Fe a = fr::load(ark, 1, 0);
  for (int k = 0; k < kEvals * kWords; ++k) sacc[k * THREADS + threadIdx.x] = 0u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t y = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; y < half; y += stride) {
    const fr::Fe eb = fr::load(eq, n, y), et = fr::load(eq, n, y + half);
    const fr::Fe sb = fr::add(fr::add(fr::load(x1, n, y), a), fr::load(x0, n, y));
    const fr::Fe st = fr::add(fr::add(fr::load(x1, n, y + half), a), fr::load(x0, n, y + half));
    const fr::Fe de = fr::sub(et, eb), ds = fr::sub(st, sb);
    fr::Fe e = eb, s = sb;
#pragma unroll 1
    for (int t = 0; t < kEvals; ++t) {
      uint32_t* p = sacc + t * kWords * THREADS + threadIdx.x;
      uint32_t acc[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[w] = p[w * THREADS];
      acc_add(acc, term(e, s));
#pragma unroll
      for (int w = 0; w < kWords; ++w) p[w * THREADS] = acc[w];
      e = fr::add(e, de);
      s = fr::add(s, ds);
    }
  }
#pragma unroll 1
  for (int t = 0; t < kEvals; ++t) {
    uint32_t acc[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc[w] = sacc[(t * kWords + w) * THREADS + threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      uint32_t o[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) o[w] = __shfl_down_sync(0xffffffffu, acc[w], off);
      acc_add_wide(acc, o);
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) atomicAdd(sums + t * kWords + w, static_cast<unsigned long long>(acc[w]));
    }
  }
}

// One thread a t: the 64-bit word sums -> the integer (carries resolved,
// below 2^288) -> its residue below 2p. out: (8, 9, 1).
__global__ void pe_finish_kernel(const unsigned long long* sums, int32_t* out) {
  const int t = threadIdx.x;
  if (t >= kEvals) return;
  uint32_t v[kWords];
  unsigned long long c = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const unsigned long long s = sums[t * kWords + w] + c;
    v[w] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  const uint32_t two_p[fr::L] = {FR_2P0, FR_2P1, FR_2P2, FR_2P3, FR_2P4, FR_2P5, FR_2P6, FR_2P7};
  const uint32_t p[fr::L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  fr::Fe lo, hi = fr::zero();
#pragma unroll
  for (int l = 0; l < fr::L; ++l) lo.v[l] = v[l];
  lo = fr::cond_sub(fr::cond_sub(lo, two_p), two_p);  // below 2^256 < 3 (2p): now below 2p
  hi.v[0] = v[fr::L];
  const fr::Fe r2 = {PE_R2};
  fr::Fe r = fr::canonical(fr::add(lo, fr::mul(hi, r2)));  // the sum mod p
  if ((r.v[0] ^ v[0]) & 1u) {  // r + p: the representative below 2p of the sum's parity
    uint64_t cc = 0;
#pragma unroll
    for (int l = 0; l < fr::L; ++l) {
      const uint64_t s = static_cast<uint64_t>(r.v[l]) + p[l] + cc;
      r.v[l] = static_cast<uint32_t>(s);
      cc = s >> 32;
    }
  }
  fr::store(out, kEvals, t, r);
}

template <int THREADS>
int launch(const void* eq, const void* x0, const void* x1, const void* ark, void* sums, void* out, int64_t half,
           cudaStream_t st) {
  auto kernel = pe_per_t_kernel<THREADS>;
  constexpr int kSmem = kEvals * kWords * THREADS * 4;
  constexpr int kResident = 512 / THREADS;  // blocks an SM, as __launch_bounds__ and kSmem allow: 16 warps
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the attribute belongs to the current device, so it is set at every call
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) err = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * kEvals * kWords, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave; the grid-stride loop gives each thread its share of the rest
  const int64_t wave = static_cast<int64_t>(sms) * kResident, needed = (half + THREADS - 1) / THREADS;
  const int64_t blocks = needed < wave ? needed : wave;
  kernel<<<static_cast<unsigned>(blocks), THREADS, kSmem, st>>>(
      static_cast<const int32_t*>(eq), static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const int32_t*>(ark), static_cast<unsigned long long*>(sums), half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pe_finish_kernel<<<1, 32, 0, st>>>(static_cast<const unsigned long long*>(sums), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cipher round in evaluation form at t = 0..8 (9 evaluations, no
// claim trick) of one group, by the per-t design, at `threads` = 128, 256
// or 512 a block: the multiply probe only, never the prover's path.
// eq, x0, x1: (8, 2 * half); ark: (8, 1); sums: (9, 9) 64-bit scratch
// (zeroed here); out: (8, 9, 1), the sums lazy (below 2p).
extern "C" int gkr_cipher_partial_evals_ptx(const void* eq, const void* x0, const void* x1, const void* ark,
                                            void* sums, void* out, int64_t half, int64_t threads, void* stream) {
  if (half <= 0 || half >= (1ll << 32)) return static_cast<int>(cudaErrorInvalidValue);  // sums below 2^288
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128: return launch<128>(eq, x0, x1, ark, sums, out, half, st);
    case 256: return launch<256>(eq, x0, x1, ark, sums, out, half, st);
    case 512: return launch<512>(eq, x0, x1, ark, sums, out, half, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
