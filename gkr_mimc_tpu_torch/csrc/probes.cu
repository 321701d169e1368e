// Probes of the H100's cost model for the field arithmetic: the
// counterparts of the TPU package's micro-benchmark kernels in scripts/.
// Each probe is a chain the compiler cannot shorten (every step feeds the
// next, every result is stored) and has a plain torch or host-int version
// in ops/probes.py that gives the same bits.
//
//   op_chain     scripts/micro_ops.py make_bench.kern (:42, call :51):
//                `reps` dependent 32-bit ops a thread, one thread per
//                element; bound by the op's issue rate.
//   imma_dot     scripts/micro_ops.py dot_kern (:97, call :109): the
//                matrix unit on exact small integers, here the integer
//                tensor cores (mma.sync m16n8k32, s8 x s8 -> s32); bound by
//                the tensor-core rate.
//   field_check  scripts/check_mxu_mul.py kern (:31, call :40): mul,
//                square and x^7 of one multiply on lazy representatives.
//   mul_chain    scripts/micro_mul_split.py make_chain_kernel (:106, call
//                :154): `chain` dependent field ops a thread, split into
//                the full product, the schoolbook only and REDC only; bound
//                by integer multiply throughput.
//   sbox_chain   scripts/micro_row_mul.py _chain_kernel_col (:198) and
//                _chain_kernel_row (:185), call :206: dependent x^7 on one
//                element, one thread ("col") or a group of 8 threads of one
//                warp, one 32-bit limb each ("row"); bound by latency.
//
// The fifth script, scripts/micro_pe_mxu.py, runs the partial-evals kernel
// with its other multiply: gkr_cipher_partial_evals_ptx in
// csrc/partial_evals.cu.
//
// Every op in op_chain is inline PTX (asm volatile), so the front end keeps
// each step and cannot fold a chain of adds into a multiply. ptxas still
// merges two steps of the add and where bodies (x + y + y, max(max(x, y),
// y)) into one three-input IADD3 or VIMNMX3, so those bodies run half an
// instruction a step; `python -m gkr_mimc_tpu_torch.ops.probes sass`
// counts each chain loop's instructions.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// op_chain
// ---------------------------------------------------------------------------

// Bodies, in the order of ops/probes.py OP_BODIES. x, y are the 32-bit
// patterns of the element (float bits for F32_FMA).
enum Body {
  U32_MUL, U32_ADD, U32_MUL_ADD, U32_AND_SHR, U32_WHERE, U32_ROLL, F32_FMA, I32_F32,
  U32_MUL_HI, U32_MUL_WIDE, U32_MAD_CC, N_BODIES
};

template <int BODY>
__device__ __forceinline__ uint32_t body(uint32_t x, uint32_t y, int lane) {
  if (BODY == U32_MUL) {  // x * y
    asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == U32_ADD) {  // x + y
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == U32_MUL_ADD) {  // x * y + y
    asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == U32_AND_SHR) {  // (x & y) + (x >> 16)
    asm volatile("{ .reg .u32 t, s; and.b32 t, %0, %1; shr.u32 s, %0, 16; add.u32 %0, t, s; }"
                 : "+r"(x) : "r"(y));
  } else if (BODY == U32_WHERE) {  // x > y ? x : y
    asm volatile("max.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == U32_ROLL) {  // the element of lane - 1 (mod 32) plus y
    x = __shfl_sync(kFull, x, (lane + 31) & 31);
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == F32_FMA) {  // x * y + y, fused
    float f = __uint_as_float(x);
    asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(f) : "f"(__uint_as_float(y)));
    x = __float_as_uint(f);
  } else if (BODY == I32_F32) {  // u32(i32(f32(i32(x)))) + y
    asm volatile("{ .reg .f32 f; cvt.rn.f32.s32 f, %0; cvt.rzi.s32.f32 %0, f; add.u32 %0, %0, %1; }"
                 : "+r"(x) : "r"(y));
  } else if (BODY == U32_MUL_HI) {  // hi32(x * y) + y
    asm volatile("mad.hi.u32 %0, %0, %1, %1;" : "+r"(x) : "r"(y));
  } else if (BODY == U32_MUL_WIDE) {  // lo32(x * y) ^ hi32(x * y) of the 64-bit product
    asm volatile("{ .reg .u64 w; .reg .u32 lo, hi; mul.wide.u32 w, %0, %1; mov.b64 {lo, hi}, w; "
                 "xor.b32 %0, lo, hi; }"
                 : "+r"(x) : "r"(y));
  } else if (BODY == U32_MAD_CC) {  // t = lo32(x*y) + y (carry c); hi32(x*y) + t + c
    asm volatile("{ .reg .u32 t; mad.lo.cc.u32 t, %0, %1, %1; madc.hi.u32 %0, %0, %1, t; }"
                 : "+r"(x) : "r"(y));
  }
  return x;
}

// One thread per element of a flat table of n 32-bit words (n a multiple
// of 32 and blockDim a multiple of 32, so warps are whole for the shuffle).
template <int BODY>
__global__ void op_chain_kernel(const uint32_t* x, const uint32_t* y, uint32_t* out, int64_t n,
                                int reps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  uint32_t a = x[i];
  const uint32_t b = y[i];
#pragma unroll 16
  for (int r = 0; r < reps; ++r) a = body<BODY>(a, b, lane);
  out[i] = a;
}

template <int BODY>
int launch_op_chain(const void* x, const void* y, void* out, int64_t n, int reps, int threads,
                    cudaStream_t st) {
  const int64_t blocks = (n + threads - 1) / threads;
  op_chain_kernel<BODY><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), static_cast<uint32_t*>(out), n,
      reps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// imma_dot
// ---------------------------------------------------------------------------

// c += a * b on one 16 x 8 tile, a 16 x 32 (row), b 32 x 8 (col), s8 -> s32.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive rows r0..r0+3 of column col of a (32, n) s8 table, packed
// low byte first.
__device__ __forceinline__ uint32_t pack_col(const int8_t* x, int64_t n, int r0, int64_t col) {
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) v |= static_cast<uint32_t>(static_cast<uint8_t>(x[(r0 + i) * n + col])) << (8 * i);
  return v;
}

// out (64, n) = reps * (m (64, 32) @ x (32, n)). One warp a tile of 8
// columns: the four 16-row tiles of m stay in registers as A fragments,
// the tile's B fragment is loaded once, then `reps` rounds of four
// mma.sync accumulate into four independent 16 x 8 tiles.
__global__ void imma_dot_kernel(const int8_t* m, const int8_t* x, int32_t* out, int64_t n, int reps) {
  const int64_t n0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * 8;
  if (n0 >= n) return;  // whole warps (n is a multiple of 8)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int8_t* base = m + mt * 16 * 32;
    a[mt][0] = *reinterpret_cast<const uint32_t*>(base + g * 32 + 4 * t);
    a[mt][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * 32 + 4 * t);
    a[mt][2] = *reinterpret_cast<const uint32_t*>(base + g * 32 + 16 + 4 * t);
    a[mt][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * 32 + 16 + 4 * t);
  }
  const uint32_t b0 = pack_col(x, n, 4 * t, n0 + g);
  const uint32_t b1 = pack_col(x, n, 16 + 4 * t, n0 + g);
  int32_t c[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[mt][i] = 0;
  for (int r = 0; r < reps; ++r)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) mma_s8(c[mt], a[mt], b0, b1);
  const int64_t col = n0 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int64_t row = mt * 16 + g;
    out[row * n + col] = c[mt][0];
    out[row * n + col + 1] = c[mt][1];
    out[(row + 8) * n + col] = c[mt][2];
    out[(row + 8) * n + col + 1] = c[mt][3];
  }
}

// ---------------------------------------------------------------------------
// field_check and mul_chain
// ---------------------------------------------------------------------------

struct MulStd {
  __device__ __forceinline__ static fr::Fe mul(const fr::Fe& a, const fr::Fe& b) { return fr::mul(a, b); }
  __device__ __forceinline__ static fr::Fe square(const fr::Fe& a) { return fr::square(a); }
};
struct MulPtx {
  __device__ __forceinline__ static fr::Fe mul(const fr::Fe& a, const fr::Fe& b) { return fr::mul_ptx(a, b); }
  __device__ __forceinline__ static fr::Fe square(const fr::Fe& a) { return fr::square(a); }
};
struct MulFips {
  __device__ __forceinline__ static fr::Fe mul(const fr::Fe& a, const fr::Fe& b) { return fr::mul_fips(a, b); }
  __device__ __forceinline__ static fr::Fe square(const fr::Fe& a) { return fr::square_fips(a); }
};

// out_mul = a * b, out_sq = a^2 by Mul's square (fr::square, or
// fr::square_fips with fr::mul_fips), out_pow7 = a^7 by the chain square,
// mul, square, mul of Mul's product: all REDC forms in Montgomery.
template <typename Mul>
__global__ void field_check_kernel(const int32_t* a, const int32_t* b, int32_t* out_mul, int32_t* out_sq,
                                   int32_t* out_pow7, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fr::Fe x = fr::load(a, n, i), y = fr::load(b, n, i);
  fr::store(out_mul, n, i, Mul::mul(x, y));
  fr::store(out_sq, n, i, Mul::square(x));
  const fr::Fe x2 = Mul::mul(x, x);
  const fr::Fe x3 = Mul::mul(x2, x);
  const fr::Fe x6 = Mul::mul(x3, x3);
  fr::store(out_pow7, n, i, Mul::mul(x6, x));
}

// Variants, in the order of ops/probes.py CHAIN_VARIANTS.
enum Variant { V_MUL, V_MUL_PTX, V_SQUARE, V_SCHOOL, V_REDC, V_MUL_FIPS, N_VARIANTS };

template <int V>
__device__ __forceinline__ fr::Fe chain_step(const fr::Fe& x, const fr::Fe& y) {
  if (V == V_MUL) return fr::mul(x, y);
  if (V == V_MUL_PTX) return fr::mul_ptx(x, y);
  if (V == V_SQUARE) return fr::square(x);
  if (V == V_MUL_FIPS) return fr::mul_fips(x, y);
  uint32_t t[2 * fr::L];
  if (V == V_SCHOOL) {  // the product only, folded to 256 bits as lo ^ hi
    fr::mul_wide(x, y, t);
    fr::Fe r;
#pragma unroll
    for (int j = 0; j < fr::L; ++j) r.v[j] = t[j] ^ t[j + fr::L];
    return r;
  }
  // V_REDC: the reduction only, of the 512-bit value x + y * 2^256
#pragma unroll
  for (int j = 0; j < fr::L; ++j) {
    t[j] = x.v[j];
    t[j + fr::L] = y.v[j];
  }
  return fr::redc_wide(t);
}

template <int V>
__global__ void mul_chain_kernel(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, int chain) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr::Fe x = fr::load(a, n, i);
  const fr::Fe y = fr::load(b, n, i);
#pragma unroll 1  // one step's code, as the chain's own cost
  for (int c = 0; c < chain; ++c) x = chain_step<V>(x, y);
  fr::store(out, n, i, x);
}

template <int V>
int launch_mul_chain(const void* a, const void* b, void* out, int64_t n, int chain, int threads,
                     cudaStream_t st) {
  const int64_t blocks = (n + threads - 1) / threads;
  mul_chain_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), static_cast<int32_t*>(out), n, chain);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sbox_chain
// ---------------------------------------------------------------------------

constexpr int kRowWidth = fr::L;  // threads that share one element in the row layout

// "col": one thread per element, `rounds` dependent fr::pow7; canonical out.
__global__ void sbox_col_kernel(const int32_t* x, int32_t* out, int64_t n, int rounds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr::Fe v = fr::load(x, n, i);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) v = fr::pow7(v);
  fr::store(out, n, i, fr::canonical(v));
}

// REDC(a * b) with the element spread over the 8 threads of a row group,
// thread k holding limb k of a, b and the result (all 32 lanes of the warp
// take part in every shuffle). CIOS as in fr::mul: step i broadcasts b_i,
// each thread adds the low half of a_k b_i to its column and hands the high
// half to column k + 1 (thread 7 keeps column 8); m = t_0 (-p^-1) is
// broadcast from thread 0, m p_k added the same way; then every column
// moves down one thread and thread 0 adds the carry of the column it drops.
// Columns are 64-bit, so carries wait until the end, where they are
// propagated by one shuffle and a 3-step carry-lookahead (Kogge-Stone).
// The m digits are those of the exact running value, so the result is the
// integer fr::mul returns.
__device__ __forceinline__ uint32_t row_mul(uint32_t a, uint32_t b, int k, uint32_t pk) {
  uint64_t acc = 0u, acc8 = 0u;
#pragma unroll
  for (int i = 0; i < fr::L; ++i) {
    const uint32_t bi = __shfl_sync(kFull, b, i, kRowWidth);
    const uint64_t pr = static_cast<uint64_t>(a) * bi;
    uint32_t up = __shfl_up_sync(kFull, static_cast<uint32_t>(pr >> 32), 1, kRowWidth);
    acc += static_cast<uint32_t>(pr) + static_cast<uint64_t>(k ? up : 0u);
    acc8 += k == kRowWidth - 1 ? (pr >> 32) : 0u;
    const uint32_t m = __shfl_sync(kFull, static_cast<uint32_t>(acc) * FR_NP0, 0, kRowWidth);
    const uint64_t q = static_cast<uint64_t>(m) * pk;
    up = __shfl_up_sync(kFull, static_cast<uint32_t>(q >> 32), 1, kRowWidth);
    acc += static_cast<uint32_t>(q) + static_cast<uint64_t>(k ? up : 0u);
    acc8 += k == kRowWidth - 1 ? (q >> 32) : 0u;
    const uint64_t c0 = acc >> 32;  // thread 0: the carry of the column it drops
    const uint64_t next = __shfl_down_sync(kFull, acc, 1, kRowWidth);
    acc = k == kRowWidth - 1 ? acc8 : next;
    acc8 = 0u;
    if (k == 0) acc += c0;
  }
  // carries of the 64-bit columns into 32-bit limbs
  const uint32_t cin = __shfl_up_sync(kFull, static_cast<uint32_t>(acc >> 32), 1, kRowWidth);
  const uint64_t s = static_cast<uint64_t>(static_cast<uint32_t>(acc)) + (k ? cin : 0u);
  uint32_t x = static_cast<uint32_t>(s);
  uint32_t gen = static_cast<uint32_t>(s >> 32), prop = x == 0xffffffffu;
#pragma unroll
  for (int d = 1; d < kRowWidth; d <<= 1) {
    const uint32_t gd = __shfl_up_sync(kFull, gen, d, kRowWidth);
    const uint32_t pd = __shfl_up_sync(kFull, prop, d, kRowWidth);
    if (k >= d) {
      gen |= prop & gd;
      prop &= pd;
    }
  }
  const uint32_t carry = __shfl_up_sync(kFull, gen, 1, kRowWidth);
  return x + (k ? carry : 0u);
}

__device__ __forceinline__ uint32_t row_pow7(uint32_t x, int k, uint32_t pk) {
  const uint32_t x2 = row_mul(x, x, k, pk);
  const uint32_t x3 = row_mul(x2, x, k, pk);
  const uint32_t x6 = row_mul(x3, x3, k, pk);
  return row_mul(x6, x, k, pk);
}

// "row": element e on threads 8e..8e+7. Groups past the last element run
// element n - 1 without storing it, so every warp is whole.
__global__ void sbox_row_kernel(const int32_t* x, int32_t* out, int64_t n, int rounds) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int k = threadIdx.x & (kRowWidth - 1);
  const int64_t e = gid / kRowWidth;
  const int64_t ec = e < n ? e : n - 1;
  const uint32_t p[fr::L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  const uint32_t pk = p[k];
  uint32_t v = static_cast<uint32_t>(x[k * n + ec]);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) v = row_pow7(v, k, pk);
  fr::Fe a;
#pragma unroll
  for (int l = 0; l < fr::L; ++l) a.v[l] = __shfl_sync(kFull, v, l, kRowWidth);
  if (e < n && k == 0) fr::store(out, n, e, fr::canonical(a));
}

unsigned blocks_for(int64_t threads_total, int threads) {
  return static_cast<unsigned>((threads_total + threads - 1) / threads);
}

}  // namespace

// x, y, out: n 32-bit words (n a multiple of 32); body < N_BODIES;
// threads a multiple of 32, at most 1024.
extern "C" int gkr_probe_op_chain(const void* x, const void* y, void* out, int64_t n, int64_t body,
                                  int64_t reps, int64_t threads, void* stream) {
  if (n <= 0 || n % 32 || reps < 0 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(reps), t = static_cast<int>(threads);
  switch (body) {
    case U32_MUL: return launch_op_chain<U32_MUL>(x, y, out, n, r, t, st);
    case U32_ADD: return launch_op_chain<U32_ADD>(x, y, out, n, r, t, st);
    case U32_MUL_ADD: return launch_op_chain<U32_MUL_ADD>(x, y, out, n, r, t, st);
    case U32_AND_SHR: return launch_op_chain<U32_AND_SHR>(x, y, out, n, r, t, st);
    case U32_WHERE: return launch_op_chain<U32_WHERE>(x, y, out, n, r, t, st);
    case U32_ROLL: return launch_op_chain<U32_ROLL>(x, y, out, n, r, t, st);
    case F32_FMA: return launch_op_chain<F32_FMA>(x, y, out, n, r, t, st);
    case I32_F32: return launch_op_chain<I32_F32>(x, y, out, n, r, t, st);
    case U32_MUL_HI: return launch_op_chain<U32_MUL_HI>(x, y, out, n, r, t, st);
    case U32_MUL_WIDE: return launch_op_chain<U32_MUL_WIDE>(x, y, out, n, r, t, st);
    case U32_MAD_CC: return launch_op_chain<U32_MAD_CC>(x, y, out, n, r, t, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// m: (64, 32) s8; x: (32, n) s8 (n a multiple of 8); out: (64, n) s32.
extern "C" int gkr_probe_imma_dot(const void* m, const void* x, void* out, int64_t n, int64_t reps,
                                  int64_t threads, void* stream) {
  if (n <= 0 || n % 8 || reps < 0 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  imma_dot_kernel<<<blocks_for(n / 8 * 32, static_cast<int>(threads)), static_cast<int>(threads), 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const int8_t*>(m),
                                                         static_cast<const int8_t*>(x),
                                                         static_cast<int32_t*>(out), n, static_cast<int>(reps));
  return static_cast<int>(cudaGetLastError());
}

// a, b, out_*: (8, n); variant 0 = fr::mul, 1 = fr::mul_ptx, 2 = fr::mul_fips.
extern "C" int gkr_probe_field_check(const void* a, const void* b, void* out_mul, void* out_sq,
                                     void* out_pow7, int64_t n, int64_t variant, void* stream) {
  if (n <= 0 || variant < 0 || variant > 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* o1 = static_cast<int32_t*>(out_mul);
  auto* o2 = static_cast<int32_t*>(out_sq);
  auto* o3 = static_cast<int32_t*>(out_pow7);
  if (variant == 0)
    field_check_kernel<MulStd><<<blocks_for(n, kThreads), kThreads, 0, st>>>(pa, pb, o1, o2, o3, n);
  else if (variant == 1)
    field_check_kernel<MulPtx><<<blocks_for(n, kThreads), kThreads, 0, st>>>(pa, pb, o1, o2, o3, n);
  else
    field_check_kernel<MulFips><<<blocks_for(n, kThreads), kThreads, 0, st>>>(pa, pb, o1, o2, o3, n);
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: (8, n); variant < N_VARIANTS; chain >= 0 dependent steps.
extern "C" int gkr_probe_mul_chain(const void* a, const void* b, void* out, int64_t n, int64_t variant,
                                   int64_t chain, int64_t threads, void* stream) {
  if (n <= 0 || chain < 0 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(chain), t = static_cast<int>(threads);
  switch (variant) {
    case V_MUL: return launch_mul_chain<V_MUL>(a, b, out, n, c, t, st);
    case V_MUL_PTX: return launch_mul_chain<V_MUL_PTX>(a, b, out, n, c, t, st);
    case V_SQUARE: return launch_mul_chain<V_SQUARE>(a, b, out, n, c, t, st);
    case V_SCHOOL: return launch_mul_chain<V_SCHOOL>(a, b, out, n, c, t, st);
    case V_REDC: return launch_mul_chain<V_REDC>(a, b, out, n, c, t, st);
    case V_MUL_FIPS: return launch_mul_chain<V_MUL_FIPS>(a, b, out, n, c, t, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, out: (8, n); layout 0 = col (a thread an element), 1 = row (8 threads
// an element); out canonical.
extern "C" int gkr_probe_sbox_chain(const void* x, void* out, int64_t n, int64_t layout, int64_t rounds,
                                    void* stream) {
  if (n <= 0 || rounds < 0 || layout < 0 || layout > 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const int32_t*>(x);
  auto* po = static_cast<int32_t*>(out);
  const int r = static_cast<int>(rounds);
  if (layout == 0)
    sbox_col_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(px, po, n, r);
  else
    sbox_row_kernel<<<blocks_for(n * kRowWidth, kThreads), kThreads, 0, st>>>(px, po, n, r);
  return static_cast<int>(cudaGetLastError());
}
