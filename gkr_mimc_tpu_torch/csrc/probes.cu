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
//                tensor cores (wgmma m64n256k32, s8 x s8 -> s32, operands
//                in shared memory); bound by the tensor-core rate.
//   field_check  scripts/check_mxu_mul.py kern (:31, call :40): mul,
//                square and x^7 of one multiply on lazy representatives.
//   mul_chain    scripts/micro_mul_split.py make_chain_kernel (:106, call
//                :154): `chain` dependent field ops a thread, split into
//                the full product, the schoolbook only and REDC only; bound
//                by integer multiply throughput.
//   sbox_chain   scripts/micro_row_mul.py _chain_kernel_col (:198) and
//                _chain_kernel_row (:185), call :206: dependent x^7 on one
//                element, one thread ("col") or a pair of threads of one
//                warp ("row"), the product on the FP64 units; bound by
//                latency.
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

// out (64, n) = reps * (m (64, 32) @ x (32, n)), s8 x s8 -> s32, on the
// warpgroup tensor-core instruction (wgmma), the only way to the card's
// full int8 rate. Each warpgroup (four warps) owns a 64 x 256 tile of out:
// m (2 KB, the A operand) and the tile's 32 x 256 slice of x (8 KB, the B
// operand) sit in shared memory behind matrix descriptors, and the
// warpgroup issues `reps` wgmma.m64n256k32 on the same 128 accumulators a
// thread, commits them as one group and waits once. Blocks are
// persistent (two warpgroups an SM) and walk the column tiles.
//
// Layout. 8-bit wgmma takes both operands K-major only (the transpose
// flag exists for 16-bit types alone), in "core matrices" of 8 rows of 16
// contiguous bytes of k. No swizzle: byte (row r, k byte c) of an operand
// sits at (r / 8) * kSbo + (c / 16) * kLbo + (r % 8) * 16 + c % 16, so an
// 8-row group is 256 contiguous bytes, its two 16-byte halves of k 128
// bytes apart (the descriptor's leading byte offset, LBO) and the groups
// 256 bytes apart (its stride byte offset, SBO). m is K-major in device
// memory already (row-major, k contiguous) and is copied 16 bytes a thread.
// x is N-major (row k, columns contiguous), so each tile is rewritten
// K-major once, in the kernel: a thread reads 4 columns of 16 rows as
// sixteen 32-bit words (the warp's reads coalesced) and turns each 4 x 4
// byte block around with __byte_perm, then stores each column's 16 bytes
// as one 16-byte word. tests/test_torch_probes_hopper.py models the
// mapping and the descriptors byte for byte.
namespace imma {

constexpr int kN = 256;         // columns of a warpgroup's tile (wgmma's widest N)
constexpr int kAccum = kN / 2;  // s32 accumulators a thread: 64 x 256 / 128
constexpr int kLbo = 128;       // bytes between the two 16-byte halves of k
constexpr int kSbo = 256;       // bytes between 8-row groups
constexpr int kMaxWarpgroups = 2;

__device__ __forceinline__ int smem_offset(int r, int c) {
  return (r >> 3) * kSbo + (c >> 4) * kLbo + (r & 7) * 16 + (c & 15);
}

// The matrix descriptor: start address >> 4 (bits 0-13), LBO >> 4 (16-29),
// SBO >> 4 (32-45), base offset 0 (49-51), layout type 0, no swizzle (62-63).
__device__ __forceinline__ uint64_t descriptor(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// d += A B on a 64 x 256 tile, k = 32: A and B from shared memory.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[kAccum], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operands(int32_t (&d)[kAccum]) {
#pragma unroll
  for (int i = 0; i < kAccum; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Column q of the 4 x 4 byte block whose row i is the word v[i] (byte q of
// v[i] is column q): the word whose byte i is row i's byte q.
__device__ __forceinline__ void transpose4(const uint32_t (&v)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140), t3 = __byte_perm(v[2], v[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// blockDim = 128 x (1 or 2) warpgroups; n a multiple of 8; m and x 16-byte
// aligned.
__global__ void __launch_bounds__(128 * kMaxWarpgroups) imma_dot_kernel(const int8_t* m, const int8_t* x,
                                                                        int32_t* out, int64_t n, int reps) {
  __shared__ __align__(128) uint8_t sa[64 * 32];
  __shared__ __align__(128) uint8_t sb[kMaxWarpgroups][kN * 32];
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int nwg = blockDim.x >> 7;
  for (int j = threadIdx.x; j < 128; j += blockDim.x) {  // A: row j / 2, k half j % 2
    const int r = j >> 1, h = j & 1;
    *reinterpret_cast<uint4*>(sa + smem_offset(r, 16 * h)) = *reinterpret_cast<const uint4*>(m + r * 32 + 16 * h);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic-proxy writes -> wgmma's reads
  __syncthreads();
  uint8_t* b = sb[wg];
  const uint64_t da = descriptor(sa), db = descriptor(b);
  const int g = t & 63, h = t >> 6;  // this thread's 4 columns 4g..4g+3 and 16 rows 16h..16h+15 of a tile
  const int warp = t >> 5, lane = t & 31, gr = lane >> 2, q = lane & 3;
  const int64_t tiles = (n + kN - 1) / kN;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * nwg + wg; tile < tiles;
       tile += static_cast<int64_t>(gridDim.x) * nwg) {
    const int64_t c0 = tile * kN;
    const int64_t col = c0 + 4 * g;  // n % 4 == 0: all four columns are in, or none
    uint32_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = col < n ? *reinterpret_cast<const uint32_t*>(x + (16 * h + i) * n + col) : 0u;
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");  // the last tile's wgmmas are done with b
    uint32_t cw[4][4];  // [column][row block]
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      const uint32_t rows[4] = {v[4 * blk], v[4 * blk + 1], v[4 * blk + 2], v[4 * blk + 3]};
      uint32_t cols[4];
      transpose4(rows, cols);
#pragma unroll
      for (int c = 0; c < 4; ++c) cw[c][blk] = cols[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint4*>(b + smem_offset(4 * g + c, 16 * h)) = make_uint4(cw[c][0], cw[c][1], cw[c][2], cw[c][3]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
    int32_t d[kAccum];
#pragma unroll
    for (int i = 0; i < kAccum; ++i) d[i] = 0;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll 32  // the fastest of the unrolls timed on the card (PERF.md, section 6)
    for (int r = 0; r < reps; ++r) wgmma_s8(d, da, db);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    // accumulator j of chunk c8: row 16 warp + gr (+ 8 for j >= 2), column 8 c8 + 2 q + (j & 1)
    const int64_t row = 16 * warp + gr;
#pragma unroll
    for (int c8 = 0; c8 < kN / 8; ++c8) {
      const int64_t oc = c0 + 8 * c8 + 2 * q;
      if (oc < n) {
        *reinterpret_cast<int2*>(out + row * n + oc) = make_int2(d[4 * c8], d[4 * c8 + 1]);
        *reinterpret_cast<int2*>(out + (row + 8) * n + oc) = make_int2(d[4 * c8 + 2], d[4 * c8 + 3]);
      }
    }
  }
}

}  // namespace imma

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
//
// `rounds` dependent x^7 on one element: bound by the latency of one
// dependent Montgomery product. Both layouts run the product below on the
// FP64 units; "col" (a thread an element) runs the chain four products
// deep (square, mul, square, mul), "row" (a pair of threads of one warp an
// element) three deep as csrc/mimc.cuh does (x^2, then x^3 and x^4 side by
// side on the two threads, then x^3 x^4). Each was the fastest design of
// its layout on the card (PERF.md, section 6): the first port's CIOS product
// (fr::pow7 on one thread; eight threads a word each, 51 dependent
// shuffles a product), separated operand scanning on four threads, and
// the FP64 product three deep on one thread all ran slower. Each layout
// converts once at entry and once at exit and stores the canonical
// Montgomery (R = 2^256) value, so both give the same bits.

// ---------------------------------------------------------------------------
// Montgomery in radix 2^52 on the FP64 units
// ---------------------------------------------------------------------------
//
// An element is five 52-bit limbs held as doubles (exact integers below
// 2^52), Montgomery with R' = 2^260. The 25 limb products of a * b are
// each split exactly into a high and a low half by the FP64 fused
// multiply-add (Emmart, Zheng and Weems, "Faster Modular Exponentiation
// Using Double Precision Floating Point Arithmetic on the GPU", ARITH
// 2018), rounding toward zero:
//   h = fma_rz(a, b, 2^104)   = 2^104 + 2^52 floor(a b / 2^52)  (in [2^104, 2^105): ulp 2^52)
//   s = (2^104 + 2^52) - h    = 2^52 - 2^52 floor(a b / 2^52)   (exact)
//   l = fma_rz(a, b, s)       = 2^52 + (a b mod 2^52)          (in [2^52, 2^53): ulp 1, exact)
// so the bit patterns of h and l, less those of 2^104 and 2^52, are the two
// halves as integers. Round to nearest would leave a signed low half that
// straddles the binade at 2^52; round toward zero keeps both halves in one
// binade each. Every split is written with the _rz intrinsics, so nvcc
// cannot contract or reassociate it. The halves' bit patterns are summed
// into ten 64-bit column sums (integer adds, modulo 2^64: each column
// starts at minus the patterns' offsets it will receive, a constant), and
// the Montgomery reduction runs on the columns limb by limb: q_i =
// column_i * (-p^-1) mod 2^52 by a 64-bit integer multiply, the 20
// products q_i p_j (j >= 1) split into the columns above it, and the carry
// out of column i
// is column_i's high bits + hi(q_i p_0) + (column_i's low 52 bits != 0),
// since column_i + q_i p_0 = 0 mod 2^52. The result, columns 5..9
// with the carries resolved, is (a b + q p) / 2^260 < a b / 2^260 + p: below
// 2p for inputs below 2^255, in five limbs below 2^52 again. Entry
// multiplies the port's a R by 2^264 mod p (-> a R'), exit multiplies by
// 2^256 mod p (-> a R) and subtracts p once if needed.
// tests/test_torch_probes_hopper.py models every step on Python ints and
// asserts each headroom.
namespace f64m {

constexpr double kTwo52 = 0x1p52, kTwo104 = 0x1p104, kSplitSub = 0x1p104 + 0x1p52;
constexpr uint64_t kBits52 = 0x4330000000000000ull;   // the pattern of 2^52
constexpr uint64_t kBits104 = 0x4670000000000000ull;  // the pattern of 2^104
constexpr uint64_t kMask52 = (1ull << 52) - 1;
constexpr int N = 5;

struct F5 {
  double v[N];
};

// p in radix 2^52 and -p^-1 mod 2^52
#define F64M_P {0x1f593f0000001ull, 0x4879b9709143eull, 0x181585d2833e8ull, 0xa029b85045b68ull, 0x30644e72e131ull}
constexpr uint64_t kNp = 0x1f593efffffffull;
// 2^264 mod p (entry: a R -> a R') and 2^256 mod p (exit: a R' -> a R), radix 2^52
#define F64M_TO_R260 {0x31f8c9ffffab6ull, 0xac31329faef6eull, 0x9e2a3495d7570ull, 0xe357276f48b70ull, 0xd791464ef86ull}
#define F64M_TO_R256 {0x6341c4ffffffbull, 0x959f60cd29ac9ull, 0x879462e36fc76ull, 0xdf2f666ea36f7ull, 0xe0a77c19a07ull}

// (low, high) halves' patterns of a b (a, b < 2^52), added to the columns' sums.
__device__ __forceinline__ void split_into(double a, double b, uint64_t& lo_col, uint64_t& hi_col) {
  const double h = __fma_rz(a, b, kTwo104);
  const double s = __dsub_rz(kSplitSub, h);
  const double l = __fma_rz(a, b, s);
  lo_col += static_cast<uint64_t>(__double_as_longlong(l));
  hi_col += static_cast<uint64_t>(__double_as_longlong(h));
}

// x < 2^52 as a double: 2^52 + x from its pattern, less 2^52 (exact).
__device__ __forceinline__ double from_u52(uint64_t x) {
  return __dsub_rn(__longlong_as_double(static_cast<long long>(x | kBits52)), kTwo52);
}

// How many low and high halves column k receives: from the product's
// limb pairs (i, j), i <= j when `sym`, and from the reduction's q_i p_j,
// j >= 1; the column starts at minus their patterns' sum.
__device__ __forceinline__ constexpr uint64_t col_offset(int k, bool prod, bool sym, bool diag, bool red) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      const bool take = prod && (sym ? (diag ? i == j : i < j) : true);
      const bool take_red = red && j >= 1;
      lo += (take && i + j == k) + (take_red && i + j == k);
      hi += (take && i + j + 1 == k) + (take_red && i + j + 1 == k);
    }
  return 0ull - (lo * kBits52 + hi * kBits104);
}

// Columns 0..9 of a product in hand -> REDC: (sum + q p) / 2^260 in limbs.
__device__ __forceinline__ F5 reduce(uint64_t (&col)[2 * N]) {
  const uint64_t p[N] = F64M_P;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t c = col[i] + carry;  // column i, everything below it resolved
    const uint64_t x = c & kMask52;
    // x (-p^-1) mod 2^52 by the integer multiply, which has the shorter
    // latency (by the FP64 split it was 5 % slower an S-box on the card)
    const double q = from_u52((x * kNp) & kMask52);
    const double h0 = __fma_rz(q, static_cast<double>(p[0]), kTwo104);
    carry = (c >> 52) + (static_cast<uint64_t>(__double_as_longlong(h0)) - kBits104) + (x != 0);
#pragma unroll
    for (int j = 1; j < N; ++j) split_into(q, static_cast<double>(p[j]), col[i + j], col[i + j + 1]);
  }
  F5 r;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t t = col[N + k] + carry;
    r.v[k] = from_u52(k < N - 1 ? t & kMask52 : t);
    carry = t >> 52;
  }
  return r;
}

__device__ __forceinline__ F5 mul(const F5& a, const F5& b) {
  uint64_t col[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) col[k] = col_offset(k, true, false, false, true);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) split_into(a.v[i], b.v[j], col[i + j], col[i + j + 1]);
  return reduce(col);
}

// a^2: the 10 cross products once, the columns doubled, then the 5 squares.
__device__ __forceinline__ F5 square(const F5& a) {
  uint64_t col[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) col[k] = col_offset(k, true, true, false, false);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) split_into(a.v[i], a.v[j], col[i + j], col[i + j + 1]);
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) col[k] = (col[k] << 1) + col_offset(k, true, true, true, true);
#pragma unroll
  for (int i = 0; i < N; ++i) split_into(a.v[i], a.v[i], col[2 * i], col[2 * i + 1]);
  return reduce(col);
}

__device__ __forceinline__ F5 constant(const uint64_t (&c)[N]) {
  F5 r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = static_cast<double>(c[k]);
  return r;
}

// The port's element (8 words, < 2p) -> five 52-bit limbs, and back.
__device__ __forceinline__ F5 from_words(const fr::Fe& a) {
  uint64_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = static_cast<uint64_t>(a.v[2 * i]) | (static_cast<uint64_t>(a.v[2 * i + 1]) << 32);
  F5 r;
  r.v[0] = from_u52(w[0] & kMask52);
  r.v[1] = from_u52(((w[0] >> 52) | (w[1] << 12)) & kMask52);
  r.v[2] = from_u52(((w[1] >> 40) | (w[2] << 24)) & kMask52);
  r.v[3] = from_u52(((w[2] >> 28) | (w[3] << 36)) & kMask52);
  r.v[4] = from_u52(w[3] >> 16);
  return r;
}

__device__ __forceinline__ fr::Fe to_words(const F5& a) {
  uint64_t l[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    l[k] = static_cast<uint64_t>(__double_as_longlong(__dadd_rn(a.v[k], kTwo52))) & kMask52;
  const uint64_t w[4] = {l[0] | (l[1] << 52), (l[1] >> 12) | (l[2] << 40), (l[2] >> 24) | (l[3] << 28),
                         (l[3] >> 36) | (l[4] << 16)};
  fr::Fe r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.v[2 * i] = static_cast<uint32_t>(w[i]);
    r.v[2 * i + 1] = static_cast<uint32_t>(w[i] >> 32);
  }
  return r;
}

// x^7 four deep on one thread.
__device__ __forceinline__ F5 sbox(const F5& x) { return mul(square(mul(square(x), x)), x); }

// x^7 three deep on a pair of neighbouring threads (csrc/mimc.cuh's shape):
// both square, the even thread multiplies x^2 by x, the odd one by x^2,
// and one exchange hands each the other's factor for x^3 x^4.
__device__ __forceinline__ F5 sbox_pair(const F5& x, bool odd) {
  const F5 x2 = square(x);
  F5 y;
#pragma unroll
  for (int k = 0; k < N; ++k) y.v[k] = odd ? x2.v[k] : x.v[k];
  const F5 z = mul(x2, y);
  F5 o;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = __shfl_xor_sync(kFull, z.v[k], 1);
  return mul(z, o);  // the same integer on both threads: REDC(a b) = REDC(b a)
}

// `rounds` S-boxes, four deep on one thread or three deep on a pair (odd:
// this thread is the pair's odd one).
template <bool kPair>
__device__ __forceinline__ fr::Fe chain(const fr::Fe& a, int rounds, bool odd) {
  const uint64_t to_r260[N] = F64M_TO_R260, to_r256[N] = F64M_TO_R256;
  F5 v = mul(from_words(a), constant(to_r260));
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) v = kPair ? sbox_pair(v, odd) : sbox(v);
  return fr::canonical(to_words(mul(v, constant(to_r256))));
}

}  // namespace f64m

// "col": one thread per element.
__global__ void sbox_col_kernel(const int32_t* x, int32_t* out, int64_t n, int rounds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr::store(out, n, i, f64m::chain<false>(fr::load(x, n, i), rounds, false));
}

// "row": element e on the pair of threads 2e, 2e + 1. Pairs past the last
// element run element n - 1 without storing it, so every warp is whole.
__global__ void sbox_row_kernel(const int32_t* x, int32_t* out, int64_t n, int rounds) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 1;
  const fr::Fe r = f64m::chain<true>(fr::load(x, n, e < n ? e : n - 1), rounds, threadIdx.x & 1);
  if (e < n && !(threadIdx.x & 1)) fr::store(out, n, e, r);
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

// m: (64, 32) s8; x: (32, n) s8 (n a multiple of 8); out: (64, n) s32; m,
// x 16-byte aligned; threads 128 or 256 (one or two warpgroups a block).
extern "C" int gkr_probe_imma_dot(const void* m, const void* x, void* out, int64_t n, int64_t reps,
                                  int64_t threads, void* stream) {
  if (n <= 0 || n % 8 || reps < 0 || (threads != 128 && threads != 256) ||
      reinterpret_cast<uintptr_t>(m) % 16 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wgs = static_cast<int>(threads / 128);
  const int64_t tiles = (n + imma::kN - 1) / imma::kN;
  const int64_t want = (tiles + wgs - 1) / wgs, most = (2 * static_cast<int64_t>(sms) + wgs - 1) / wgs;  // two warpgroups an SM
  imma::imma_dot_kernel<<<static_cast<unsigned>(want < most ? want : most), static_cast<int>(threads), 0,
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

// x, out: (8, n); layout 0 = col (a thread an element), 1 = row (a pair of
// threads an element); out canonical.
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
    sbox_row_kernel<<<blocks_for(2 * n, kThreads), kThreads, 0, st>>>(px, po, n, r);
  return static_cast<int>(cudaGetLastError());
}
