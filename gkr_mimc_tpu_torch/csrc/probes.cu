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
//                square and x^7 of one multiply on lazy representatives
//                (fr::mul, mul_ptx, mul_fips or the FP64 product); bound by
//                the latency of four dependent products and a launch.
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

#include "f64m.cuh"
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

// Each product policy: its element type, the conversions from and to the
// port's (8, n) Montgomery form, mul and square. The three 32-bit products
// work on the port's form itself; "f64" enters R' = 2^260 and leaves it
// canonical (csrc/f64m.cuh).
struct MulStd {
  using T = fr::Fe;
  __device__ __forceinline__ static T in(const fr::Fe& a) { return a; }
  __device__ __forceinline__ static fr::Fe out(const T& a) { return a; }
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return fr::mul(a, b); }
  __device__ __forceinline__ static T square(const T& a) { return fr::square(a); }
};
struct MulPtx : MulStd {
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return fr::mul_ptx(a, b); }
};
struct MulFips : MulStd {
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return fr::mul_fips(a, b); }
  __device__ __forceinline__ static T square(const T& a) { return fr::square_fips(a); }
};
struct MulF64 {
  using T = f64m::F5;
  __device__ __forceinline__ static T in(const fr::Fe& a) { return f64m::from_port(a); }
  __device__ __forceinline__ static fr::Fe out(const T& a) { return f64m::to_port(a); }
  __device__ __forceinline__ static T mul(const T& a, const T& b) { return f64m::mul(a, b); }
  __device__ __forceinline__ static T square(const T& a) { return f64m::square(a); }
};

// out (3, 8, n): a * b, a^2 by Mul's square, a^7 by the chain square, mul,
// square, mul of Mul's product, in the port's Montgomery form (canonical
// for "f64"). A latency probe: 256 elements four products deep, so one
// warp a block puts each warp on an SM of its own, and the independent
// product and square are issued between the chain's dependent products.
template <typename Mul>
__global__ void __launch_bounds__(32) field_check_kernel(const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  if (i >= n) return;
  const typename Mul::T x = Mul::in(fr::load(a, n, i)), y = Mul::in(fr::load(b, n, i));
  const typename Mul::T x2 = Mul::mul(x, x);
  const typename Mul::T xy = Mul::mul(x, y);
  const typename Mul::T x3 = Mul::mul(x2, x);
  const typename Mul::T sq = Mul::square(x);
  const typename Mul::T x6 = Mul::mul(x3, x3);
  fr::store(out, n, i, Mul::out(xy));
  fr::store(out + fr::L * n, n, i, Mul::out(sq));
  fr::store(out + 2 * fr::L * n, n, i, Mul::out(Mul::mul(x6, x)));
}

// The launch floor beside field_check: an empty kernel on its grid.
__global__ void empty_kernel() {}

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
// dependent Montgomery product. Both layouts run the product of
// csrc/f64m.cuh on the FP64 units; "col" (a thread an element) runs the chain four products
// deep (square, mul, square, mul), "row" (a pair of threads of one warp an
// element) three deep as csrc/mimc.cuh does (x^2, then x^3 and x^4 side by
// side on the two threads, then x^3 x^4). Each was the fastest design of
// its layout on the card (PERF.md, section 6): the first port's CIOS product
// (fr::pow7 on one thread; eight threads a word each, 51 dependent
// shuffles a product), separated operand scanning on four threads, and
// the FP64 product three deep on one thread all ran slower. Each layout
// converts once at entry and once at exit and stores the canonical
// Montgomery (R = 2^256) value, so both give the same bits.

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

// a, b: (8, n); out: (3, 8, n); variant 0 = fr::mul, 1 = fr::mul_ptx,
// 2 = fr::mul_fips, 3 = the FP64 product (f64m; out canonical). One warp a
// block.
extern "C" int gkr_probe_field_check(const void* a, const void* b, void* out, int64_t n, int64_t variant,
                                     void* stream) {
  if (n <= 0 || variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  const unsigned blocks = blocks_for(n, 32);
  if (variant == 0)
    field_check_kernel<MulStd><<<blocks, 32, 0, st>>>(pa, pb, po, n);
  else if (variant == 1)
    field_check_kernel<MulPtx><<<blocks, 32, 0, st>>>(pa, pb, po, n);
  else if (variant == 2)
    field_check_kernel<MulFips><<<blocks, 32, 0, st>>>(pa, pb, po, n);
  else
    field_check_kernel<MulF64><<<blocks, 32, 0, st>>>(pa, pb, po, n);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on field_check's grid for n elements (one warp a block).
extern "C" int gkr_probe_empty(int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks_for(n, 32), 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
