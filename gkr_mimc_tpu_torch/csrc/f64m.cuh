// Montgomery in radix 2^52 on the FP64 units: the product of the probes
// sbox_chain and field_check's "f64" variant (csrc/probes.cu).
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
#pragma once

#include <cstdint>

#include "fr.cuh"

namespace f64m {
namespace {  // internal linkage: each source that includes this gets its own copy

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

// The port's a R (< 2p) -> a R', and a R' -> a R, canonical.
__device__ __forceinline__ F5 from_port(const fr::Fe& a) {
  const uint64_t to_r260[N] = F64M_TO_R260;
  return mul(from_words(a), constant(to_r260));
}

__device__ __forceinline__ fr::Fe to_port(const F5& v) {
  const uint64_t to_r256[N] = F64M_TO_R256;
  return fr::canonical(to_words(mul(v, constant(to_r256))));
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
  for (int k = 0; k < N; ++k) o.v[k] = __shfl_xor_sync(0xffffffffu, z.v[k], 1);
  return mul(z, o);  // the same integer on both threads: REDC(a b) = REDC(b a)
}

// `rounds` S-boxes, four deep on one thread or three deep on a pair (odd:
// this thread is the pair's odd one).
template <bool kPair>
__device__ __forceinline__ fr::Fe chain(const fr::Fe& a, int rounds, bool odd) {
  F5 v = from_port(a);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) v = kPair ? sbox_pair(v, odd) : sbox(v);
  return to_port(v);
}

}  // namespace
}  // namespace f64m
