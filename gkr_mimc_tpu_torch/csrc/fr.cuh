// BN254 fr arithmetic for the port's CUDA kernels.
//
// Replaces the in-kernel field core of the TPU package,
// gkr_mimc_tpu/ops/fieldcore.py (mul, add, sub, canonicalize, pow7). The
// TPU core works on sixteen 16-bit limbs with MXU digit matmuls; here an
// element is eight 32-bit limbs in registers and the product is a plain
// CIOS Montgomery multiply with 64-bit accumulators.
//
// Representation (the same as gkr_mimc_tpu_torch/fields/fr.py, so a kernel
// and its plain torch twin give the same bits):
//   * limb-major tables: limb l of element i of an (8, n) table sits at
//     base[l * n + i], stored as int32 bit patterns;
//   * Montgomery form with R = 2^256, lazy representatives in [0, 2p);
//   * add / sub are exact arithmetic mod 2p; mul is REDC(a*b) without the
//     final subtraction, which maps [0, 2p) x [0, 2p) into [0, 2p) because
//     4p < R.
//
// mul_ptx (inline-PTX carry chains), square (each cross product once) and
// mul_fips / square_fips (product scanning) return mul's integers by other
// schedules. The probes compare them (csrc/probes.cu, ops/probes.py). The
// prover's throughput kernels use mul: at many elements a thread, a
// product is bound by the card's 32-bit multiply rate (264 results a
// product; CIOS reaches 1.8x that bound). The transcript hash is one
// dependent chain a lane, bound by the latency of a product, not the
// rate: csrc/mimc.cuh runs it on mul_fips and square_fips, whose word
// products are independent of one another.
#pragma once

#include <cstdint>

#define FR_P0 0xf0000001u
#define FR_P1 0x43e1f593u
#define FR_P2 0x79b97091u
#define FR_P3 0x2833e848u
#define FR_P4 0x8181585du
#define FR_P5 0xb85045b6u
#define FR_P6 0xe131a029u
#define FR_P7 0x30644e72u

#define FR_2P0 0xe0000002u
#define FR_2P1 0x87c3eb27u
#define FR_2P2 0xf372e122u
#define FR_2P3 0x5067d090u
#define FR_2P4 0x0302b0bau
#define FR_2P5 0x70a08b6du
#define FR_2P6 0xc2634053u
#define FR_2P7 0x60c89ce5u

// -p^-1 mod 2^32
#define FR_NP0 0xefffffffu

// R mod p: the Montgomery image of 1 (canonical, as fields/fr.py one())
#define FR_ONE0 0x4ffffffbu
#define FR_ONE1 0xac96341cu
#define FR_ONE2 0x9f60cd29u
#define FR_ONE3 0x36fc7695u
#define FR_ONE4 0x7879462eu
#define FR_ONE5 0x666ea36fu
#define FR_ONE6 0x9a07df2fu
#define FR_ONE7 0x0e0a77c1u

namespace fr {

constexpr int L = 8;

struct Fe {
  uint32_t v[L];
};

__device__ __forceinline__ Fe load(const int32_t* base, int64_t stride, int64_t idx) {
  Fe a;
#pragma unroll
  for (int l = 0; l < L; ++l) a.v[l] = static_cast<uint32_t>(base[l * stride + idx]);
  return a;
}

__device__ __forceinline__ void store(int32_t* base, int64_t stride, int64_t idx, const Fe& a) {
#pragma unroll
  for (int l = 0; l < L; ++l) base[l * stride + idx] = static_cast<int32_t>(a.v[l]);
}

__device__ __forceinline__ Fe zero() {
  Fe a;
#pragma unroll
  for (int l = 0; l < L; ++l) a.v[l] = 0u;
  return a;
}

__device__ __forceinline__ Fe one() {
  return Fe{{FR_ONE0, FR_ONE1, FR_ONE2, FR_ONE3, FR_ONE4, FR_ONE5, FR_ONE6, FR_ONE7}};
}

// s - c if s >= c, else s (s, c < 2^256).
__device__ __forceinline__ Fe cond_sub(const Fe& s, const uint32_t (&c)[L]) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint64_t t = static_cast<uint64_t>(s.v[l]) - c[l] - borrow;
    d.v[l] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  return borrow ? s : d;
}

// (a + b) mod 2p; a + b < 4p < 2^256, so no carry leaves the top limb.
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  const uint32_t two_p[L] = {FR_2P0, FR_2P1, FR_2P2, FR_2P3, FR_2P4, FR_2P5, FR_2P6, FR_2P7};
  Fe s;
  uint64_t carry = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint64_t t = static_cast<uint64_t>(a.v[l]) + b.v[l] + carry;
    s.v[l] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  return cond_sub(s, two_p);
}

// (a - b) mod 2p: a - b, plus 2p when it borrowed.
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  const uint32_t two_p[L] = {FR_2P0, FR_2P1, FR_2P2, FR_2P3, FR_2P4, FR_2P5, FR_2P6, FR_2P7};
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint64_t t = static_cast<uint64_t>(a.v[l]) - b.v[l] - borrow;
    d.v[l] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  if (borrow) {
    uint64_t carry = 0u;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      uint64_t t = static_cast<uint64_t>(d.v[l]) + two_p[l] + carry;
      d.v[l] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
  }
  return d;
}

// Lazy representative [0, 2p) -> canonical [0, p).
__device__ __forceinline__ Fe canonical(const Fe& a) {
  const uint32_t p[L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  return cond_sub(a, p);
}

// Montgomery product REDC(a * b), CIOS over 32-bit words. The word-wise m
// digits form the unique m < R with a*b + m*p = 0 mod R, so the result is
// the same integer as the plain twin's digit-by-digit REDC.
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  const uint32_t p[L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      uint64_t s = static_cast<uint64_t>(t[j]) + static_cast<uint64_t>(a.v[j]) * b.v[i] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[L]) + c;
    t[L] = static_cast<uint32_t>(s);
    t[L + 1] = static_cast<uint32_t>(s >> 32);

    const uint32_t m = t[0] * FR_NP0;
    s = static_cast<uint64_t>(t[0]) + static_cast<uint64_t>(m) * p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = static_cast<uint64_t>(t[j]) + static_cast<uint64_t>(m) * p[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[L]) + c;
    t[L - 1] = static_cast<uint32_t>(s);
    t[L] = t[L + 1] + static_cast<uint32_t>(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = t[j];
  return r;
}

// t[0..8] += a * b (a: 8 words, b: one word) as two carry chains, the low
// halves of the eight products into t[0..7] (carry into t[8]), then the high
// halves into t[1..8]. The caller keeps t + a * b below 2^288, so no carry
// leaves t[8]. One asm block: the carry flag does not survive between blocks.
__device__ __forceinline__ void mac_row_ptx(uint32_t (&t)[L + 1], const uint32_t (&a)[L], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
}

// The same REDC(a * b) as mul, CIOS with inline-PTX carry chains
// (mad.lo.cc / madc.hi.cc / addc) and no 64-bit accumulators: the same 264
// 32-bit multiply results, another schedule. The m digits are unique mod R,
// so the result is the same integer as mul's. Bounds: a, b < 2p and t < 4p
// at the top of each step keep t + a * b_i + m * p below 2^288.
__device__ __forceinline__ Fe mul_ptx(const Fe& a, const Fe& b) {
  const uint32_t p[L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  uint32_t t[L + 1];
#pragma unroll
  for (int j = 0; j < L + 1; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    mac_row_ptx(t, a.v, b.v[i]);
    mac_row_ptx(t, p, t[0] * FR_NP0);  // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = t[j + 1];
    t[L] = 0u;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = t[j];
  return r;
}

// REDC of a 512-bit value t[0..15], word by word (separated operand
// scanning): t += m_i * p * 2^(32 i) for i = 0..7 with
// m_i = t[i] * (-p^-1) mod 2^32; the result t[8..15] is (t + m p) / R for
// the unique m < R, the integer mul returns for the same product. The
// caller keeps t + m p below 2^512.
__device__ __forceinline__ Fe redc_wide(uint32_t (&t)[2 * L]) {
  const uint32_t p[L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  uint32_t extra = 0u;  // carry owed to word i + L of the next step
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t m = t[i] * FR_NP0;
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(t[i + j]) + static_cast<uint64_t>(m) * p[j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    const uint64_t s = static_cast<uint64_t>(t[i + L]) + c + extra;
    t[i + L] = static_cast<uint32_t>(s);
    extra = static_cast<uint32_t>(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = t[L + j];
  return r;
}

// a * a (512 bits) into t: each cross product a_i a_j (i < j) once, the sum
// doubled by a one-bit shift, then the eight squares a_i^2 added in.
__device__ __forceinline__ void square_wide(const Fe& a, uint32_t (&t)[2 * L]) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = i + 1; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(t[i + j]) + static_cast<uint64_t>(a.v[i]) * a.v[j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + L] = static_cast<uint32_t>(c);
  }
#pragma unroll
  for (int k = 2 * L - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t sq = static_cast<uint64_t>(a.v[i]) * a.v[i];
    uint64_t s = static_cast<uint64_t>(t[2 * i]) + static_cast<uint32_t>(sq) + c;
    t[2 * i] = static_cast<uint32_t>(s);
    s = static_cast<uint64_t>(t[2 * i + 1]) + (sq >> 32) + (s >> 32);
    t[2 * i + 1] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
}

// REDC(a * a), the same integer as mul(a, a): 28 cross products (56
// results) and 8 squares (16) for the product against mul's 128, then the
// same 136-result reduction.
__device__ __forceinline__ Fe square(const Fe& a) {
  uint32_t t[2 * L];
  square_wide(a, t);
  return redc_wide(t);
}

// The 512-bit product a * b into t (no reduction), operand scanning with
// 64-bit accumulators: 64 widening products, 128 32-bit multiply results.
__device__ __forceinline__ void mul_wide(const Fe& a, const Fe& b, uint32_t (&t)[2 * L]) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(t[i + j]) + static_cast<uint64_t>(a.v[j]) * b.v[i] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + L] = static_cast<uint32_t>(c);
  }
}

// ---------------------------------------------------------------------------
// The latency-oriented product of the hash chain (csrc/mimc.cuh):
// finely integrated product scanning (FIPS). mul's CIOS runs 16 carry
// chains of 8 dependent 64-bit adds, one after another. Here the words of
// all word products go into the 64-bit sums of their output columns
// (carry-save: a column holds fewer than 40 words, so it stays below
// 2^38), and the word products are independent of one another. The words
// go in two at a time, as one three-input add and its carry: in a row of
// products x * w_j, the high word of x w_j and the low word of x w_(j+1)
// share a column. Only the reduction digits are serial:
// m_i = (column i, with the carry out of column i - 1) * (-p^-1) mod 2^32,
// and column i + 1 waits for m_i. The m_i are the digits of the unique
// m < R with T + m p = 0 mod R, so the result is the integer mul returns,
// bit for bit.
// ---------------------------------------------------------------------------

// The row x * w_j, j = j0..7, into the column sums of the product whose row
// index is i: column i + j0 takes the low word of x w_j0, column i + j + 1
// the high word of x w_j and the low word of x w_(j+1), column i + 8 the
// high word of x w_7.
__device__ __forceinline__ void fips_row(uint64_t (&cols)[2 * L], int i, int j0, uint32_t x,
                                         const uint32_t (&w)[L]) {
  uint64_t t[L];
#pragma unroll
  for (int j = j0; j < L; ++j) t[j] = static_cast<uint64_t>(x) * w[j];
  cols[i + j0] += static_cast<uint32_t>(t[j0]);
#pragma unroll
  for (int j = j0; j < L - 1; ++j)
    cols[i + j + 1] = cols[i + j + 1] + (t[j] >> 32) + static_cast<uint32_t>(t[j + 1]);
  cols[i + L] += t[L - 1] >> 32;
}

// REDC of T = sum_k cols[k] 2^(32 k) < 4p * 2^256: adds m_i p 2^(32 i)
// column by column and returns (T + m p) / R, words 8..15.
__device__ __forceinline__ Fe fips_redc(uint64_t (&cols)[2 * L]) {
  const uint32_t p[L] = {FR_P0, FR_P1, FR_P2, FR_P3, FR_P4, FR_P5, FR_P6, FR_P7};
  uint64_t carry = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t c = cols[i] + carry;  // column i, everything below it resolved
    const uint32_t m = static_cast<uint32_t>(c) * FR_NP0;
    // the low word of c + m p_0 is 0, so its carry out is the two high
    // words plus one unless that low word was 0 already
    const uint64_t mp0 = static_cast<uint64_t>(m) * p[0];
    carry = (c >> 32) + (mp0 >> 32) + (static_cast<uint32_t>(c) != 0u);
    fips_row(cols, i, 1, m, p);
  }
  Fe r;
#pragma unroll
  for (int k = L; k < 2 * L; ++k) {
    const uint64_t c = cols[k] + carry;
    r.v[k - L] = static_cast<uint32_t>(c);
    carry = c >> 32;
  }
  return r;
}

// REDC(a * b), the integer mul returns (a, b < 2p -> result < 2p).
__device__ __forceinline__ Fe mul_fips(const Fe& a, const Fe& b) {
  uint64_t cols[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) cols[k] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) fips_row(cols, i, 0, a.v[i], b.v);
  return fips_redc(cols);
}

// REDC(a * a), the integer mul(a, a) returns: the 28 cross products once,
// each column's cross sum doubled, then the 8 squares.
__device__ __forceinline__ Fe square_fips(const Fe& a) {
  uint64_t cols[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) cols[k] = 0u;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) fips_row(cols, i, i + 1, a.v[i], a.v);
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) cols[k] <<= 1;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint64_t t = static_cast<uint64_t>(a.v[i]) * a.v[i];
    cols[2 * i] += static_cast<uint32_t>(t);
    cols[2 * i + 1] += t >> 32;
  }
  return fips_redc(cols);
}

// c * x mod 2p for a small constant c >= 1, by doubling and adding from
// the top bit of c. Each add is exact mod 2p, so the result is the one
// representative of c * x in [0, 2p), whatever chain computed it.
__device__ __forceinline__ Fe mul_small(const Fe& x, uint32_t c) {
  Fe r = x;
  for (int b = 30 - __clz(c); b >= 0; --b) {
    r = add(r, r);
    if ((c >> b) & 1u) r = add(r, x);
  }
  return r;
}

// x^7 as square, mul, square, mul (the reference S-box chain).
__device__ __forceinline__ Fe pow7(const Fe& x) {
  Fe x2 = mul(x, x);
  Fe x3 = mul(x2, x);
  Fe x6 = mul(x3, x3);
  return mul(x6, x);
}

}  // namespace fr
