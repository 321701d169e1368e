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
