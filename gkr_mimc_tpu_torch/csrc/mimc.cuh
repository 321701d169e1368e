// The MiMC chain shared by the transcript-hash kernels (csrc/mimc_hash.cu,
// csrc/gruen_round.cu), so both run the same code on the same bits.
//
// Semantics (gkr_mimc_tpu/hashes/mimc.py:29-49, 75-78): for each word,
// res = word, then 91 rounds of res = (res + state + ark_i)^7, then the
// Miyaguchi-Preneel update state' = res + 2 * state + word. The word added
// at the end is the original message word, not the permuted value.
//
// Replaces the S-box chain of the TPU kernels mimc_hash_fs and
// mimc_hash_fs_g and of the fused round stage (gkr_mimc_tpu/ops/kernels.py
// :253, :1321, :1446), which runs fieldcore.pow7 on the MXU. Bound on the
// H100: the latency of one dependent chain, 91 S-boxes a word, nothing of
// it in parallel but the two middle products of an S-box; a lane moves a
// few hundred bytes. A product on one thread is some 540-660 SASS
// instructions at about two cycles each (`python -m
// gkr_mimc_tpu_torch.ops.probes sass` and `latency`), so a second product
// interleaved on the same thread mostly waits for issue slots, while a
// second thread of the warp runs it in the same instructions. The
// reference chain x^2, x^3, x^6, x^7 is four products deep. Here
// x^7 = x^3 x^4 with x^3 and x^4 both from x^2, three products deep, and
// the two products of the middle level run on two threads: each hash lane
// is a pair of neighbouring threads of a warp that hold the same chain;
// both square, the even thread multiplies x^2 by x, the odd one by x^2,
// and a shuffle hands each the other's factor for x^3 x^4. The products are
// fr::mul_fips / fr::square_fips (product scanning). The round constant of
// the next round is loaded while the current S-box runs, so no load waits
// on the chain. The representatives inside the chain differ from
// fr::pow7's; every output is canonical (or, in the round stage, a product
// of canonical values), so the outputs keep their bits.
//
// Every thread of a warp must call update() the same number of times (the
// shuffle takes the full warp).
#pragma once

#include "fr.cuh"

namespace mimc {

constexpr int kRounds = 91;

// x^7 three products deep; odd: this thread is the odd one of its pair.
__device__ __forceinline__ fr::Fe sbox(const fr::Fe& x, bool odd) {
  const fr::Fe x2 = fr::square_fips(x);
  // x^4 on the odd thread, x^3 on the even one; a mask, not a select of the
  // two structs, which ptxas would put in local memory
  const uint32_t mask = 0u - static_cast<uint32_t>(odd);
  fr::Fe y;
#pragma unroll
  for (int l = 0; l < fr::L; ++l) y.v[l] = (x2.v[l] & mask) | (x.v[l] & ~mask);
  const fr::Fe z = fr::mul_fips(x2, y);
  fr::Fe other;
#pragma unroll
  for (int l = 0; l < fr::L; ++l) other.v[l] = __shfl_xor_sync(0xffffffffu, z.v[l], 1);
  return fr::mul_fips(z, other);  // the same integer on both threads: REDC(a b) = REDC(b a)
}

// One hash update: arks is the (91, 8) table of Montgomery round constants.
__device__ __forceinline__ fr::Fe update(const fr::Fe& state, const fr::Fe& word,
                                         const int32_t* arks, bool odd) {
  fr::Fe res = word;
  fr::Fe ark = fr::load(arks, 1, 0);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const fr::Fe x = fr::add(fr::add(res, state), ark);
    if (r + 1 < kRounds) ark = fr::load(arks + (r + 1) * fr::L, 1, 0);  // the next round's, off the chain
    res = sbox(x, odd);
  }
  return fr::add(fr::add(res, fr::add(state, state)), word);
}

}  // namespace mimc
