// The MiMC chain shared by the transcript-hash kernels (csrc/mimc_hash.cu,
// csrc/gruen_round.cu), so both run the same code on the same bits.
//
// Semantics (gkr_mimc_tpu/hashes/mimc.py:29-49, 75-78): for each word,
// res = word, then 91 rounds of res = (res + state + ark_i)^7, then the
// Miyaguchi-Preneel update state' = res + 2 * state + word. The word added
// at the end is the original message word, not the permuted value.
#pragma once

#include "fr.cuh"

namespace mimc {

constexpr int kRounds = 91;

// One hash update: arks is the (91, 8) table of Montgomery round constants.
__device__ __forceinline__ fr::Fe update(const fr::Fe& state, const fr::Fe& word,
                                         const int32_t* arks) {
  fr::Fe res = word;
  for (int r = 0; r < kRounds; ++r) {
    const fr::Fe ark = fr::load(arks + r * fr::L, 1, 0);
    res = fr::pow7(fr::add(fr::add(res, state), ark));
  }
  return fr::add(fr::add(res, fr::add(state, state)), word);
}

}  // namespace mimc
