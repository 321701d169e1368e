// The fr::mul_ptx instantiation of the partial-evals kernel
// (gkr_cipher_partial_evals_ptx, the multiply A/B probe of ops/probes.py),
// compiled from csrc/partial_evals.cu in a translation unit of its own so
// that ops/build.py builds it in parallel with the production kernels.
#define GKR_PARTIAL_EVALS_PTX
#include "partial_evals.cu"
