"""The "evals" head-round path (evaluation-form rounds with the claim
trick) reproduces the golden sumcheck transcripts of the cipher gate at
bn = 1..3.

The reference picks among the same three paths with its GKR_GRUEN and
GKR_COEFF_PE switches, and every one emits the same transcript: each
computes the same round polynomials exactly. Small tail_bits put the
rounds on the kernel paths; on the CPU every kernel wrapper takes its
plain twin. No JAX program runs here: the goldens and the "gruen" path are
already held against the JAX package (tests/test_torch_sumcheck*.py,
tests/test_torch_gkr*.py).

    python -m pytest tests/test_torch_rounds_golden_evals.py -q -p no:cacheprovider
"""

import pytest

from torch_common import sumcheck_golden


@pytest.mark.parametrize("tail_bits", [2, 0])
@pytest.mark.parametrize("case", ["cipher_bn1", "cipher_bn2", "cipher_bn3"])
@pytest.mark.parametrize("rounds", ["evals"])
def test_sumcheck_golden(rounds, case, tail_bits):
    """tail_bits 0 runs every round, down to a table of 2 entries, on the
    path"s head rounds."""
    got, want = sumcheck_golden(rounds, case, tail_bits)
    assert got == want
