"""The "coeff" head-round path (direct coefficient-form rounds) reproduces
the golden sumcheck transcripts of the cipher gate at bn = 1..3, and an
unknown path name raises.

The reference picks among the same three paths with its GKR_GRUEN and
GKR_COEFF_PE switches, and every one emits the same transcript: each
computes the same round polynomials exactly. Small tail_bits put the
rounds on the kernel paths; on the CPU every kernel wrapper takes its
plain twin. No JAX program runs here: the goldens and the "gruen" path are
already held against the JAX package (tests/test_torch_sumcheck*.py,
tests/test_torch_gkr*.py).

    python -m pytest tests/test_torch_rounds_golden_coeff.py -q -p no:cacheprovider
"""

import pytest

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit
from gkr_mimc_tpu_torch.sumcheck import prover, testing
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows
from torch_common import sumcheck_golden


@pytest.mark.parametrize("tail_bits", [2, 0])
@pytest.mark.parametrize("case", ["cipher_bn1", "cipher_bn2", "cipher_bn3"])
@pytest.mark.parametrize("rounds", ["coeff"])
def test_sumcheck_golden(rounds, case, tail_bits):
    """tail_bits 0 runs every round, down to a table of 2 entries, on the
    path"s head rounds."""
    got, want = sumcheck_golden(rounds, case, tail_bits)
    assert got == want


def test_unknown_rounds_raises():
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(2, "cpu")
    with pytest.raises(ValueError, match="rounds"):
        prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate,
                     rounds="gruen0")
    c = mimc_circuit()
    block = fr.encode_mont_ints(random_fr_array(4))
    with pytest.raises(ValueError, match="rounds"):
        gkr_prover.prove(c, assign_fused(block, block), ints_to_rows(random_fr_array(2)), rounds="direct")
