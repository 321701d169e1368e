"""The port's sumcheck prover against the golden transcripts
(tests/golden/transcripts.json, the JAX package's own): the cipher gate at
bn = 1..3 with and without kernel-path head rounds, and the empty proof at
bn = 0. tests/test_torch_sumcheck_jax.py holds the prover and the verifier
against the JAX package (seven cases or fewer a file, as
tests/test_torch_models.py explains).

With tail_bits = 1 the port runs its kernel-path head rounds (Gruen rounds
for the cipher gate) before the generic tail; the round polynomials are
the same field values, so transcripts must be equal.

    python -m pytest tests/test_torch_sumcheck*.py -q -p no:cacheprovider
"""

import pytest
import torch

from gkr_mimc_tpu_torch.sumcheck import prover, testing
from torch_common import golden as load_golden
from torch_common import strs, transcript


@pytest.fixture(scope="module")
def golden():
    return load_golden()["sumcheck"]


@pytest.mark.parametrize("tail_bits", [8, 1])
@pytest.mark.parametrize("bn", [1, 2, 3])
def test_cipher_golden(golden, bn, tail_bits):
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tail_bits)
    coeffs, chals, final = transcript(scp)
    want = golden[f"cipher_bn{bn}"]
    assert (strs(coeffs), strs(chals), strs(final)) == (want["coeffs"], want["challenges"], want["final_claims"])


def test_bn0_empty_proof():
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(0, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate)
    assert scp.coeffs.shape == (0, 9, 8) and scp.challenges.shape == (0, 8)
    assert scp.final_claims.dtype == torch.int32 and scp.final_claims.shape == (3, 8)
