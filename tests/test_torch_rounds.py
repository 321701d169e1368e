"""The port's three head-round paths (``rounds`` = "gruen", "coeff",
"evals") give the same proofs: the full walks.

The direct coefficient-form path ("coeff") and the evaluation-form path
with the claim trick ("evals") must reproduce the golden proof vector and
equal the default ("gruen") walk, single and grouped. The sumcheck goldens
of the two paths are in tests/test_torch_rounds_golden_coeff.py,
tests/test_torch_rounds_golden_evals.py and tests/test_torch_rounds_multi.py
(seven cases or fewer a file, as tests/test_torch_models.py explains).

The reference picks among the same three paths with its GKR_GRUEN and
GKR_COEFF_PE switches, and every one emits the same transcript: each
computes the same round polynomials exactly. Small tail_bits put the
rounds on the kernel paths; on the CPU every kernel wrapper takes its
plain twin. No JAX program runs here: the goldens and the "gruen" path are
already held against the JAX package (tests/test_torch_sumcheck*.py,
tests/test_torch_gkr*.py).

    python -m pytest tests/test_torch_rounds*.py -q -p no:cacheprovider
"""

import pytest
import torch

from gkr_mimc_tpu_torch.circuits.circuit import Circuit, Layer
from gkr_mimc_tpu_torch.circuits.gates import CipherGate, IdentityGate
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.hashes.ark import ARKS_INT
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows
from torch_common import golden, mimc_instance

DIRECT = ["coeff", "evals"]


@pytest.mark.parametrize("rounds", DIRECT)
def test_golden_proof_vector(rounds):
    """The full MiMC walk at bn = 2 with head rounds (tail_bits = 1)."""
    want = golden()["gkr_mimc"]
    bn = want["bn"]
    block = fr.encode_mont_ints(random_fr_array(1 << bn))
    c = mimc_circuit()
    a = assign_fused(block, block.clone())
    qprime = ints_to_rows(random_fr_array(bn))
    proof = gkr_prover.prove(c, a, qprime, 1, rounds=rounds)
    assert [str(v) for v in proof_to_vec(c, proof)] == want["proof_vec"]


@pytest.fixture(scope="module")
def walk_bn4():
    """The bn = 4, tail_bits = 2 walk of tests/test_torch_gkr.py (the same
    inputs) on the default path."""
    c, block, state, qprime = mimc_instance(4)
    a = assign_fused(block, state)
    return c, block, state, qprime, a, proof_to_vec(c, gkr_prover.prove(c, a, qprime, tail_bits=2))


@pytest.mark.parametrize("rounds", DIRECT)
def test_walk_equals_gruen_walk(walk_bn4, rounds):
    c, block, state, qprime, a, want = walk_bn4
    proof = gkr_prover.prove(c, a, qprime, tail_bits=2, rounds=rounds)
    assert proof.sumcheck_proofs[93].coeffs.shape == (4, 9, 8)
    assert proof_to_vec(c, proof) == want
    gkr_verifier.verify(c, proof, [block, state], a[93], qprime)


def _truncated(k):
    """The MiMC circuit cut to its first k cipher layers."""
    layers = [Layer(in_=[]), Layer(in_=[]), Layer(in_=[0], gate=IdentityGate())]
    for i in range(k):
        layers.append(Layer(in_=[2, i + 2 if i else 1], gate=CipherGate(ARKS_INT[i])))
    return Circuit(layers)


@pytest.mark.parametrize("rounds", DIRECT)
def test_grouped_walk_lanes_equal_single_gruen_walks(rounds):
    """G = 2 at bn = 4 on the circuit cut to three cipher layers (the
    identity layer has three claims, so the combined claim of the evals
    path runs at two lanes): each lane equals the default single walk of
    its inputs."""
    bn, n, g = 4, 16, 2
    c = _truncated(3)
    block = torch.stack([fr.encode_mont_ints(random_fr_array((i + 1) * n)[i * n :]) for i in range(g)], dim=1)
    state = torch.stack([fr.encode_mont_ints(random_fr_array((i + 3) * n)[(i + 2) * n :]) for i in range(g)], dim=1)
    qprime = torch.stack([ints_to_rows(random_fr_array(bn + i)[i:]) for i in range(g)], dim=1)  # (bn, G, 8)
    a = assign_fused(block, state)[:6]
    proof = gkr_prover.prove(c, a, qprime, tail_bits=2, rounds=rounds)
    assert proof.sumcheck_proofs[5].coeffs.shape == (bn, 9, g, 8)
    for i in range(g):
        single = gkr_prover.prove(c, [t[:, i].contiguous() for t in a], qprime[:, i].contiguous(), tail_bits=2)
        assert proof_to_vec(c, gkr_verifier.slice_group(proof, i)) == proof_to_vec(c, single)
    gkr_verifier.verify_grouped(c, proof, [block, state], a[-1], qprime)
