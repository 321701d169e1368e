"""The port's GKR walk and verifier on the MiMC-91 circuit at bn = 4.

The walk with head rounds (tail_bits = 2) must give the permutation as its
output table, equal the all-generic walk, pass the port's verifier, and
fail it once a coefficient, a claim or a qPrime is tampered with.
tests/test_torch_gkr_jax.py holds the walk against the golden vector and
the JAX walk (seven cases or fewer a file, as tests/test_torch_models.py
explains).

    python -m pytest tests/test_torch_gkr*.py -q -p no:cacheprovider
"""

import pytest

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.hashes.mimc import mimc_keyed_permutation
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from torch_common import mimc_instance


@pytest.fixture(scope="module")
def walk_bn4():
    c, block, state, qprime = mimc_instance(4)
    a = assign_fused(block, state)
    return c, block, state, qprime, a, gkr_prover.prove(c, a, qprime, tail_bits=2)


def test_witness_output_is_the_permutation(walk_bn4):
    _, _, _, _, a, _ = walk_bn4
    vals = random_fr_array(16)
    assert fr.to_ints(a[93]) == [mimc_keyed_permutation(v, v) for v in vals]


def test_head_rounds_match_generic_walk(walk_bn4):
    c, _, _, qprime, a, proof = walk_bn4
    generic = gkr_prover.prove(c, a, qprime, tail_bits=8)
    assert proof_to_vec(c, proof) == proof_to_vec(c, generic)


def test_verifier_accepts(walk_bn4):
    c, block, state, qprime, a, proof = walk_bn4
    gkr_verifier.verify(c, proof, [block, state], a[93], qprime)


@pytest.mark.parametrize("where", ["coeff", "claim", "qprime"])
def test_verifier_rejects_tampering(walk_bn4, where):
    c, block, state, qprime, a, proof = walk_bn4
    if where == "coeff":
        target, setter = proof.sumcheck_proofs[50].coeffs, lambda t: setattr(proof.sumcheck_proofs[50], "coeffs", t)
    elif where == "claim":
        target, setter = proof.claims[2], lambda t: proof.claims.__setitem__(2, t)
    else:
        target, setter = proof.qprimes[40], lambda t: proof.qprimes.__setitem__(40, t)
    bad = target.clone()
    bad.view(-1)[0] ^= 1
    setter(bad)
    try:
        with pytest.raises(gkr_verifier.GKRError):
            gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    finally:
        setter(target)
