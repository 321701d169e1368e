"""The port's GKR walk on the MiMC-91 circuit against the JAX package.

The golden vector (tests/golden/transcripts.json) is the JAX package's own
bn = 2 proof, which tests/test_golden.py holds against the JAX walk; the
port must reproduce it bit for bit, with and without kernel-path head
rounds. At bn = 4 on the circuit cut to three cipher layers the walk with
head rounds must equal the JAX walk, and a grouped walk of two instances
must equal the JAX walk lane by lane.

    python -m pytest tests/test_torch_gkr_jax.py -q -p no:cacheprovider
"""

import jax.numpy as jnp
import pytest
import torch

from gkr_mimc_tpu.circuits import circuit as jcircuit
from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.gadget.serialize import proof_to_vec as jax_proof_to_vec
from gkr_mimc_tpu.gkr import prover as jax_gkr_prover
from gkr_mimc_tpu_torch.circuits.circuit import Circuit, Layer
from gkr_mimc_tpu_torch.circuits.gates import CipherGate, IdentityGate
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.hashes.ark import ARKS_INT
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, to_jax_rows
from torch_common import golden, mimc_instance


@pytest.mark.parametrize("tail_bits", [8, 1])
def test_golden_proof_vector(monkeypatch, tail_bits):
    """The golden walk, the tail rounds of its 91 cipher layers and of its
    identity layer each in one call of the tail_rounds wrapper (the gate
    inside it, never through cipher_layer)."""
    want = golden()["gkr_mimc"]
    c, block, state, qprime = mimc_instance(want["bn"])
    assert [str(v) for v in fr.to_ints(qprime.T.contiguous())] == want["qprime"]
    a = assign_fused(block, state)
    calls = []
    monkeypatch.setattr(K, "tail_rounds", lambda *args, _f=K.tail_rounds: calls.append(1) or _f(*args))
    monkeypatch.setattr(K, "cipher_layer", lambda *args: pytest.fail("cipher_layer called in a tail"))
    proof = gkr_prover.prove(c, a, qprime, tail_bits)
    assert len(calls) == 92
    assert [str(v) for v in fr.to_ints(a[93])] == want["outputs"]
    assert [str(v) for v in proof_to_vec(c, proof)] == want["proof_vec"]
    gkr_verifier.verify(c, proof, [block, state], a[93], qprime)


def _truncated(k):
    """The MiMC circuit cut to its first k cipher layers, port and JAX."""
    layers = [Layer(in_=[]), Layer(in_=[]), Layer(in_=[0], gate=IdentityGate())]
    jlayers = [jcircuit.Layer(in_=[]), jcircuit.Layer(in_=[]), jcircuit.Layer(in_=[0], gate=jgates.IdentityGate())]
    for i in range(k):
        inp = [2, i + 2 if i else 1]
        layers.append(Layer(in_=inp, gate=CipherGate(ARKS_INT[i])))
        jlayers.append(jcircuit.Layer(in_=inp, gate=jgates.CipherGate(ARKS_INT[i])))
    return Circuit(layers), jcircuit.Circuit(jlayers)


def _jax_walk_vec(jc, tables, qprime):
    """The JAX package's single-instance walk -> its proof_to_vec."""
    jproof = jax_gkr_prover.prove(
        jc, [jnp.asarray(to_jax_rows(t)) for t in tables], jnp.asarray(to_jax_rows(qprime.T.contiguous()).T)
    )
    return jax_proof_to_vec(jc, jproof)


@pytest.fixture(scope="module")
def truncated_bn4():
    """bn = 4 on the MiMC circuit cut to its first three cipher layers,
    with the JAX walk's vector: the same layer kinds (91-claim fan-out
    aside, here 3 claims), at a cost a CPU test can pay (the JAX walk of
    all 94 layers runs ~30 s here even when compiled)."""
    k, bn = 3, 4
    c, jc = _truncated(k)
    _, block, state, qprime = mimc_instance(bn)
    a = assign_fused(block, state)[: 3 + k]
    return c, jc, block, state, qprime, a, _jax_walk_vec(jc, a, qprime)


def test_truncated_walk_matches_jax(truncated_bn4):
    """bn = 4 with head rounds (tail_bits = 2) against the JAX walk."""
    c, _, block, state, qprime, a, want = truncated_bn4
    proof = gkr_prover.prove(c, a, qprime, tail_bits=2)
    assert proof_to_vec(c, proof) == want
    gkr_verifier.verify(c, proof, [block, state], a[-1], qprime)


def test_grouped_truncated_walk_matches_jax_lanes(truncated_bn4):
    """G = 2 at bn = 4 with head rounds (tail_bits = 2), so the fused
    Gruen stage and the identity rounds run at two lanes: lane 0 is the
    instance above, lane 1 has its own block, state and qprime. Each lane
    equals the JAX single-instance walk of its inputs."""
    c, jc, block0, state0, qprime0, _, want0 = truncated_bn4
    bn, n = 4, 16
    block1, state1 = (fr.encode_mont_ints(random_fr_array(off + n)[off:]) for off in (n, 3 * n))
    qprime1 = ints_to_rows(random_fr_array(bn + 1)[1:])
    block, state = torch.stack([block0, block1], dim=1), torch.stack([state0, state1], dim=1)
    qprime = torch.stack([qprime0, qprime1], dim=1)  # (bn, G, 8)
    a = assign_fused(block, state)[:6]
    proof = gkr_prover.prove(c, a, qprime, tail_bits=2)
    assert proof.sumcheck_proofs[5].coeffs.shape == (bn, 9, 2, 8)
    assert proof_to_vec(c, gkr_verifier.slice_group(proof, 0)) == want0
    want1 = _jax_walk_vec(jc, [t[:, 1].contiguous() for t in a], qprime1)
    assert proof_to_vec(c, gkr_verifier.slice_group(proof, 1)) == want1
    gkr_verifier.verify_grouped(c, proof, [block, state], a[-1], qprime)
