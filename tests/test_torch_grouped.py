"""The port's grouped mode: G independent instances in one sumcheck or one
GKR walk, against the JAX package.

Every lane's proof must equal the single-instance proof of that lane's
inputs (the G axis is batching, never visible in a transcript), and the
grouped artifacts must carry the G axis where the JAX package puts it,
just before the limb axis. With small tail_bits the port runs its head
rounds (Gruen rounds through the fused round stage, coefficient-form
identity rounds) at G lanes; on the CPU every kernel wrapper takes its
plain twin.

The grouped GKR walk on the truncated circuit is checked lane by lane
against the JAX walk in tests/test_torch_gkr.py, which shares the JAX
program and the lane-0 walk with the single-instance comparison there.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu.sumcheck import testing as jtesting
from gkr_mimc_tpu.utils.convert import rows_to_ints as jax_rows_to_ints
from gkr_mimc_tpu_torch.circuits.gates import CipherGate
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit
from gkr_mimc_tpu_torch.sumcheck import prover as sp
from gkr_mimc_tpu_torch.utils.common import grouped_inputs, random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints

GOLDEN = Path(__file__).resolve().parent / "golden" / "transcripts.json"


@pytest.fixture(scope="module")
def grouped_sumcheck_case():
    """The instances of tests/test_grouped.py (bn = 3, G = 3), and the JAX
    package's grouped proof of them."""
    bn, g = 3, 3
    xs_int, qps_int, claims_int = [], [], []
    for i in range(g):
        _, claims, qps, gate = jtesting.initialize_cipher_gate_instance(bn)
        xs_int.append([v + 7 * i for v in range(1 << bn)])
        qps_int.append([q + i + 1 for q in qps[0]])
        claims_int.append(claims[0] + i)
    jxs = jnp.stack([jfr.from_ints_mont(v) for v in xs_int], axis=1)  # (16, G, N)
    jqps = jnp.stack([jfr.from_ints_mont(q).T[None] for q in qps_int], axis=2)  # (1, bn, G, 16)
    jclaims = jfr.from_ints_mont(claims_int)[:, None]  # (16, 1, G)
    want = jsp.prove([jxs, jxs], jqps, jclaims, gate)
    xs = torch.stack([fr.from_ints_mont(v) for v in xs_int], dim=1)  # (8, G, N)
    qprimes = ints_to_rows([qps_int]).transpose(1, 2).contiguous()  # (1, bn, G, 8)
    claims = fr.from_ints_mont(claims_int)[:, None]  # (8, 1, G)
    return (xs, qprimes, claims), want


@pytest.mark.parametrize("tail_bits", [8, 1])
def test_grouped_sumcheck_matches_jax(grouped_sumcheck_case, tail_bits):
    """tail_bits 8: all-generic rounds over a G axis; tail_bits 1: two
    fused Gruen head rounds at G = 3, then the generic tail."""
    (xs, qprimes, claims), want = grouped_sumcheck_case
    got = sp.prove([xs, xs], qprimes, claims, CipherGate(145646), tail_bits)
    assert got.coeffs.shape == (3, 9, 3, 8)
    assert (got.challenges.shape, got.final_claims.shape) == ((3, 3, 8), (3, 3, 8))
    assert rows_to_ints(got.coeffs) == jax_rows_to_ints(want.coeffs)
    assert rows_to_ints(got.challenges) == jax_rows_to_ints(want.challenges)
    assert rows_to_ints(got.final_claims) == jax_rows_to_ints(want.final_claims)


def test_grouped_inputs_follow_the_reference_streams():
    """Lane i: block at stream offset i*n, state at (G+i)*n, qprime
    random_fr_array(bn + i)[i:] (bench.py:260-277)."""
    bn, g = 3, 3
    n = 1 << bn
    block, state, qprime = grouped_inputs(bn, g, device="cpu")
    assert (block.shape, state.shape, qprime.shape) == ((8, g, n), (8, g, n), (bn, g, 8))
    stream = random_fr_array(2 * g * n)
    for i in range(g):
        assert fr.to_ints(block[:, i].contiguous()) == stream[i * n : (i + 1) * n]
        assert fr.to_ints(state[:, i].contiguous()) == stream[(g + i) * n : (g + i + 1) * n]
        assert rows_to_ints(qprime[:, i]) == random_fr_array(bn + i)[i:]


@pytest.fixture(scope="module")
def golden_pair():
    """A G = 2 walk of the full circuit at bn = 2: lane 0 holds the golden
    instance, lane 1 other inputs."""
    want = json.loads(GOLDEN.read_text())["gkr_mimc"]
    bn = want["bn"]
    n = 1 << bn
    gold, other = random_fr_array(n), random_fr_array(2 * n)[n:]
    block = torch.stack([fr.encode_mont_ints(gold), fr.encode_mont_ints(other)], dim=1)
    state = torch.stack([fr.encode_mont_ints(gold), fr.encode_mont_ints(other[::-1])], dim=1)
    qprime = ints_to_rows([random_fr_array(bn), random_fr_array(bn + 1)[1:]]).transpose(0, 1).contiguous()
    c = mimc_circuit()
    a = assign_fused(block, state)
    return want, c, block, state, qprime, a, gkr_prover.prove(c, a, qprime)


def test_grouped_walk_lane0_is_golden(golden_pair):
    want, c, _, _, _, a, proof = golden_pair
    assert a[93].shape == (8, 2, 4)
    assert [str(v) for v in fr.to_ints(a[93][:, 0].contiguous())] == want["outputs"]
    assert [str(v) for v in proof_to_vec(c, gkr_verifier.slice_group(proof, 0))] == want["proof_vec"]
    assert proof.sumcheck_proofs[50].coeffs.shape == (2, 9, 2, 8)
    assert proof.claims[2].shape == (91, 2, 8) and proof.qprimes[2].shape == (91, 2, 2, 8)


def test_verify_grouped_accepts_and_names_the_tampered_group(golden_pair):
    _, c, block, state, qprime, a, proof = golden_pair
    gkr_verifier.verify_grouped(c, proof, [block, state], a[93], qprime)
    p = proof.sumcheck_proofs[50]
    bad = p.coeffs.clone()
    bad[0, 0, 1, 0] ^= 1
    proof.sumcheck_proofs[50] = sp.SumcheckProof(bad, p.challenges, p.final_claims)
    try:
        with pytest.raises(gkr_verifier.GKRError, match="group 1"):
            gkr_verifier.verify_grouped(c, proof, [block, state], a[93], qprime)
    finally:
        proof.sumcheck_proofs[50] = p
