"""The port's three head-round paths (``rounds`` = "gruen", "coeff",
"evals") give the same proofs.

The reference picks among the same three paths with its GKR_GRUEN and
GKR_COEFF_PE switches, and every one emits the same transcript: each
computes the same round polynomials exactly. Here the direct
coefficient-form path ("coeff") and the evaluation-form path with the claim
trick ("evals") must reproduce the golden transcripts and equal the default
("gruen") path, single and grouped. Small tail_bits put the rounds on the
kernel paths; on the CPU every kernel wrapper takes its plain twin. No JAX
program runs here: the goldens and the "gruen" path are already held
against the JAX package (tests/test_torch_sumcheck.py, test_torch_gkr.py).

    python -m pytest tests/test_torch_rounds.py -q -p no:cacheprovider
"""

import json
from pathlib import Path

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
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.poly import multilin
from gkr_mimc_tpu_torch.sumcheck import prover, testing
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints

GOLDEN = Path(__file__).resolve().parent / "golden" / "transcripts.json"
DIRECT = ["coeff", "evals"]


def _strs(x):
    return [_strs(v) for v in x] if isinstance(x, list) else str(x)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("tail_bits", [2, 0])
@pytest.mark.parametrize("case", ["cipher_bn1", "cipher_bn2", "cipher_bn3", "multi_bn3_j10"])
@pytest.mark.parametrize("rounds", DIRECT)
def test_sumcheck_golden(golden, rounds, case, tail_bits):
    """tail_bits 0 runs every round, down to a table of 2 entries, on the
    path's head rounds."""
    if case == "multi_bn3_j10":
        xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, "cpu")
    else:
        xs, claims, qps, gate = testing.initialize_cipher_gate_instance(int(case[-1]), "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate,
                       tail_bits, rounds=rounds)
    want = golden["sumcheck"][case]
    got = (_strs(rows_to_ints(scp.coeffs)), _strs(rows_to_ints(scp.challenges)), _strs(rows_to_ints(scp.final_claims)))
    assert got == (want["coeffs"], want["challenges"], want["final_claims"])


@pytest.mark.parametrize("rounds", DIRECT)
def test_golden_proof_vector(golden, rounds):
    """The full MiMC walk at bn = 2 with head rounds (tail_bits = 1)."""
    want = golden["gkr_mimc"]
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
    bn = 4
    block = fr.encode_mont_ints(random_fr_array(1 << bn))
    state = fr.encode_mont_ints(random_fr_array(1 << bn))
    qprime = ints_to_rows(random_fr_array(bn))
    c = mimc_circuit()
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


@pytest.mark.parametrize("bn, mul_scalar, multi_eq", [(12, 3, 0), (13, 0, 1)])
def test_single_claim_eq_table(monkeypatch, bn, mul_scalar, multi_eq):
    """One claim: below 2**13 entries the doubling build, whose steps on
    tables of at least 512 entries multiply through K.mul_scalar; from
    2**13 the hi/lo contraction with multiplier one and no RLC hash. Both
    give eq_table's values."""
    calls = {"mul_scalar": 0, "multi_eq": 0, "mimc_hash": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(K, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(K, name, counted)
    qprimes = ints_to_rows([random_fr_array(bn)])  # (1, bn, 8)
    got = prover._make_eq(qprimes, fr.zeros((1,)), prover.LO_BITS)
    assert calls == {"mul_scalar": mul_scalar, "multi_eq": multi_eq, "mimc_hash": 0}
    monkeypatch.undo()
    assert fr.to_ints(got) == fr.to_ints(multilin.eq_table(qprimes[0]))


def test_unknown_rounds_raises():
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(2, "cpu")
    with pytest.raises(ValueError, match="rounds"):
        prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate,
                     rounds="gruen0")
    c = mimc_circuit()
    block = fr.encode_mont_ints(random_fr_array(4))
    with pytest.raises(ValueError, match="rounds"):
        gkr_prover.prove(c, assign_fused(block, block), ints_to_rows(random_fr_array(2)), rounds="direct")
