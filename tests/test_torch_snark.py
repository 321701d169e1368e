"""The port's in-circuit verifier (gkr_mimc_tpu_torch.snark, the gates'
gnark_eval, poly.multilin.evaluate_scalar) against the JAX package's and
the port's host oracles, exactly: in-circuit MiMC, the polynomials, every
gate, the sumcheck on the port's fixtures, and the GKR verifier at bn = 2
over the port's CPU proof (the JAX verifier reads the same proof through
the JAX layout). No JAX program is traced: only the JAX package's host
functions run.

    python -m pytest tests/test_torch_snark.py -q -p no:cacheprovider
"""

import random

import pytest

from gkr_mimc_tpu import snark as jsnark
from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.models.mimc import mimc_circuit as jax_mimc_circuit
from gkr_mimc_tpu.poly import multilin as jmultilin
from gkr_mimc_tpu.snark.cs import ConstraintSystem as JaxCS
from gkr_mimc_tpu.snark.r1cs import RecordingCS as JaxRecordingCS
from gkr_mimc_tpu_torch import snark
from gkr_mimc_tpu_torch.circuits import gates
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.poly import multilin
from gkr_mimc_tpu_torch.snark.cs import ConstraintSystem, UnsatisfiedConstraint
from gkr_mimc_tpu_torch.snark.r1cs import RecordingCS
from gkr_mimc_tpu_torch.sumcheck import prover as sc_prover
from gkr_mimc_tpu_torch.sumcheck import testing as sc_testing
from gkr_mimc_tpu_torch.sumcheck import verifier as sc_verifier
from gkr_mimc_tpu_torch.utils.common import get_challenge, random_fr_array
from gkr_mimc_tpu_torch.utils.convert import rows_to_ints
from torch_common import jax_proof, mimc_instance, no_cyclic_gc  # noqa: F401 (autouse)

BN = 2
GKR_CONSTRAINTS_BN2 = 667_961  # the JAX verifier's count on the same proof (checked below)


def test_in_circuit_mimc_matches_host_and_jax():
    """The in-circuit hash equals the host hash and the transcript's
    challenge, with 4 constraints a round, as the JAX package's."""
    msgs = random_fr_array(3)
    cs, jcs = ConstraintSystem(), JaxCS()
    out = snark.mimc_hash(cs, *[cs.witness(m) for m in msgs])
    jout = jsnark.mimc_hash(jcs, *[jcs.witness(m) for m in msgs])
    assert out.value == mimc_hash(msgs) == get_challenge(msgs) == jout.value
    assert cs.nb_multiplications == jcs.nb_multiplications == 3 * 91 * 4
    assert cs.nb_constraints == jcs.nb_constraints


def test_polynomials_match_jax():
    """Univariate (Horner, p(0) + p(1)), MultiLin (fold, eval), eq and the
    host evaluate_scalar, values and constraint counts."""
    rng = random.Random(11)
    cs = ConstraintSystem()
    p = snark.Univariate.from_ints(cs, [1, 2, 3])
    assert p.eval(cs, cs.witness(5)).value == 86 and p.zero_and_one(cs).value == 7
    cs, jcs = ConstraintSystem(), JaxCS()
    coeffs = [rng.randrange(P) for _ in range(9)]
    x = rng.randrange(P)
    got = snark.Univariate.from_ints(cs, coeffs)
    want = jsnark.Univariate.from_ints(jcs, coeffs)
    assert got.eval(cs, cs.witness(x)).value == want.eval(jcs, jcs.witness(x)).value
    assert got.zero_and_one(cs).value == want.zero_and_one(jcs).value

    values, point = random_fr_array(8), random_fr_array(3)
    assert multilin.evaluate_scalar(values, point) == jmultilin.evaluate_scalar(values, point)
    m = snark.MultiLin.from_ints(cs, values).eval(cs, [cs.witness(v) for v in point])
    jm = jsnark.MultiLin.from_ints(jcs, values).eval(jcs, [jcs.witness(v) for v in point])
    assert m.value == jm.value == multilin.evaluate_scalar(values, point)

    q, h = random_fr_array(4), [rng.randrange(P) for _ in range(4)]
    e = snark.eq_eval(cs, [cs.witness(v) for v in q], [cs.witness(v) for v in h])
    je = jsnark.eq_eval(jcs, [jcs.witness(v) for v in q], [jcs.witness(v) for v in h])
    assert e.value == je.value == multilin.eq_eval_scalar(q, h)
    u = snark.univariate_eq_eval(cs, cs.witness(q[0]), cs.constant(h[0]))
    assert u.value == jsnark.univariate_eq_eval(jcs, jcs.witness(q[0]), jcs.constant(h[0])).value
    assert (cs.nb_constraints, cs.nb_wires) == (jcs.nb_constraints, jcs.nb_wires)


def test_gnark_eval_matches_jax():
    """Each of the seven gates inside the circuit: the JAX gate's value and
    constraints on the same ints, and the gate's own host value."""
    rng = random.Random(5)
    pairs = [(gates.CipherGate(12345), jgates.CipherGate(12345)), (gates.IdentityGate(), jgates.IdentityGate()),
             (gates.AddGate(), jgates.AddGate()), (gates.MulGate(), jgates.MulGate()),
             (gates.SBoxGate(), jgates.SBoxGate()),
             (gates.LinearGate([3, P - 1, 7], 11), jgates.LinearGate([3, P - 1, 7], 11)),
             (gates.LinearGate([2, 5]), jgates.LinearGate([2, 5])),
             (gates.AffineGate(4, P - 2, 9), jgates.AffineGate(4, P - 2, 9))]
    for gate, jgate in pairs:
        xs = [rng.randrange(P) for _ in range(gate.arity)]
        cs, jcs = ConstraintSystem(), JaxCS()
        got = gate.gnark_eval(cs, [cs.witness(x) for x in xs])
        want = jgate.gnark_eval(jcs, [jcs.witness(x) for x in xs])
        assert got.value == want.value == gate.eval_scalar(xs), gate.name
        assert cs.nb_constraints == jcs.nb_constraints, gate.name
    with pytest.raises(NotImplementedError):
        gates.Gate().gnark_eval(ConstraintSystem(), [])


@pytest.mark.parametrize("fixture", ["cipher", "multi"])
def test_in_circuit_sumcheck(fixture):
    """The port's sumcheck proof on its fixtures satisfies the in-circuit
    sumcheck, with the host verifier's challenges, final claim and
    recombination challenge, and the JAX in-circuit sumcheck's."""
    if fixture == "cipher":
        xs, claims, qprimes, gate = sc_testing.initialize_cipher_gate_instance(BN, "cpu")
    else:
        xs, claims, qprimes, gate = sc_testing.initialize_multi_instance(BN, 5, "cpu")
    scp = sc_prover.prove(xs, sc_testing.to_device_qprimes(qprimes, "cpu"), sc_testing.to_device_claims(claims, "cpu"),
                          gate)
    coeffs = rows_to_ints(scp.coeffs)
    want = sc_verifier.verify(claims, coeffs)
    cs, jcs = ConstraintSystem(), JaxCS()
    hs, final, recomb = snark.SumcheckProof.from_ints(cs, coeffs).assert_valid(cs, [cs.witness(c) for c in claims])
    jhs, jfinal, jrecomb = jsnark.SumcheckProof.from_ints(jcs, coeffs).assert_valid(jcs, [jcs.witness(c) for c in claims])
    assert ([h.value for h in hs], final.value, recomb.value) == want
    assert ([h.value for h in jhs], jfinal.value, jrecomb.value) == want
    assert cs.nb_constraints == jcs.nb_constraints


@pytest.fixture(scope="module")
def gkr_bn2():
    """The port's MiMC-91 walk at bn = 2 on the CPU: circuit, witness,
    qPrime ints, proof."""
    c, block, state, qprime = mimc_instance(BN)
    a = assign_fused(block, state)
    return c, a, rows_to_ints(qprime), gkr_prover.prove(c, a, qprime)


def _assert_valid(cs, snark_mod, circuit, a, qprime_int, proof):
    proof_var = snark_mod.Proof.assign(cs, circuit, proof)
    inputs = [snark_mod.MultiLin.from_ints(cs, fr.to_ints(a[l])) for l in (0, 1)]
    outputs = snark_mod.MultiLin.from_ints(cs, fr.to_ints(a[-1]))
    proof_var.assert_valid(cs, circuit, [cs.witness(q) for q in qprime_int], inputs, outputs)
    return cs


def test_in_circuit_gkr_matches_jax(gkr_bn2):
    """The JAX verifier on the port's proof (JAX layout) and the port's,
    both traced on recording systems: valid, 667,961 constraints each, the
    same wire values and the same (a, b, c) values constraint by
    constraint."""
    c, a, qprime_int, proof = gkr_bn2
    rcs = _assert_valid(RecordingCS(), snark, c, a, qprime_int, proof)
    jrcs = _assert_valid(JaxRecordingCS(), jsnark, jax_mimc_circuit(), a, qprime_int, jax_proof(proof))
    assert rcs.nb_constraints == jrcs.nb_constraints == GKR_CONSTRAINTS_BN2
    assert rcs.wire_values == jrcs.wire_values
    assert rcs.abc == jrcs.abc


def test_in_circuit_gkr_rejects_tamper(gkr_bn2):
    """On the counting system: the proof holds at 667,961 constraints; with
    one coefficient of layer 50's sumcheck changed, UnsatisfiedConstraint."""
    c, a, qprime_int, proof = gkr_bn2
    assert _assert_valid(ConstraintSystem(), snark, c, a, qprime_int, proof).nb_constraints == GKR_CONSTRAINTS_BN2
    scp = proof.sumcheck_proofs[50]
    bad = scp.coeffs.clone()
    bad[1, 2] = fr.encode_mont_ints([rows_to_ints(bad[1, 2]) ^ 3]).T[0]
    tampered = gkr_prover.GKRProof(list(proof.sumcheck_proofs), proof.claims, proof.qprimes)
    tampered.sumcheck_proofs[50] = sc_prover.SumcheckProof(bad, scp.challenges, scp.final_claims)
    with pytest.raises(UnsatisfiedConstraint):
        _assert_valid(ConstraintSystem(), snark, c, a, qprime_int, tampered)
