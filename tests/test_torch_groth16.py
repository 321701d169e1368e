"""The port's Groth16 tier (gkr_mimc_tpu_torch.snark.r1cs,
gadget.{groth16,incircuit}) against the JAX package's, exactly: the
recording constraint system and its compiled R1CS, setup(seed) keys and
prove(seed) points, verification with its tampers and the sigma marking,
fix_solution, the in-circuit verifier's R1CS at bn = 1, the restored
padding check of the MiMC gadget, and one pipeline at bN = 0 through
GadgetCircuit (compile, setup, prove, verify, a tamper) on the CPU, its
sizes pinned to the JAX package's. Only host functions of the JAX package
run; no JAX program is traced.

    python -m pytest tests/test_torch_groth16.py -q -p no:cacheprovider
"""

import dataclasses

import pytest

from gkr_mimc_tpu.gadget import bn254_g1 as jg1
from gkr_mimc_tpu.gadget import bn254_g2 as jg2
from gkr_mimc_tpu.gadget import groth16 as jgroth16
from gkr_mimc_tpu.gadget.incircuit import Solution as JaxSolution
from gkr_mimc_tpu.models.mimc import mimc_circuit as jax_mimc_circuit
from gkr_mimc_tpu import snark as jsnark
from gkr_mimc_tpu.snark.r1cs import RecordingCS as JaxRecordingCS
from gkr_mimc_tpu_torch import native, snark
from gkr_mimc_tpu_torch.circuits.circuit import Circuit, Layer
from gkr_mimc_tpu_torch.circuits.gates import CipherGate, SBoxGate
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P
from gkr_mimc_tpu_torch.gadget import GadgetCircuit, GkrGadget, Solution
from gkr_mimc_tpu_torch.gadget import bn254_g1 as g1
from gkr_mimc_tpu_torch.gadget import bn254_g2 as g2
from gkr_mimc_tpu_torch.gadget import gadget as gadget_mod
from gkr_mimc_tpu_torch.gadget import groth16 as G
from gkr_mimc_tpu_torch.gadget.incircuit import setup as gadget_setup
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.hashes.mimc import mimc_keyed_permutation
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit
from gkr_mimc_tpu_torch.snark.r1cs import RecordingCS, UnsatisfiedConstraint
from gkr_mimc_tpu_torch.utils.convert import rows_to_ints
from torch_common import jax_proof, mimc_instance, no_cyclic_gc  # noqa: F401 (autouse)

# GadgetCircuit of the 1-hash define below at bN = 0, from the JAX package:
# gkr_mimc_tpu.gadget.incircuit.GadgetCircuit(define).compile() (run once,
# on the CPU): constraints, wires, public wires, partition sizes
# (pub gkr, priv gkr, pub not gkr, priv not gkr), and, with
# setup(compiled, seed=b"x") and prove(compiled, pk, vk, seed=b"y"), rho
JAX_PIPELINE_BN0 = (66_887, 66_980, 1, [0, 2, 1, 66_976])
JAX_PIPELINE_BN0_RHO = 12810502692539452797765805512636129090051377857268456071360736383555339063329


def _tiny(cs, rho=None):
    """tests/test_groth16.py's _tiny_r1cs: the rho placeholder, one public
    output and a few private products."""
    rho = jg1.derive_randomness_from_point(jg1.INF) if rho is None else rho
    cs.public_input(rho)
    out = cs.public_input(147)
    x = cs.witness(3)
    y = cs.witness(7)
    t = cs.mul(x, y)
    t2 = cs.mul(t, cs.add(x, cs.constant(4)))
    cs.assert_is_equal(t2, out)
    return cs, rho


def _keys_affine(key, g1_mod, g2_mod):
    """A key's fields with every point affine (Jacobian forms may differ)."""
    out = {}
    for name, v in dataclasses.asdict(key).items():
        if isinstance(v, tuple) and len(v) == 3 and isinstance(v[0], tuple):
            v = g2_mod.to_affine(v)
        elif isinstance(v, tuple) and len(v) == 3:
            v = g1_mod.to_affine(v)
        elif isinstance(v, list) and v and isinstance(v[0], tuple):
            mod = g2_mod if isinstance(v[0][0], tuple) else g1_mod
            v = [mod.to_affine(p) for p in v]
        out[name] = v
    return out


def test_recording_cs_matches_jax():
    """Linear ops are free, a product of variables is one constraint, an
    unsatisfied assertion raises; the compiled tiny R1CS equals the JAX
    package's (constraints, wire map, wires, public wires, values)."""
    cs = RecordingCS()
    a, b = cs.witness(5), cs.witness(6)
    c = cs.add(a, cs.mul(cs.constant(3), b))
    assert (c.value, cs.nb_constraints, len(c.lc)) == (23, 0, 2)
    assert cs.mul(c, c).value == 23 * 23 and cs.nb_constraints == 1
    assert cs.sub(a, b).value == P - 1 and cs.neg(a).value == P - 5
    with pytest.raises(UnsatisfiedConstraint):
        cs.assert_is_equal(a, cs.constant(2))
    with pytest.raises(snark.UnsatisfiedConstraint):  # one exception class for both systems
        cs.assert_is_equal(b, 7)

    r1cs = _tiny(RecordingCS())[0].compile()
    jr1cs = _tiny(JaxRecordingCS())[0].compile()
    r1cs.check()
    assert (r1cs.n_public, len(r1cs.constraints), r1cs.wires[0], r1cs.wires[2]) == (2, 3, 1, 147)
    assert dataclasses.asdict(r1cs) == dataclasses.asdict(jr1cs)
    r1cs.wires[4] += 1
    with pytest.raises(UnsatisfiedConstraint):
        r1cs.check()


def test_setup_and_prove_match_jax():
    """setup(seed) gives the JAX package's keys and prove(seed) its points;
    verify accepts, and rejects a wrong public value, a replaced
    KrsGkrPriv, a doubled Ar and a missing rho."""
    cs, rho = _tiny(RecordingCS())
    r1cs = cs.compile()
    n_priv = r1cs.n_wires - r1cs.n_public - 1
    partition = ([], [], [2], [r1cs.n_public + 1 + i for i in range(n_priv)])
    pk, vk = G.setup(r1cs, partition, seed=b"test-setup")
    jpk, jvk = jgroth16.setup(r1cs, partition, seed=b"test-setup")
    assert _keys_affine(pk, g1, g2) == _keys_affine(jpk, jg1, jg2)
    assert _keys_affine(vk, g1, g2) == _keys_affine(jvk, jg1, jg2)
    proof = G.prove(r1cs, pk, g1.INF, rho, seed=b"fixed")
    jproof = jgroth16.prove(r1cs, jpk, jg1.INF, rho, seed=b"fixed")
    assert _keys_affine(proof, g1, g2) == _keys_affine(jproof, jg1, jg2)
    G.verify(proof, vk, [rho, 147])
    assert g1.to_affine(G.prove(r1cs, pk, g1.INF, rho).ar) != g1.to_affine(proof.ar)  # fresh blinding

    for bad, public in ((proof, [rho, 148]),
                        (dataclasses.replace(proof, krs_gkr_priv=g1.scalar_mul(g1.to_jac(g1.GEN), 99)), [rho, 147]),
                        (dataclasses.replace(proof, ar=g1.scalar_mul(proof.ar, 2)), [rho, 147]),
                        (dataclasses.replace(proof, initial_randomness=0), [rho, 147]),
                        (proof, [rho])):
        with pytest.raises(G.Groth16VerifyError):
            G.verify(bad, vk, public)


def test_sigma_marking_blocks_key_mixing():
    """A commitment made with the sigma-marked keys verifies; the same
    scalars on keys without the mark re-derive a matching rho but fail the
    pairing check."""

    def with_extra(rho):
        cs = _tiny(RecordingCS(), rho)[0]
        x, y = cs.witness(42), cs.witness(5)
        cs.assert_is_equal(cs.mul(x, y), cs.constant(210))
        return cs.compile()

    r1cs = with_extra(None)
    priv = list(range(r1cs.n_public + 1, r1cs.n_wires))
    partition = ([], priv[-2:], [2], priv[:-2])
    pk, vk = G.setup(r1cs, partition, seed=b"sigma")
    z = r1cs.wires
    for keys, ok in ((pk.priv_k_gkr_sigma, True),
                     ([g1.scalar_mul(pt, pow(17, g1.R - 2, g1.R)) for pt in pk.priv_k_gkr_sigma], False)):
        commit = native.msm(keys, [z[w] for w in priv[-2:]])
        rho = g1.derive_randomness_from_point(commit)
        proof = G.prove(with_extra(rho), pk, commit, rho, seed=b"p")
        if ok:
            G.verify(proof, vk, [rho, 147])
        else:
            with pytest.raises(G.Groth16VerifyError, match="pairing"):
                G.verify(proof, vk, [rho, 147])


def test_fix_solution_semantics():
    """The placeholder (1, 0, c != 0) with wire 1 unset becomes (1, c, c)
    and wire 1 = c, as the JAX package's; anything else raises."""
    for cls in (Solution, JaxSolution):
        s = cls(wires=[1, 0, 5], abc=[(2, 3, 6), (1, 0, 77)])
        s.fix_solution()
        assert (s.abc[-1], s.wires[1]) == ((1, 77, 77), 77)
    for wires, abc in (([1, 0, 5], [(1, 1, 77)]), ([1, 9, 5], [(1, 0, 77)]), ([1, 0, 5], [(2, 0, 77)]),
                       ([1, 0, 5], [(1, 0, 0)])):
        with pytest.raises(ValueError):
            Solution(wires=list(wires), abc=list(abc)).fix_solution()


def test_in_circuit_r1cs_matches_jax_at_bn1():
    """The in-circuit GKR verifier over the port's bn = 1 proof, traced on
    the recording system: the JAX package's trace of the same proof (JAX
    layout) records the same constraints, wires and values."""
    c, block, state, qprime = mimc_instance(1)
    a = assign_fused(block, state)
    proof = gkr_prover.prove(c, a, qprime)

    def trace(cs, mod, circuit, p):
        proof_var = mod.Proof.assign(cs, circuit, p)
        inputs = [mod.MultiLin.from_ints(cs, fr.to_ints(a[l])) for l in (0, 1)]
        outputs = mod.MultiLin.from_ints(cs, fr.to_ints(a[-1]))
        proof_var.assert_valid(cs, circuit, [cs.witness(q) for q in rows_to_ints(qprime)], inputs, outputs)
        return cs

    got = trace(RecordingCS(), snark, c, proof)
    want = trace(JaxRecordingCS(), jsnark, jax_mimc_circuit(), jax_proof(proof))
    assert got.nb_constraints > 300_000
    assert (got.wire_public, got.wire_values) == (want.wire_public, want.wire_values)
    assert got.abc == want.abc
    assert got.constraints == want.constraints


def test_hash_of_zeroes_padding_check(monkeypatch):
    """The MiMC-91 gadget's padding output is _HASH_OF_ZEROES = Perm_0(0),
    and a wrong constant trips the assertion; a circuit of another length
    pads with its own output on zeros, unchecked."""
    assert gadget_mod._HASH_OF_ZEROES == mimc_keyed_permutation(0, 0)
    assert GkrGadget(device="cpu")._pad_output() == gadget_mod._HASH_OF_ZEROES
    small = Circuit([Layer(in_=[]), Layer(in_=[]), Layer(in_=[0, 1], gate=CipherGate(7)),
                     Layer(in_=[2], gate=SBoxGate())])
    assert gadget_mod.zero_output(small) == pow(7, 49, P)
    monkeypatch.setattr(gadget_mod, "_HASH_OF_ZEROES", gadget_mod._HASH_OF_ZEROES + 1)
    with pytest.raises(AssertionError):
        GkrGadget(device="cpu")._pad_output()
    with pytest.raises(AssertionError):
        gadget_mod.zero_output(mimc_circuit())
    assert gadget_mod.zero_output(small) == pow(7, 49, P)


def test_pipeline_bn0():
    """GadgetCircuit over one hash (the JAX package's
    test_gadget_pipeline_end_to_end define) through compile, setup, prove
    and verify on the CPU: its sizes and rho are the JAX package's; the
    batched hasher gives the looped one's constraint count; a replaced
    KrsGkrPriv is rejected."""

    def define(cs, gadget):
        gadget.update_hasher(cs, cs.constant(0), cs.witness(12))

    def define_batch(cs, gadget):
        gadget.update_hasher_batch(cs, [cs.constant(0)], [cs.witness(12)])

    circ = GadgetCircuit(define, device="cpu")
    compiled = circ.compile()
    r1cs = compiled.r1cs
    sizes = (len(r1cs.constraints), r1cs.n_wires, r1cs.n_public, [len(p) for p in compiled.partition])
    assert sizes == JAX_PIPELINE_BN0 and compiled.bn == 0
    batched = GadgetCircuit(define_batch, device="cpu").compile()
    assert len(batched.r1cs.constraints) == len(r1cs.constraints)
    pk, vk = gadget_setup(compiled, seed=b"x")
    proof, public_values = circ.prove(compiled, pk, vk, seed=b"y")
    assert proof.initial_randomness == public_values[0] == JAX_PIPELINE_BN0_RHO
    G.verify(proof, vk, public_values)
    with pytest.raises(G.Groth16VerifyError):
        G.verify(dataclasses.replace(proof, krs_gkr_priv=g1.scalar_mul(g1.to_jac(g1.GEN), 123)), vk, public_values)
