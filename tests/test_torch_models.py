"""The port's GMiMC and Poseidon circuits (gkr_mimc_tpu_torch.models) against
the JAX package: the circuits, the generic witness assignment and the GKR
proofs.

Exactly two JAX walks run, both at bn = 2: GMiMC t = 2 and Poseidon
(t, RF, RP) = (2, 2, 3), in a module-scoped fixture that the comparisons
reuse (a cold JAX walk costs tens of seconds of tracing and compiling).
The file keeps to seven test cases on purpose: pytest-xdist's loadfile
mode hands out files with more test cases first, and a file of seven or
fewer goes after the long tests/test_snark.py, whose start sets the end
of a parallel run.
The port's proofs must equal them layer by layer on every round path and
head/tail split, exactly on canonical values. Everything else (GMiMC at
t = 4, the Poseidon T2 production configuration at bn = 1, both
full-state provers) is held against the host-int oracles and the port's
own verifier. Inputs come from numpy seeds. On the CPU the cipher gate's
``cipher_layer`` kernel takes its plain twin.

    python -m pytest tests/test_torch_models.py -q -p no:cacheprovider
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.circuits import circuit as jcircuit
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.gkr import prover as jax_gkr_prover
from gkr_mimc_tpu.models import gmimc as jgm
from gkr_mimc_tpu.models import poseidon as jps
from gkr_mimc_tpu.utils.convert import ints_to_rows as jax_ints_to_rows
from gkr_mimc_tpu.utils.convert import rows_to_ints as jax_rows_to_ints
from gkr_mimc_tpu_torch.circuits import circuit as circ_mod
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.models import gmimc as gm
from gkr_mimc_tpu_torch.models import poseidon as ps
from gkr_mimc_tpu_torch.sumcheck import prover as sp
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints

BN = 2
SMALL_POSEIDON = (2, 2, 3)  # t, RF, RP


def _field_ints(rng, n):
    """n field elements (canonical ints) from a numpy generator."""
    words = rng.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    return [sum(int(w) << (62 * i) for i, w in enumerate(row)) % P for row in words]


def _instance(seed, t, bn):
    """t block words and t state words of 2**bn instances, and qprime."""
    rng = np.random.default_rng(seed)
    n = 1 << bn
    blocks = [_field_ints(rng, n) for _ in range(t)]
    states = [_field_ints(rng, n) for _ in range(t)]
    return blocks, states, _field_ints(rng, bn)


def _col(words, i):
    return [w[i] for w in words]


def _model(kind, t=2):
    """(port circuit, JAX circuit, inputs from (blocks, states) word lists,
    output oracle of instance i) for one model."""
    if kind == "gmimc":
        w0 = gm.initial_word(t)
        return (gm.gmimc_circuit(t), jgm.gmimc_circuit(t), lambda b, s: list(b) + [s[w0]],
                lambda b, s, i: gm.permutation_word_scalar(t, _col(s, i), _col(b, i)))
    t, rf, rp = SMALL_POSEIDON
    return (ps.poseidon_circuit(t, rf, rp), jps.poseidon_circuit(t, rf, rp), lambda b, s: list(b) + list(s),
            lambda b, s, i: ps.permutation_word_scalar(t, rf, rp, _col(s, i), _col(b, i)))


def _proof_ints(proof, to_ints):
    """Per layer: (coeffs, challenges, final claims) of its sumcheck, its
    claims and its qprimes, as canonical ints (None where absent)."""
    def ints(x):
        return None if x is None or x.shape[0] == 0 else to_ints(x)

    return [
        (None if p is None else (to_ints(p.coeffs), to_ints(p.challenges), to_ints(p.final_claims)),
         ints(c), ints(q))
        for p, c, q in zip(proof.sumcheck_proofs, proof.claims, proof.qprimes)
    ]


@pytest.fixture(scope="module", params=["gmimc", "poseidon"])
def walk(request):
    """One model at bn = 2: the port's inputs and witness, and the JAX
    package's witness and walk (the two JAX walks of this file)."""
    c, jc, make_inputs, oracle = _model(request.param)
    blocks, states, qprime = _instance(11, 2, BN)
    words = make_inputs(blocks, states)
    inputs = [fr.from_ints_mont(w) for w in words]
    jinputs = [jfr.from_ints_mont(w) for w in words]
    ja = jcircuit.assign(jc, jinputs)
    jproof = jax_gkr_prover.prove(jc, ja, jnp.asarray(jax_ints_to_rows(qprime)))
    return {
        "c": c, "inputs": inputs, "qprime": ints_to_rows(qprime),
        "a": circ_mod.assign(c, inputs), "want_a": [jfr.to_ints(x) for x in ja],
        "want_proof": _proof_ints(jproof, jax_rows_to_ints),
        "oracle": [oracle(blocks, states, i) for i in range(1 << BN)],
        "scalar_a": circ_mod.assign_scalar(c, words),
    }


def test_walk_matches_jax(walk):
    """The witness against the JAX assignment and the host oracles; then
    the proof, layer by layer against the JAX walk, on every round path
    (tail_bits 1 puts a head round on every layer kind's kernel path:
    GMiMC's single-claim cipher layers on the Gruen rounds, Poseidon's
    two-claim ones on the coefficient-form rounds, the block copies' 14-46
    claims on the identity rounds), each verified; a flipped coefficient
    and a flipped claim must be rejected."""
    c, a, qprime, inputs = walk["c"], walk["a"], walk["qprime"], walk["inputs"]
    got = [fr.to_ints(x) for x in a]
    assert got == walk["want_a"] == walk["scalar_a"]
    assert got[-1] == walk["oracle"]
    assert c.input_arity() == len(inputs)
    for rounds, tail_bits in [("gruen", 8), ("gruen", 1), ("coeff", 1), ("evals", 1)]:
        proof = gkr_prover.prove(c, a, qprime, tail_bits, rounds=rounds)
        got = _proof_ints(proof, rows_to_ints)
        assert len(got) == len(walk["want_proof"])
        for layer, (g, w) in enumerate(zip(got, walk["want_proof"])):
            assert g == w, f"{rounds}, tail_bits {tail_bits}: layer {layer}"
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
    layer = len(c) // 2
    good = proof.sumcheck_proofs[layer]
    bad = good.coeffs.clone()
    bad.view(-1)[0] ^= 1
    proof.sumcheck_proofs[layer] = sp.SumcheckProof(bad, good.challenges, good.final_claims)
    with pytest.raises(gkr_verifier.GKRError):
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
    proof.sumcheck_proofs[layer] = good
    inp = c[layer].in_[1]
    bad = proof.claims[inp].clone()
    bad.view(-1)[0] ^= 1
    proof.claims[inp] = bad
    with pytest.raises(gkr_verifier.GKRError):
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)


def _jax_consts(gate):
    """The field constants of a JAX gate, in the port's ``consts`` order."""
    if gate is None:
        return None
    if hasattr(gate, "ark"):
        return (gate.ark,)
    if hasattr(gate, "c0"):
        return (gate.c0, gate.c1, gate.c2)
    if hasattr(gate, "coeffs"):
        return tuple(gate.coeffs) + ((gate.const,) if gate.const else ())
    return ()


def test_circuits_match_jax():
    """Wiring, gate kinds and gate constants, layer by layer, against the
    JAX circuits; and the production circuits' layer kinds: GMiMC T2 96
    layers (45 cipher, 46 affine, 2 identity, 3 inputs), Poseidon T2 (RF 8,
    RP 82) 397 (114 cipher, 82 affine, 195 linear, 2 identity, 4 inputs),
    the block copies carrying 45 and 46 claims, and 98."""
    for port, ref, name, args in [(gm, jgm, "gmimc_circuit", (2,)), (gm, jgm, "gmimc_circuit", (8, 3)),
                                     (ps, jps, "poseidon_circuit", (2, 8, 82)),
                                     (ps, jps, "poseidon_circuit", (4, 8, 83, 1))]:
        c, jc = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert len(c) == len(jc)
        for layer, jlayer in zip(c, jc):
            assert (layer.in_, layer.out) == (jlayer.in_, jlayer.out)
            assert type(layer.gate).__name__ == type(jlayer.gate).__name__
            assert (None if layer.gate is None else layer.gate.consts) == _jax_consts(jlayer.gate)

    def kinds(c):
        names = [type(l.gate).__name__ for l in c]
        return {n: names.count(n) for n in set(names)}

    g, p = gm.gmimc_circuit(2), ps.poseidon_circuit(2, 8, 82)
    assert kinds(g) == {"NoneType": 3, "CipherGate": 45, "AffineGate": 46, "IdentityGate": 2}
    assert kinds(p) == {"NoneType": 4, "CipherGate": 114, "AffineGate": 82, "LinearGate": 195, "IdentityGate": 2}
    assert [len(g[i].out) for i in (3, 4)] == [45, 46] and [len(p[i].out) for i in (4, 5)] == [98, 98]


def test_gmimc_t4_walk():
    """t = 4 at bn = 2: the witness against the JAX assignment (the gate
    programs of the t = 2 fixture, at the same shapes) and the host
    oracle; prove with head rounds and verify."""
    c, jc, make_inputs, oracle = _model("gmimc", t=4)
    blocks, states, qprime = _instance(12, 4, BN)
    words = make_inputs(blocks, states)
    a = circ_mod.assign(c, [fr.from_ints_mont(w) for w in words])
    ja = jcircuit.assign(jc, [jfr.from_ints_mont(w) for w in words])
    assert [fr.to_ints(x) for x in a] == [jfr.to_ints(x) for x in ja]
    assert fr.to_ints(a[-1]) == [oracle(blocks, states, i) for i in range(1 << BN)]
    q = ints_to_rows(qprime)
    gkr_verifier.verify(c, gkr_prover.prove(c, a, q, tail_bits=1), a[: len(words)], a[-1], q)


def test_poseidon_production_walk():
    """The production configuration Poseidon T2 (RF 8, RP 82) at bn = 1:
    the output table against the host permutation, prove, verify, and a
    tampered claim rejected."""
    t, rf, rp = 2, 8, 82
    blocks, states, qprime = _instance(13, t, 1)
    c = ps.poseidon_circuit(t, rf, rp)
    inputs = [fr.from_ints_mont(w) for w in ps.poseidon_inputs(blocks, states)]
    a = circ_mod.assign(c, inputs)
    assert fr.to_ints(a[-1]) == [ps.permutation_word_scalar(t, rf, rp, _col(states, i), _col(blocks, i))
                                 for i in range(2)]
    q = ints_to_rows(qprime)
    proof = gkr_prover.prove(c, a, q)
    gkr_verifier.verify(c, proof, inputs, a[-1], q)
    bad = proof.claims[200].clone()
    bad.view(-1)[0] ^= 1
    proof.claims[200] = bad
    with pytest.raises(gkr_verifier.GKRError):
        gkr_verifier.verify(c, proof, inputs, a[-1], q)


def test_full_state_proving():
    """Every output word of GMiMC T2 and Poseidon (2, 2, 3) proven and
    verified; word w's output table is word w of the host permutation."""
    t, (_, rf, rp) = 2, SMALL_POSEIDON
    blocks, states, qprime = _instance(14, t, BN)
    bt, st = [fr.from_ints_mont(w) for w in blocks], [fr.from_ints_mont(w) for w in states]
    q = ints_to_rows(qprime)
    runs = [
        (gm.prove_full_state(t, bt, st, q), lambda r: gm.verify_full_state(t, bt, st, q, r),
         lambda i, w: gm.permutation_word_scalar(t, _col(states, i), _col(blocks, i), w)),
        (ps.prove_full_state(t, rf, rp, bt, st, q), lambda r: ps.verify_full_state(t, bt, st, q, r),
         lambda i, w: ps.permutation_word_scalar(t, rf, rp, _col(states, i), _col(blocks, i), w)),
    ]
    for results, verify, oracle in runs:
        verify(results)
        assert len(results) == t
        for w, (_, a, _) in enumerate(results):
            assert fr.to_ints(a[-1]) == [oracle(i, w) for i in range(1 << BN)]


def test_grouped_assign_and_walk():
    """Grouped tables (8, G, N) go through assign and the GKR walk: each
    lane equals the single-instance walk of its inputs."""
    c, _, make_inputs, _ = _model("gmimc")
    lanes = [_instance(20 + g, 2, BN) for g in range(2)]
    words = [make_inputs(b, s) for b, s, _ in lanes]
    inputs = [torch.stack([fr.from_ints_mont(w[k]) for w in words], dim=1) for k in range(len(words[0]))]
    a = circ_mod.assign(c, inputs)
    q = torch.stack([ints_to_rows(qp) for _, _, qp in lanes], dim=1)
    proof = gkr_prover.prove(c, a, q, tail_bits=1)
    for g in range(2):
        single = gkr_prover.prove(c, [x[:, g].contiguous() for x in a], q[:, g].contiguous(), tail_bits=1)
        assert _proof_ints(gkr_verifier.slice_group(proof, g), rows_to_ints) == _proof_ints(single, rows_to_ints)
    gkr_verifier.verify_grouped(c, proof, inputs, a[-1], q)
