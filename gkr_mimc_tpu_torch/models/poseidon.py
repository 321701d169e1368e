"""Poseidon GKR circuit: the t-width keyed permutation through the GKR walk
(the reference's gkr_mimc_tpu/models/poseidon.py).

The reference has no Poseidon circuit (hash/poseidon.go:18-157 is hash-only);
this model expresses the same 2*RF+RP-round permutation as a layered GKR
circuit walked by the standard prover. Unlike GMiMC, the Cauchy MDS mixes
every word each round, so the full t-wide state stays live:

  per round r (1-based), with tmp[i] = s[i] + block[i] + Ark[r-1]:
    * t "S-box/ark" layers: full rounds apply x^7 to every word
      (CipherGate(ark) on (block-copy_i, s_i) — (vL+vR+ark)^7); partial
      rounds only to word 0 (words 1..t-1 get AffineGate(1,1,ark));
    * t "MDS" layers: s'_i = sum_j M[i][j] * tmp_j (LinearGate over the t
      tmp layers — each tmp layer therefore carries t claims).

  Final round: only MDS word `out_word` is live (the rest of the last
  state is dead for a single-output proof) — the circuit ends with that
  single MDS layer as the GKR output.

Layout: layers 0..t-1 inputs block[i]; t..2t-1 inputs state[i];
2t..3t-1 Identity copies of the block words (consumed every round);
then rounds of 2t layers each (t sbox + t MDS), last round t sbox + 1 MDS.
"""

from __future__ import annotations

from ..circuits import circuit as circ_mod
from ..circuits.circuit import Circuit, Layer
from ..circuits.gates import AffineGate, CipherGate, IdentityGate, LinearGate
from ..fields import scalar
from ..gkr import prover as gkr_prover
from ..gkr import verifier as gkr_verifier
from ..hashes.ark import ARKS_INT
from ..hashes.poseidon import generate_mds_matrix


def poseidon_circuit(t: int, n_rounds_f: int, n_rounds_p: int,
                     out_word: int = 0) -> Circuit:
    """GKR circuit for one Poseidon(t, RF, RP) permutation, output word
    `out_word` of the final state."""
    mds = generate_mds_matrix(t)
    n_rounds = 2 * n_rounds_f + n_rounds_p

    layers = [Layer(in_=[]) for _ in range(2 * t)]  # blocks then states
    for w in range(t):
        layers.append(Layer(in_=[w], gate=IdentityGate()))

    state = list(range(t, 2 * t))  # current state-word layer indices
    for r in range(1, n_rounds + 1):
        ark = ARKS_INT[r - 1]
        partial = n_rounds_f <= (r - 1) < n_rounds_f + n_rounds_p
        tmp = []
        for i in range(t):
            copy = 2 * t + i
            if partial and i > 0:
                gate = AffineGate(1, 1, ark)  # s_i + block_i + ark
            else:
                gate = CipherGate(ark)  # (s_i + block_i + ark)^7
            layers.append(Layer(in_=[copy, state[i]], gate=gate))
            tmp.append(len(layers) - 1)
        new_state = []
        rows = [out_word] if r == n_rounds else range(t)
        for i in rows:
            layers.append(Layer(in_=list(tmp), gate=LinearGate(mds[i])))
            new_state.append(len(layers) - 1)
        state = new_state
    return Circuit(layers)


def poseidon_inputs(blocks, states):
    """Assignment inputs: t block tables then t state tables."""
    return list(blocks) + list(states)


# ---------------------------------------------------------------------------
# Full-state proving: one walk per output word. Only the final MDS layer
# differs between the t circuits; each walk re-proves the shared trunk
# (capability-complete; trunk-sharing across walks is a future optimization).
# ---------------------------------------------------------------------------


def prove_full_state(t: int, n_rounds_f: int, n_rounds_p: int, blocks,
                     states, qprime):
    """Prove ALL t Poseidon permutation output words for a batch.
    Returns a list of t (circuit, assignment, proof) triples."""
    inputs = poseidon_inputs(blocks, states)
    results = []
    for w in range(t):
        c = poseidon_circuit(t, n_rounds_f, n_rounds_p, out_word=w)
        a = circ_mod.assign(c, inputs)
        proof = gkr_prover.prove(c, a, qprime)
        results.append((c, a, proof))
    return results


def verify_full_state(t: int, blocks, states, qprime, results) -> None:
    """Verify the t per-word proofs from prove_full_state; raises GKRError."""
    inputs = poseidon_inputs(blocks, states)
    for c, a, proof in results:
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)


def permutation_word_scalar(t: int, n_rounds_f: int, n_rounds_p: int,
                            state: list[int], block: list[int],
                            out_word: int = 0) -> int:
    """Host oracle: word `out_word` of the Poseidon permutation (before the
    Miyaguchi-Preneel addition, hash/poseidon.go semantics)."""
    mds = generate_mds_matrix(t)
    s = list(state)
    for r in range(2 * n_rounds_f + n_rounds_p):
        s = [scalar.add(scalar.add(x, block[i]), ARKS_INT[r]) for i, x in enumerate(s)]
        if n_rounds_f <= r < n_rounds_f + n_rounds_p:
            s[0] = scalar.pow7(s[0])
        else:
            s = [scalar.pow7(x) for x in s]
        s = [
            sum(scalar.mul(mds[i][j], s[j]) for j in range(t)) % scalar.P
            for i in range(t)
        ]
    return s[out_word]
