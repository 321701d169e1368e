"""GMiMC GKR circuit: the t-width keyed permutation through the GKR walk
(the reference's gkr_mimc_tpu/models/gmimc.py).

The reference has no GMiMC circuit (hash/gmimc.go:8-74 is hash-primitive
only); this model pushes the same 91-round update through the identical GKR
layer walk the MiMC circuit uses (examples/mimc.go:10-37 is the pattern).

GMiMC's round (hash/gmimc.go:33-44 semantics) is
    tmp[i] = s[i] + block[i] + Ark[r];  tmp[0] = tmp[0]^7;  s' = rotl1(tmp)
so a single OUTPUT word of the permutation depends on exactly ONE state
word per round — the backward cone of ``s_91[out_word]`` is a width-1 chain
alternating AffineGate (word shift) and CipherGate (every t-th round, when
the chain crosses word 0). The GKR circuit is therefore a 91-layer chain:

    layer 0..t-1 : inputs  block[0..t-1]
    layer t      : input   initial state word w0 = (out_word + 91) % t
    layer t+1..2t: Identity fan-out copies of the block words (each block
                   word feeds ~91/t rounds -> multi-claim identity layers,
                   same pattern as the MiMC circuit's layer 2)
    layer 2t+1+k : round r = k+1; CipherGate(Ark[r-1]) when the chain
                   crosses word 0 (r % t == (out_word + 92) % t... see
                   ``_is_cipher``), else AffineGate(1,1,Ark[r-1]); inputs
                   (block-copy u_r, previous chain layer).

Proving the full t-word state = t walks of this circuit, one per out_word
(they share the witness assignment's block tables).
"""

from __future__ import annotations

from ..circuits import circuit as circ_mod
from ..circuits.circuit import Circuit, Layer
from ..circuits.gates import AffineGate, CipherGate, IdentityGate
from ..fields import scalar
from ..gkr import prover as gkr_prover
from ..gkr import verifier as gkr_verifier
from ..hashes.ark import ARKS_INT

GMIMC_ROUNDS = 91


def _word_at(out_word: int, r: int, t: int) -> int:
    """The state word the chain passes through after round r (w_91 =
    out_word, w_{r-1} = (w_r + 1) mod t)."""
    return (out_word + GMIMC_ROUNDS - r) % t


def gmimc_circuit(t: int, out_word: int = 0) -> Circuit:
    """The 91-layer GMiMC(t) permutation-word chain circuit."""
    if not 2 <= t <= GMIMC_ROUNDS:
        raise ValueError(f"t={t}: the chain needs 2 <= t <= {GMIMC_ROUNDS}")
    layers = [Layer(in_=[]) for _ in range(t + 1)]  # blocks + state word
    for w in range(t):
        layers.append(Layer(in_=[w], gate=IdentityGate()))
    prev = t  # the state-word input layer
    for r in range(1, GMIMC_ROUNDS + 1):
        w_r = _word_at(out_word, r, t)
        u_r = (w_r + 1) % t  # block word consumed this round
        copy = t + 1 + u_r
        ark = ARKS_INT[r - 1]
        if w_r == t - 1:
            gate = CipherGate(ark)  # (block + prev + ark)^7
        else:
            gate = AffineGate(1, 1, ark)  # block + prev + ark
        layers.append(Layer(in_=[copy, prev], gate=gate))
        prev = len(layers) - 1
    return Circuit(layers)


def gmimc_inputs(blocks, state_word):
    """Assignment inputs for gmimc_circuit: blocks = list of t (8, N)
    tables, state_word = the (8, N) table of initial state word w0."""
    return list(blocks) + [state_word]


def initial_word(t: int, out_word: int = 0) -> int:
    """Which initial state word the chain starts from."""
    return _word_at(out_word, 0, t)


def permutation_word_scalar(t: int, state: list[int], block: list[int],
                            out_word: int = 0) -> int:
    """Host oracle: word `out_word` of the 91-round GMiMC permutation
    (before the Miyaguchi-Preneel addition, hash/gmimc.go:42-44)."""
    s = list(state)
    for r in range(GMIMC_ROUNDS):
        s = [scalar.add(scalar.add(x, block[i]), ARKS_INT[r]) for i, x in enumerate(s)]
        s[0] = scalar.pow7(s[0])
        s = s[1:] + s[:1]
    return s[out_word]


# ---------------------------------------------------------------------------
# Full-state proving: one walk per output word (the t walks share the
# block tables; each chain circuit is 91 width-1 layers, so the t walks
# together still cost O(t * 91 * 2^bn) — the same order as one wide walk).
# ---------------------------------------------------------------------------


def prove_full_state(t: int, blocks, states, qprime):
    """Prove ALL t permutation output words for a batch.

    blocks: list of t (8, N) tables; states: list of t (8, N) tables
    (full initial state — each walk consumes its chain's start word).
    Returns a list of t (circuit, assignment, proof) triples, one per
    output word."""
    results = []
    for w in range(t):
        c = gmimc_circuit(t, out_word=w)
        inputs = gmimc_inputs(blocks, states[initial_word(t, w)])
        a = circ_mod.assign(c, inputs)
        proof = gkr_prover.prove(c, a, qprime)
        results.append((c, a, proof))
    return results


def verify_full_state(t: int, blocks, states, qprime, results) -> None:
    """Verify the t per-word proofs from prove_full_state; raises GKRError."""
    for w, (c, a, proof) in enumerate(results):
        inputs = gmimc_inputs(blocks, states[initial_word(t, w)])
        gkr_verifier.verify(c, proof, inputs, a[-1], qprime)
