"""GKR verifier (the reference's gkr_mimc_tpu/gkr/verifier.py).

Seed the output claim by evaluating the output table; per non-input layer
verify the sumcheck transcript and the final-claim consistency
expected = Gate(subclaims) * EvalUnivariate([EvalEq(qPrime_j, nextQ)]_j,
recombChal); check qPrime consistency between layers; check each input
table's evaluation.

Device part: the O(2**bn) multilinear evaluations of the output and input
tables (fold kernel) and every round challenge r = MimcHash(coeffs),
recomputed in one batched hash launch per coefficient-width class. Host
part: O(bn * nlayers) Horner chains on Python ints.
"""

from __future__ import annotations

import torch

from ..circuits.circuit import Circuit
from ..fields import fr, scalar
from ..fields.bn254 import L
from ..hashes.mimc import mimc_hash_batch
from ..poly import multilin
from ..poly.lagrange import eval_univariate
from ..sumcheck import verifier as sumcheck_verifier
from ..utils.convert import rows_to_ints
from .prover import GKRProof


class GKRError(Exception):
    pass


def _hash_coeff_rows(coeffs: list) -> torch.Tensor:
    """G tensors of (R, K, 8) round coefficients -> (G, R, 8) challenges
    MimcHash(coeffs), in one batched launch."""
    stacked = torch.stack(coeffs)  # (G, R, K, 8)
    g, r, k, _ = stacked.shape
    msgs = stacked.reshape(g * r, k, L).permute(2, 1, 0)  # (8, K, G*R)
    return mimc_hash_batch(msgs).T.reshape(g, r, L)


def verify(circuit: Circuit, proof: GKRProof, inputs: list, outputs: torch.Tensor,
           qprime: torch.Tensor) -> None:
    """inputs: (8, N) input tables; outputs: (8, N) output table; qprime:
    (bn, 8) rows. Raises GKRError if the proof is invalid."""
    nlayers = len(circuit)
    out_eval = multilin.evaluate(outputs, qprime)
    in_evals = [multilin.evaluate(inputs[l], proof.qprimes[l][0]) for l in range(len(inputs))]

    groups: dict = {}  # coefficient shape -> layers, one hash launch each
    for l, p in enumerate(proof.sumcheck_proofs):
        if p is not None and p.coeffs.shape[0]:
            groups.setdefault(tuple(p.coeffs.shape), []).append(l)
    chals_int: list = [[] if p is not None else None for p in proof.sumcheck_proofs]
    for layers in groups.values():
        rows = rows_to_ints(_hash_coeff_rows([proof.sumcheck_proofs[l].coeffs for l in layers]))
        for g, l in enumerate(layers):
            chals_int[l] = rows[g]

    claims_int = [rows_to_ints(c) if c is not None and c.shape[0] else [] for c in proof.claims]
    qprimes_int = [rows_to_ints(q) if q is not None and q.shape[0] else [] for q in proof.qprimes]
    coeffs_int = [rows_to_ints(p.coeffs) if p is not None else None for p in proof.sumcheck_proofs]

    if qprimes_int[nlayers - 1][0] != rows_to_ints(qprime):
        raise GKRError("initial qPrime does not match the proof")
    # the verifier computes the output claim itself
    claims_int[nlayers - 1] = claims_int[nlayers - 1] + [fr.to_int(out_eval)]

    for layer in range(nlayers - 1, -1, -1):
        if circuit.is_input_layer(layer):
            break
        _check_layer(circuit, coeffs_int, claims_int, qprimes_int, chals_int, layer)

    for layer, ev in enumerate(in_evals):
        got = fr.to_int(ev)
        if got != claims_int[layer][0]:
            raise GKRError(f"input layer {layer} check failed: claim {claims_int[layer][0]} != eval {got}")


def _check_layer(circuit, coeffs_int, claims_int, qprimes_int, chals_int, layer) -> None:
    try:
        next_qprime, next_claim, recomb_chal = sumcheck_verifier.verify(
            claims_int[layer], coeffs_int[layer], challenges=chals_int[layer]
        )
    except sumcheck_verifier.SumcheckError as e:
        raise GKRError(f"layer {layer}: {e}") from e

    sub_claims = []
    for inp in circuit[layer].in_:
        slot = circuit.out_slot(inp, layer)
        if qprimes_int[inp][slot] != next_qprime:
            raise GKRError(f"layer {layer}: qPrime mismatch into layer {inp}")
        sub_claims.append(claims_int[inp][slot])

    expected = circuit[layer].gate.eval_scalar(sub_claims)
    eq_evals = [multilin.eq_eval_scalar(qp, next_qprime) for qp in qprimes_int[layer]]
    expected = scalar.mul(expected, eval_univariate(eq_evals, recomb_chal))
    if expected != next_claim:
        raise GKRError(f"layer {layer}: final claim mismatch")
