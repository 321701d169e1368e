"""GKR prover: the output -> input layer walk (the reference's
gkr_mimc_tpu/gkr/prover.py:60-141).

Walk layers from the output down to the first input layer; per layer run
one (multi-claim) sumcheck over the layer's input tables; hand each final
claim and the next qPrime to the consumer slot of the producing layer
(slots ordered by the sorted Out list).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..circuits.circuit import Circuit
from ..sumcheck import prover as sumcheck_prover
from ..sumcheck.prover import SumcheckProof


@dataclass
class GKRProof:
    """Indexed [layer]; entries are None for input layers.

    sumcheck_proofs[l]: SumcheckProof of layer l
    claims[l]:  (J_l[, G], 8) Montgomery rows, J_l = len(out) claims
                ((0[, G], 8) for the output layer: the verifier computes its
                claim itself)
    qprimes[l]: (J_l, bn[, G], 8) Montgomery rows

    A grouped proof (G instances in one walk) carries the G axis just
    before the limb axis of every artifact; ``gkr.verifier.slice_group``
    takes one instance out.
    """

    sumcheck_proofs: list[Optional[SumcheckProof]]
    claims: list[Optional[torch.Tensor]]
    qprimes: list[Optional[torch.Tensor]]


def prove(circuit: Circuit, assignment: list, qprime: torch.Tensor,
          tail_bits: int = sumcheck_prover.TAIL_BITS, rounds: str = "gruen") -> GKRProof:
    """assignment: (8, N) tables, one per layer; qprime: (bn, 8) rows, the
    initial evaluation point. tail_bits and rounds pass to every layer's
    sumcheck (``sumcheck.prover.prove``): rounds picks the head-round path,
    "gruen", "coeff" or "evals", and does not change the proof.

    Grouped (G independent instances in one walk; the transcript hashes of
    all lanes run in lockstep): assignment tables (8, G, N), qprime
    (bn, G, 8) with one evaluation point per lane."""
    return walk(circuit, assignment, qprime,
                lambda xs, qprimes, claims, gate: sumcheck_prover.prove(xs, qprimes, claims, gate, tail_bits,
                                                                        rounds=rounds))


def walk(circuit: Circuit, assignment, qprime: torch.Tensor, sumcheck) -> GKRProof:
    """The layer walk with ``sumcheck(xs, qprimes, claims, gate)`` proving
    each layer: ``assignment[j]`` is read once per consuming layer, in
    descending layer order (the sharded walk passes its local tables and
    its sharded sumcheck)."""
    nlayers = len(circuit)
    claim_store = [[None] * len(l.out) for l in circuit]
    qprime_store = [[None] * len(l.out) for l in circuit]
    proofs: list = [None] * nlayers
    claims_out: list = [None] * nlayers
    qprimes_out: list = [None] * nlayers

    qprimes_out[nlayers - 1] = qprime[None]
    claims_out[nlayers - 1] = qprime.new_zeros((0,) + tuple(qprime.shape[1:]))

    for layer in range(nlayers - 1, -1, -1):
        if circuit.is_input_layer(layer):
            break
        if layer == nlayers - 1:
            qprimes, claims = qprimes_out[layer], None
        else:
            qprimes = torch.stack(qprime_store[layer], dim=0)
            claim_rows = torch.stack(claim_store[layer], dim=0)  # (J[, G], 8)
            qprimes_out[layer] = qprimes
            claims_out[layer] = claim_rows
            claims = claim_rows.movedim(-1, 0).contiguous()  # (8, J[, G])
        xs = [assignment[j] for j in circuit[layer].in_]
        scp = sumcheck(xs, qprimes, claims, circuit[layer].gate)
        proofs[layer] = scp
        for i, inp in enumerate(circuit[layer].in_):
            slot = circuit.out_slot(inp, layer)
            claim_store[inp][slot] = scp.final_claims[1 + i]
            qprime_store[inp][slot] = scp.challenges

    # claims and qPrimes of the input layers feed the verifier's input checks
    for layer in range(nlayers):
        if circuit.is_input_layer(layer) and claim_store[layer] and claim_store[layer][0] is not None:
            claims_out[layer] = torch.stack(claim_store[layer], dim=0)
            qprimes_out[layer] = torch.stack(qprime_store[layer], dim=0)
    return GKRProof(proofs, claims_out, qprimes_out)
