"""GKR proof -> flat field-element vector in the reference wire format
(gkr_mimc_tpu/gadget/serialize.py:55-71): all sumcheck coefficients (layer
order, round-major), then all claims, then all qPrimes, as regular-form
ints."""

from __future__ import annotations

from ..circuits.circuit import Circuit
from ..gkr.prover import GKRProof
from ..utils.convert import rows_to_ints


def proof_to_vec(circuit: Circuit, proof: GKRProof) -> list[int]:
    del circuit  # the layout needs only the proof; kept for the reference's signature
    out: list[int] = []
    for p in proof.sumcheck_proofs:
        if p is not None:
            for rnd in rows_to_ints(p.coeffs):
                out.extend(rnd)
    for c in proof.claims:
        if c is not None and c.shape[0]:
            out.extend(rows_to_ints(c))
    for q in proof.qprimes:
        if q is not None and q.shape[0]:
            for qs in rows_to_ints(q):
                out.extend(qs)
    return out
