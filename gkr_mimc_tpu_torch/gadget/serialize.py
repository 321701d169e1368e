"""GKR proof <-> flat field-element vector in the reference wire format
(gkr_mimc_tpu/gadget/serialize.py): all sumcheck coefficients (layer
order, round-major), then all claims, then all qPrimes, as regular-form
ints. The sizes come from the circuit and bN alone."""

from __future__ import annotations

import torch

from ..circuits.circuit import Circuit
from ..fields.bn254 import L
from ..gkr.prover import GKRProof
from ..sumcheck.prover import SumcheckProof
from ..utils.convert import ints_to_rows, rows_to_ints


def bn_from_input_size(circuit: Circuit, n_inputs: int) -> int:
    """bN from the length of a ``qPrime || inputs || outputs`` vector:
    n = 2**bN * (arity + 1) + bN."""
    arity = circuit.input_arity()
    bn = 0
    while True:
        size = (1 << bn) * (arity + 1) + bn
        if size == n_inputs:
            return bn
        if size > n_inputs:
            raise ValueError(f"input size {n_inputs} matches no bN for arity {arity}")
        bn += 1


def proof_size(circuit: Circuit, bn: int) -> int:
    """Number of field elements in the serialized proof."""
    sumcheck_size = claims_size = qprime_size = 0
    for layer in circuit:
        if layer.gate is not None:
            sumcheck_size += bn * (layer.gate.degree + 2)
        claims_size += len(layer.out)
        qprime_size += bn * len(layer.out)
    qprime_size += bn  # the output layer's initial qPrime
    return sumcheck_size + claims_size + qprime_size


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


def proof_from_vec(circuit: Circuit, bn: int, vec: list[int], device="cuda") -> GKRProof:
    """Inverse of ``proof_to_vec``: a GKRProof for ``gkr.verifier.verify``
    with its rows (..., 8) on ``device``, the card unless the caller names
    another. Only the coefficients, claims and qPrimes travel: the verifier
    recomputes the challenges."""
    if len(vec) != proof_size(circuit, bn):
        raise ValueError(f"vector has {len(vec)} elements, expected {proof_size(circuit, bn)}")
    cursor = 0

    def take(n: int) -> list[int]:
        nonlocal cursor
        chunk = vec[cursor : cursor + n]
        cursor += n
        return chunk

    def rows(values, empty_shape) -> torch.Tensor:
        if not values:
            return torch.zeros(empty_shape + (L,), dtype=torch.int32, device=device)
        return ints_to_rows(values, device)

    nlayers = len(circuit)
    sumcheck_proofs: list = [None] * nlayers
    for l, layer in enumerate(circuit):
        if layer.gate is not None:
            rounds = [take(layer.gate.degree + 2) for _ in range(bn)]
            sumcheck_proofs[l] = SumcheckProof(rows(rounds, (0, layer.gate.degree + 2)), None, None)
    claims = [rows(take(len(layer.out)), (0,)) for layer in circuit]
    qprimes = []
    for l, layer in enumerate(circuit):
        nq = len(layer.out) if l != nlayers - 1 else 1
        qprimes.append(rows([take(bn) for _ in range(nq)], (0, bn)))
    if cursor != len(vec):
        raise ValueError("the vector was not completely read")
    return GKRProof(sumcheck_proofs, claims, qprimes)
