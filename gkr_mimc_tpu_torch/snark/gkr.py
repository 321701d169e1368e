"""In-circuit GKR verifier (the counterpart of gkr_mimc_tpu/snark/gkr.py).

The relation the reference enforces as Groth16 constraints: the initial
qPrime, the output layer's claim computed by the verifier, each layer's
sumcheck and claim recombination against the gate, qPrime consistency
between layers, and the input layers' multilinear evaluations. It reads
the port's ``GKRProof`` (rows with the limb axis last, on any device)
through ``rows_to_ints``.
"""

from __future__ import annotations

from ..circuits.circuit import Circuit
from ..gkr.prover import GKRProof
from ..utils.convert import rows_to_ints
from .cs import ConstraintSystem, Variable
from .polynomial import MultiLin, Univariate, eq_eval
from .sumcheck import SumcheckProof


class Proof:
    """Variable-level GKR proof: sumcheck proofs, claims and qPrimes indexed
    [layer][consumer slot]."""

    def __init__(self, sumcheck_proofs, claims, qprimes):
        self.sumcheck_proofs = sumcheck_proofs  # [layer] -> SumcheckProof | None
        self.claims = claims  # [layer] -> list[Variable]
        self.qprimes = qprimes  # [layer] -> list[list[Variable]]

    @classmethod
    def assign(cls, cs: ConstraintSystem, circuit: Circuit, proof: GKRProof) -> "Proof":
        """Allocate the proof's values as witnesses (gnark's Allocate and
        Assign in one step, since values are eager)."""
        nlayers = len(circuit)
        sps: list = [None] * nlayers
        claims: list = [None] * nlayers
        qprimes: list = [None] * nlayers
        for l in range(nlayers):
            p = proof.sumcheck_proofs[l]
            if p is not None:
                sps[l] = SumcheckProof.from_ints(cs, rows_to_ints(p.coeffs))
            c = proof.claims[l]
            claims[l] = [cs.witness(v) for v in rows_to_ints(c)] if c is not None and c.shape[0] else []
            q = proof.qprimes[l]
            qprimes[l] = [[cs.witness(v) for v in qs] for qs in rows_to_ints(q)] if q is not None and q.shape[0] else []
        return cls(sps, claims, qprimes)

    def assert_valid(self, cs: ConstraintSystem, circuit: Circuit, qprime: list[Variable],
                     inputs: list[MultiLin], outputs: MultiLin) -> None:
        nlayers = len(circuit)

        for k, q in enumerate(qprime):
            cs.assert_is_equal(self.qprimes[nlayers - 1][0][k], q)

        old_claims = self.claims[nlayers - 1]
        self.claims[nlayers - 1] = old_claims + [outputs.eval(cs, qprime)]
        try:
            for layer in range(nlayers - 1, -1, -1):
                if len(circuit[layer].in_) < 1:
                    break
                self._test_sumcheck(cs, circuit, layer)
            for layer in range(len(inputs)):
                self._test_initial_round(cs, inputs, layer)
        finally:
            self.claims[nlayers - 1] = old_claims  # the proof object stays as assigned

    def _test_sumcheck(self, cs: ConstraintSystem, circuit: Circuit, layer: int) -> None:
        next_qprime, next_claim, recomb_chal = self.sumcheck_proofs[layer].assert_valid(cs, self.claims[layer])

        sub_claims = []
        for inp_l in circuit[layer].in_:
            read_at = circuit.out_slot(inp_l, layer)
            for k, q in enumerate(next_qprime):
                cs.assert_is_equal(self.qprimes[inp_l][read_at][k], q)
            sub_claims.append(self.claims[inp_l][read_at])

        expected = circuit[layer].gate.gnark_eval(cs, sub_claims)
        evals = Univariate(eq_eval(cs, qs, next_qprime) for qs in self.qprimes[layer])
        expected = cs.mul(expected, evals.eval(cs, recomb_chal))
        cs.assert_is_equal(expected, next_claim)

    def _test_initial_round(self, cs: ConstraintSystem, inputs, layer: int) -> None:
        actual = inputs[layer].eval(cs, self.qprimes[layer][0])
        cs.assert_is_equal(actual, self.claims[layer][0])
