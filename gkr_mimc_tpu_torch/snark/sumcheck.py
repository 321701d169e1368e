"""In-circuit sumcheck verifier (the counterpart of
gkr_mimc_tpu/snark/sumcheck.py).

A round asserts P(0) + P(1) == claim, takes the challenge as the in-circuit
MimcHash of the coefficients, and moves the claim to P(challenge). A
layer's claims are first recombined with the coefficient MimcHash(claims),
one claim included, as the prover's transcript does.
"""

from __future__ import annotations

from .cs import ConstraintSystem, Variable
from .hash import mimc_hash
from .polynomial import Univariate


class SumcheckProof(list):
    """bN rounds of Univariate coefficients."""

    @classmethod
    def from_ints(cls, cs: ConstraintSystem, rounds: list[list[int]]) -> "SumcheckProof":
        return cls(Univariate.from_ints(cs, r) for r in rounds)

    def assert_valid(self, cs: ConstraintSystem, initial_claims: list[Variable]):
        """-> (qPrime, final claim, recombination challenge)."""
        claim, recomb_chal = _recombine_multi_claims(cs, initial_claims)
        hs = []
        for poly in self:
            cs.assert_is_equal(poly.zero_and_one(cs), claim)
            h = mimc_hash(cs, *poly)
            hs.append(h)
            claim = poly.eval(cs, h)
        return hs, claim, recomb_chal


def _recombine_multi_claims(cs: ConstraintSystem, claims: list[Variable]):
    """coeff = MimcHash(claims); the combined claim is the univariate with
    the claims as coefficients, at coeff."""
    challenge = mimc_hash(cs, *claims)
    return Univariate(claims).eval(cs, challenge), challenge
