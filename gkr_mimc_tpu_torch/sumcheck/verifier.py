"""Sumcheck verifier on host Python ints (the reference's
gkr_mimc_tpu/sumcheck/verifier.py)."""

from __future__ import annotations

from ..fields import scalar
from ..poly.lagrange import eval_univariate
from ..utils.common import get_challenge


class SumcheckError(Exception):
    pass


def recombine_multi_claims(claims: list[int]) -> tuple[int, int]:
    """-> (combined claim, recombination challenge)."""
    if len(claims) < 1:
        raise SumcheckError("no claims to recombine")
    challenge = get_challenge(claims)
    return eval_univariate(claims, challenge), challenge


def verify(claims: list[int], proof: list[list[int]], challenges=None):
    """proof: per round, the (deg+2) univariate coefficients (ints).

    `challenges` optionally supplies the per-round challenges
    MimcHash(coeffs) recomputed by the verifier itself (the GKR verifier
    batches them on the device). Returns (challenges, final_claim,
    recomb_chal); raises SumcheckError on a bad proof."""
    expected, recomb_chal = recombine_multi_claims(claims)
    out_challenges = []
    for i, coeffs in enumerate(proof):
        actual = scalar.add(eval_univariate(coeffs, 0), eval_univariate(coeffs, 1))
        if actual != expected:
            raise SumcheckError(f"round {i}: P(0)+P(1) = {actual} != expected {expected}")
        r = challenges[i] if challenges is not None else get_challenge(coeffs)
        out_challenges.append(r)
        expected = eval_univariate(coeffs, r)
    return out_challenges, expected, recomb_chal
