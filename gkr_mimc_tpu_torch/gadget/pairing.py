"""BN254 optimal-ate pairing on the host, in pure Python (the counterpart
of gkr_mimc_tpu/gadget/pairing.py): what the reference gets from
gnark-crypto's ``bn254.PairingCheck`` for the Groth16 verifier's 4-term
check, run once per verification.

  * G2 points on the twist map into Fp12 by the untwist
    (x, y) -> (x * w^2, y * w^3), Fp2 embedded through u = w^6 - 9.
  * The Miller loop runs over 6x + 2 = 29793968203157093288 with affine
    line functions in Fp12, then the two Frobenius-twisted additions.
  * The final exponentiation is the full (p^12 - 1)/r power.

``pairing_check(pairs)`` returns prod e(Pi, Qi) == 1 with one shared final
exponentiation.
"""

from __future__ import annotations

from . import bn254_g1 as g1
from . import bn254_g2 as g2
from . import tower as tw
from .tower import (
    FP12_ONE,
    fp12_from_fp,
    fp12_from_fp2,
    fp12_inv,
    fp12_mul,
    fp12_pow,
    fp12_sqr,
    fp12_sub,
)

P = tw.P
R = g2.R

# BN parameter x = 4965661367192848881; ate loop count = 6x + 2
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63  # bit 64 is the implicit leading 1

FINAL_EXP = (P**12 - 1) // R

# w^2 and w^3 as Fp12 constants
_W2 = tuple(1 if i == 2 else 0 for i in range(12))
_W3 = tuple(1 if i == 3 else 0 for i in range(12))


def twist(q_affine):
    """G2 affine point over Fp2 -> point over Fp12 on E: y^2 = x^3 + 3."""
    x, y = q_affine
    nx = fp12_mul(fp12_from_fp2(x), _W2)
    ny = fp12_mul(fp12_from_fp2(y), _W3)
    return (nx, ny)


def cast_g1(p_affine):
    return (fp12_from_fp(p_affine[0]), fp12_from_fp(p_affine[1]))


def _line(p1, p2, t):
    """Evaluate the line through p1, p2 (Fp12 affine points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
        return fp12_sub(fp12_mul(m, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    if y1 == y2:
        three_x2 = fp12_mul(fp12_from_fp(3), fp12_sqr(x1))
        m = fp12_mul(three_x2, fp12_inv(fp12_mul(fp12_from_fp(2), y1)))
        return fp12_sub(fp12_mul(m, fp12_sub(xt, x1)), fp12_sub(yt, y1))
    return fp12_sub(xt, x1)


def _add_aff(p1, p2):
    """Affine addition on the Fp12 curve (points never hit infinity during
    a Miller loop on valid r-torsion inputs)."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        three_x2 = fp12_mul(fp12_from_fp(3), fp12_sqr(x1))
        m = fp12_mul(three_x2, fp12_inv(fp12_mul(fp12_from_fp(2), y1)))
    else:
        m = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sqr(m), x1), x2)
    y3 = fp12_sub(fp12_mul(m, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _frob_pt(pt):
    """Frobenius on an Fp12 point: coefficient-wise x -> x^p."""
    x, y = pt
    return (fp12_pow(x, P), fp12_pow(y, P))


def miller_loop(q_affine_fp2, p_affine) -> tuple:
    """Miller loop (WITHOUT final exponentiation) of e(P, Q).

    q_affine_fp2: G2 affine over Fp2; p_affine: G1 affine ints."""
    q = twist(q_affine_fp2)
    p = cast_g1(p_affine)
    r_pt = q
    f = FP12_ONE
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = fp12_mul(fp12_sqr(f), _line(r_pt, r_pt, p))
        r_pt = _add_aff(r_pt, r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = fp12_mul(f, _line(r_pt, q, p))
            r_pt = _add_aff(r_pt, q)
    q1 = _frob_pt(q)
    nq2 = _frob_pt(q1)
    nq2 = (nq2[0], tuple((-c) % P for c in nq2[1]))
    f = fp12_mul(f, _line(r_pt, q1, p))
    r_pt = _add_aff(r_pt, q1)
    f = fp12_mul(f, _line(r_pt, nq2, p))
    return f


def final_exponentiate(f) -> tuple:
    return fp12_pow(f, FINAL_EXP)


def pairing(p_jac, q_jac) -> tuple:
    """e(P, Q) for P in G1 (Jacobian int tuple), Q in G2 (Jacobian Fp2).

    Returns the Fp12 pairing value; identity inputs give 1."""
    p_aff = g1.to_affine(p_jac)
    q_aff = g2.to_affine(q_jac)
    if p_aff is None or q_aff is None:
        return FP12_ONE
    return final_exponentiate(miller_loop(q_aff, p_aff))


def pairing_check(pairs) -> bool:
    """prod_i e(Pi, Qi) == 1, with ONE shared final exponentiation — the
    multi-pairing shape of gnark-crypto's PairingCheck (verify.go:60-70)."""
    acc = FP12_ONE
    for p_jac, q_jac in pairs:
        p_aff = g1.to_affine(p_jac)
        q_aff = g2.to_affine(q_jac)
        if p_aff is None or q_aff is None:
            continue
        acc = fp12_mul(acc, miller_loop(q_aff, p_aff))
    return final_exponentiate(acc) == FP12_ONE
