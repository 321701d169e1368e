"""BN254 G2 on the host: the r-torsion subgroup of the sextic twist
y^2 = x^3 + 3/(9+u) over Fp2 (D-type), the counterpart of
gkr_mimc_tpu/gadget/bn254_g2.py.

Points are Jacobian (X, Y, Z) tuples of Fp2 pairs; the identity has
Z == 0. G2 appears in the setup's key elements and in verification; the
batch-heavy G2 work (the setup's B query, prove's Bs MSM) goes through the
native runtime, which this pure-Python group law is the oracle for.
"""

from __future__ import annotations

from ..fields.bn254 import P as R  # the scalar field is fr
from . import tower as tw
from .tower import (
    FP2_ONE,
    FP2_ZERO,
    fp2_add,
    fp2_inv,
    fp2_is_zero,
    fp2_mul,
    fp2_neg,
    fp2_scalar,
    fp2_sqr,
    fp2_sub,
)

P = tw.P

# twist coefficient b' = 3 / (9 + u)
B2 = fp2_mul(tw.fp2(3), fp2_inv(tw.fp2(9, 1)))

# the standard (EIP-197 / gnark-crypto) G2 generator, affine (x, y) in Fp2
GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# Jacobian identity: Z == 0
INF = (FP2_ONE, FP2_ONE, FP2_ZERO)


def to_jac(affine) -> tuple:
    if affine is None:
        return INF
    return (affine[0], affine[1], FP2_ONE)


def is_inf(p) -> bool:
    return fp2_is_zero(p[2])


def to_affine(p):
    x, y, z = p
    if fp2_is_zero(z):
        return None
    zinv = fp2_inv(z)
    zinv2 = fp2_sqr(zinv)
    return (fp2_mul(x, zinv2), fp2_mul(fp2_mul(y, zinv2), zinv))


def double(p) -> tuple:
    x, y, z = p
    if fp2_is_zero(z) or fp2_is_zero(y):
        return INF
    a = fp2_sqr(x)
    b = fp2_sqr(y)
    c = fp2_sqr(b)
    t = fp2_add(x, b)
    d = fp2_scalar(fp2_sub(fp2_sqr(t), fp2_add(a, c)), 2)
    e = fp2_scalar(a, 3)
    f = fp2_sqr(e)
    x3 = fp2_sub(f, fp2_scalar(d, 2))
    y3 = fp2_sub(fp2_mul(e, fp2_sub(d, x3)), fp2_scalar(c, 8))
    z3 = fp2_scalar(fp2_mul(y, z), 2)
    return (x3, y3, z3)


def add(p, q) -> tuple:
    if fp2_is_zero(p[2]):
        return q
    if fp2_is_zero(q[2]):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = fp2_sqr(z1)
    z2z2 = fp2_sqr(z2)
    u1 = fp2_mul(x1, z2z2)
    u2 = fp2_mul(x2, z1z1)
    s1 = fp2_mul(fp2_mul(y1, z2z2), z2)
    s2 = fp2_mul(fp2_mul(y2, z1z1), z1)
    h = fp2_sub(u2, u1)
    if fp2_is_zero(h):
        if s1 != s2:
            return INF
        return double(p)
    i = fp2_sqr(fp2_scalar(h, 2))
    j = fp2_mul(h, i)
    rr = fp2_scalar(fp2_sub(s2, s1), 2)
    v = fp2_mul(u1, i)
    x3 = fp2_sub(fp2_sub(fp2_sqr(rr), j), fp2_scalar(v, 2))
    y3 = fp2_sub(
        fp2_mul(rr, fp2_sub(v, x3)), fp2_scalar(fp2_mul(s1, j), 2)
    )
    zs = fp2_add(z1, z2)
    z3 = fp2_mul(fp2_sub(fp2_sub(fp2_sqr(zs), z1z1), z2z2), h)
    return (x3, y3, z3)


def neg(p) -> tuple:
    return (p[0], fp2_neg(p[1]), p[2])


def scalar_mul(p, k: int) -> tuple:
    k %= R
    if k == 0 or fp2_is_zero(p[2]):
        return INF
    acc = INF
    while k:
        if k & 1:
            acc = add(acc, p)
        p = double(p)
        k >>= 1
    return acc


def on_curve(p) -> bool:
    aff = to_affine(p)
    if aff is None:
        return True
    x, y = aff
    return fp2_sub(fp2_sqr(y), fp2_add(fp2_mul(fp2_sqr(x), x), B2)) == FP2_ZERO
