"""BN254's extension fields Fp2 and Fp12 on the host, in pure Python (the
counterpart of gkr_mimc_tpu/gadget/tower.py).

Pairings run once per proof verification, on the host and far from the
card's hot path, so exact Python-int arithmetic is the right tool; the
native runtime covers the batch-heavy G1 and G2 multi-exponentiations.

Representations:
  * Fp2 = Fp[u]/(u^2 + 1), elements (a0, a1) = a0 + a1*u, as gnark-crypto's
    E2{A0, A1}.
  * Fp12 = Fp[w]/(w^12 - 18*w^6 + 82), elements as 12-tuples of Fp
    coefficients, lowest degree first. Fp2 embeds through u -> w^6 - 9
    ((w^6 - 9)^2 = w^12 - 18 w^6 + 81 = -1), which is how G2 points on the
    sextic twist map into the full field for the Miller loop.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def fp2(a0: int, a1: int = 0) -> tuple:
    return (a0 % P, a1 % P)


FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sqr(a):
    return fp2_mul(a, a)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fp2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


def fp2_pow(a, e: int):
    res = FP2_ONE
    base = a
    while e:
        if e & 1:
            res = fp2_mul(res, base)
        base = fp2_sqr(base)
        e >>= 1
    return res


# ---------------------------------------------------------------------------
# Fp12 (dense polynomial representation mod w^12 - 18 w^6 + 82)
# ---------------------------------------------------------------------------

FP12_MOD_W6 = 18  # w^12 = 18 w^6 - 82
FP12_MOD_C = -82


def fp12(coeffs) -> tuple:
    c = tuple(x % P for x in coeffs)
    assert len(c) == 12
    return c


FP12_ONE = (1,) + (0,) * 11
FP12_ZERO = (0,) * 12


def fp12_from_fp(a: int) -> tuple:
    return (a % P,) + (0,) * 11


def fp12_from_fp2(a) -> tuple:
    """Embed a0 + a1*u via u -> w^6 - 9."""
    out = [0] * 12
    out[0] = (a[0] - 9 * a[1]) % P
    out[6] = a[1] % P
    return tuple(out)


def fp12_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def fp12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fp12_neg(a):
    return tuple((-x) % P for x in a)


def fp12_mul(a, b):
    t = [0] * 23
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            t[i + j] += ai * bj
    # reduce degrees 22..12: w^k = 18 w^(k-6) - 82 w^(k-12)
    for k in range(22, 11, -1):
        v = t[k]
        if v:
            t[k - 6] += 18 * v
            t[k - 12] -= 82 * v
            t[k] = 0
    return tuple(x % P for x in t[:12])


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_pow(a, e: int):
    res = FP12_ONE
    base = a
    while e:
        if e & 1:
            res = fp12_mul(res, base)
        base = fp12_sqr(base)
        e >>= 1
    return res


def _poly_divmod(num, den):
    """Polynomial division over Fp; num/den as coefficient lists (low first)."""
    num = list(num)
    deg_d = len(den) - 1
    while deg_d >= 0 and den[deg_d] == 0:
        deg_d -= 1
    q = [0] * (len(num))
    inv_lead = pow(den[deg_d], P - 2, P)
    for i in range(len(num) - 1, deg_d - 1, -1):
        if num[i] == 0:
            continue
        c = num[i] * inv_lead % P
        q[i - deg_d] = c
        for j in range(deg_d + 1):
            num[i - deg_d + j] = (num[i - deg_d + j] - c * den[j]) % P
    return q, num


def fp12_inv(a):
    """Inverse via extended Euclid on Fp[w] against the modulus poly."""
    mod = [0] * 13
    mod[0] = 82 % P
    mod[6] = (-18) % P
    mod[12] = 1
    # xgcd(a, mod): maintain r0 = s0*a (mod modpoly)
    r0, r1 = list(a) + [0], mod
    s0, s1 = [1] + [0] * 12, [0] * 13
    while True:
        deg1 = len(r1) - 1
        while deg1 >= 0 and r1[deg1] == 0:
            deg1 -= 1
        if deg1 < 0:
            break
        q, rem = _poly_divmod(r0, r1)
        # s_new = s0 - q*s1
        s_new = list(s0)
        for i, qi in enumerate(q):
            if qi == 0:
                continue
            for j, sj in enumerate(s1):
                if i + j < len(s_new) and sj:
                    s_new[i + j] = (s_new[i + j] - qi * sj) % P
        r0, r1 = r1, rem
        s0, s1 = s1, s_new
    # r0 is the gcd (a unit, degree 0)
    deg0 = len(r0) - 1
    while r0[deg0] == 0:
        deg0 -= 1
    assert deg0 == 0, "fp12_inv of a zero divisor"
    c = pow(r0[0], P - 2, P)
    out = [(x * c) % P for x in s0[:12]]
    out += [0] * (12 - len(out))
    return tuple(out[:12])


def fp12_is_one(a) -> bool:
    return a == FP12_ONE
