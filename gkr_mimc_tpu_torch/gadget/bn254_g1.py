"""BN254 G1 group law, multi-scalar multiplication and the initial
randomness, on the host: the counterpart of gkr_mimc_tpu/gadget/bn254_g1.py.

Curve y^2 = x^3 + 3 over Fp, generator (1, 2), scalar field r (the fr the
GKR protocol runs in). Points are Jacobian (X, Y, Z) int tuples; the
identity has Z == 0. ``raw_bytes`` is gnark-crypto's uncompressed
RawBytes encoding (X || Y big-endian, 32 + 32 bytes), bit-exact because
the initial randomness is Keccak(RawBytes(point)).

The group law below is pure Python: it adds the two halves of the split
commitment and is the oracle for the native runtime, which does every
MSM of more than 16 points and every fixed-base batch (``native``).
"""

from __future__ import annotations

from .. import native
from ..fields.bn254 import P as R  # the scalar field is fr
from .keccak import keccak256

# Base field modulus
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

B = 3  # curve coefficient

GEN = (1, 2)  # affine generator

INF = (0, 1, 0)  # Jacobian identity


def is_inf(p) -> bool:
    return p[2] == 0


def to_jac(affine) -> tuple:
    if affine is None:
        return INF
    return (affine[0], affine[1], 1)


def to_affine(p) -> tuple | None:
    """Jacobian -> affine; None for the identity."""
    x, y, z = p
    if z == 0:
        return None
    zinv = pow(z, P - 2, P)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 * zinv % P)


def double(p) -> tuple:
    x, y, z = p
    if z == 0 or y == 0:
        return INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) % P - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def add(p, q) -> tuple:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2z2 * z2 % P
    s2 = y2 * z1z1 * z1 % P
    if u1 == u2:
        if s1 != s2:
            return INF
        return double(p)
    h = (u2 - u1) % P
    i = (2 * h) * (2 * h) % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (rr * rr - j - 2 * v) % P
    y3 = (rr * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) % P - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def neg(p) -> tuple:
    return (p[0], (-p[1]) % P, p[2])


def scalar_mul(p, k: int) -> tuple:
    k %= R
    if k == 0 or p[2] == 0:
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
    return (y * y - (x * x * x + B)) % P == 0


def msm(points: list, scalars: list[int]) -> tuple:
    """sum_i scalars[i] * points[i] (Jacobian tuples; scalars reduced mod
    r). Above 16 points the native runtime's Pippenger MSM, which must
    build; up to 16 points ``_msm_py``, as the reference splits them
    (gkr_mimc_tpu/gadget/bn254_g1.py:135), so a small commitment has the
    reference's Jacobian coordinates."""
    if len(points) != len(scalars):
        raise ValueError(f"msm: {len(points)} points, {len(scalars)} scalars")
    if len(points) > 16:
        return native.msm(points, scalars)
    return _msm_py(points, scalars)


def _msm_py(points: list, scalars: list[int]) -> tuple:
    """Pippenger MSM in pure Python: the oracle of ``native.msm``."""
    n = len(points)
    if n == 0:
        return INF
    scalars = [s % R for s in scalars]
    c = max(2, min(16, n.bit_length()))  # window bits
    nbits = R.bit_length()
    nwin = (nbits + c - 1) // c
    total = INF
    for w in reversed(range(nwin)):
        if not is_inf(total):
            for _ in range(c):
                total = double(total)
        buckets = [INF] * ((1 << c) - 1)
        shift = w * c
        for pt, s in zip(points, scalars):
            idx = (s >> shift) & ((1 << c) - 1)
            if idx:
                buckets[idx - 1] = add(buckets[idx - 1], pt)
        run = INF
        acc = INF
        for b in reversed(buckets):
            run = add(run, b)
            acc = add(acc, run)
        total = add(total, acc)
    return total


def raw_bytes(p) -> bytes:
    """gnark-crypto G1Affine.RawBytes: uncompressed X||Y big-endian.

    The two most-significant bits of byte 0 are the encoding flags; for an
    uncompressed finite point they are 0b00, which is automatic since
    p < 2^254. Infinity sets the 0b01 flag on an all-zero buffer
    (gnark-crypto bn254 marshal semantics)."""
    aff = to_affine(p)
    if aff is None:
        out = bytearray(64)
        out[0] = 0b01 << 6
        return bytes(out)
    return aff[0].to_bytes(32, "big") + aff[1].to_bytes(32, "big")


def derive_randomness_from_point(p) -> int:
    """Initial Fiat-Shamir randomness: fr.SetBytes(Keccak256(RawBytes(P)))
    (prover/gadget/hints.go:148-159) — big-endian digest reduced mod r."""
    return int.from_bytes(keccak256(raw_bytes(p)), "big") % R
