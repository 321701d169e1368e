"""BN254 scalar-field (fr) constants for the port's limb layout: eight
32-bit limbs, Montgomery radix R = 2**256 (the reference's R, so the
Montgomery integers agree with ``gkr_mimc_tpu``)."""

# BN254 (alt_bn128) scalar field modulus.
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

W = 32  # limb width in bits
L = 8  # number of limbs (8 * 32 = 256 bits >= 254)
MASK = (1 << W) - 1
R_BITS = W * L  # Montgomery radix exponent: R = 2**256

R1 = (1 << R_BITS) % P  # R mod p (the Montgomery image of 1)
RINV = pow(1 << R_BITS, -1, P)  # R^-1 mod p (host-side Montgomery decode)
R2 = (R1 * R1) % P  # R^2 mod p (to-Montgomery conversion factor)
PINV = pow(P, -1, 1 << R_BITS)  # p^-1 mod R
NPRIME = (1 << R_BITS) - PINV  # -p^-1 mod R


def int_to_limbs(x: int, n: int = L) -> list[int]:
    """Little-endian 32-bit limb decomposition of a Python int."""
    return [(x >> (W * i)) & MASK for i in range(n)]

