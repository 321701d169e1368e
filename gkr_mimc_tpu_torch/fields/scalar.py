"""Host-side (Python int) BN254 fr arithmetic: the obviously-correct
oracle used by the verifier, the tests and host bookkeeping."""

from .bn254 import P


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return (P - a) % P


def mul(a: int, b: int) -> int:
    return a * b % P


def inverse(a: int) -> int:
    return pow(a, -1, P)


def pow7(a: int) -> int:
    """x^7 (the MiMC S-box); value-identical to the sq, mul, sq, mul chain."""
    return pow(a, 7, P)