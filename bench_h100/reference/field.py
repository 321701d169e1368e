"""Plain BN254 scalar-field arithmetic and MiMC on Python ints.

The benchmark's own copy: it imports nothing of the program under test.
MiMC-91 with the x^7 S-box over BN254 fr, as the gnark / Consensys gkr-mimc
reference defines it:

* keyed permutation: x -> (x + key + ark_i)^7 for i = 0 .. 90;
* hash update (Miyaguchi-Preneel): state' = Perm_state(block) + 2 state + block;
* MimcHash(message): the updates chained from state 0. It is also the
  Fiat-Shamir challenge of a message.

The round constants are the reference's table (``arks.txt``, one decimal a
line, the first 91 used).
"""

from __future__ import annotations

from pathlib import Path

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
R = 1 << 256  # the Montgomery radix of the program's encoding (eight 32-bit limbs)
RINV = pow(R, -1, P)
ROUNDS = 91

ARKS = tuple(int(line) % P for line in (Path(__file__).with_name("arks.txt")).read_text().split())


def permutation(x: int, key: int) -> int:
    """The keyed MiMC-91 permutation of x under key."""
    for ark in ARKS[:ROUNDS]:
        t = (x + key + ark) % P
        t2 = t * t % P
        x = t2 * t2 * t2 % P * t % P
    return x


def mimc_hash(message) -> int:
    """MimcHash of a sequence of field elements."""
    state = 0
    for block in message:
        state = (permutation(block, state) + 2 * state + block) % P
    return state


def horner(coeffs, x: int) -> int:
    """sum_j coeffs[j] x^j."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def eq(q, h) -> int:
    """The multilinear equality polynomial prod_i (q_i h_i + (1 - q_i)(1 - h_i))."""
    acc = 1
    for a, b in zip(q, h):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % P) % P
    return acc


def decode_mont(words) -> int:
    """A Montgomery-form value held as little-endian 32-bit words -> the field element."""
    v = 0
    for i, w in enumerate(words):
        v |= (int(w) & 0xFFFFFFFF) << (32 * i)
    return v * RINV % P
