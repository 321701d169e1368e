"""Multilinear evaluation of a large table mod p, in plain PyTorch.

The verifier needs the multilinear extension of the output table (2^22 to
2^25 entries) and of each input table at one point. On Python ints that is
seconds a million entries, so it runs here as plain tensor arithmetic on
whatever device holds the table, after the measured window.

A value is sixteen 16-bit digits in int64, digit-major, so no product or
column sum can overflow: a digit product is below 2^32 and a column of the
product gathers at most 32 of them and the carries. A fold multiplies by a
constant c given as c R mod p, R = 2^256, and reduces by Montgomery's REDC,
one digit at a time, so that (a c R) R^-1 = a c mod p whatever the
representation of a. Values are kept in [0, 2p).

The table's variable 0 is the most significant bit of the index (the
reference's order), so the point's last coordinate is folded first, over
adjacent pairs, which works over contiguous blocks.
"""

from __future__ import annotations

import torch

from .field import P, R

DIGITS = 16
MASK = 0xFFFF
P_DIGITS = [(P >> (16 * i)) & MASK for i in range(DIGITS)]
assert P_DIGITS[0] == 1  # so -p^-1 = -1 mod 2^16: the REDC digit is -T_i mod 2^16


def _digits_of(x: int) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(DIGITS)]


def _column(values, like: torch.Tensor, ndim: int) -> torch.Tensor:
    """A digit column (16, 1, ...) of a constant, ndim dims in all."""
    return torch.tensor(values, dtype=torch.int64, device=like.device).reshape((DIGITS,) + (1,) * (ndim - 1))


def from_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 words of 32 bits (any integer below 2^256) -> (16, ...) digits."""
    w = limbs.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> 16], dim=1).reshape((DIGITS,) + tuple(limbs.shape[1:]))


def to_ints(d: torch.Tensor) -> list[int]:
    """(16, k) digits -> the k integers they hold."""
    cols = d.cpu().tolist()
    return [sum(cols[i][j] << (16 * i) for i in range(DIGITS)) for j in range(d.shape[1])]


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow) through the digits in place; the top digit keeps
    the sign, so a negative value shows as a negative top digit."""
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> 16
        t[i] &= MASK
    return t


def cond_sub(t: torch.Tensor, c: int) -> torch.Tensor:
    """t - c where t >= c, else t (t normalised, c < 2^256)."""
    s = normalize(t - _column(_digits_of(c), t, t.ndim))
    return torch.where(s[-1:] >= 0, s, t)


def reduce_2p(t: torch.Tensor) -> torch.Tensor:
    """Any value below 2^256 (< 5.3 p) -> its representative in [0, 2p)."""
    return cond_sub(cond_sub(t, 4 * P), 2 * P)


def redc_mul(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """REDC(a c) = a c R^-1 mod p, below 2p for a < 4p and c < p.
    a (16, *B, m) digits; c (16, *B, 1) digits, one constant a row of B."""
    shape = (2 * DIGITS + 1,) + tuple(a.shape[1:])
    t = torch.zeros(shape, dtype=torch.int64, device=a.device)
    for j in range(DIGITS):
        t[j : j + DIGITS] += a * c[j]
    p = _column(P_DIGITS, a, a.ndim)
    for i in range(DIGITS):
        m = (-t[i]) & MASK
        t[i : i + DIGITS] += m * p
        t[i + 1] += t[i] >> 16
    return normalize(t[DIGITS:])[:DIGITS]


def fold(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One variable, the index's least significant bit: lo + r (hi - lo)
    with c the digits of r R mod p; t (16, *B, 2m) in [0, 2p) -> (16, *B, m)."""
    lo, hi = t[..., 0::2], t[..., 1::2]
    d = normalize(hi + _column(_digits_of(2 * P), t, t.ndim) - lo)  # in (0, 4p)
    return cond_sub(normalize(lo + redc_mul(d, c)), 2 * P)


def evaluate(limbs: torch.Tensor, points) -> list[int]:
    """The multilinear extension of each row of a table at its point, mod p.

    limbs (8, *B, 2^n) int32 words; points: for an (8, 2^n) table one point
    (n ints), for (8, G, 2^n) a list of G points. Returns one value a row:
    of the integers the table holds (a Montgomery table gives the
    Montgomery image of the value)."""
    batch = tuple(limbs.shape[1:-1])
    rows = [points] if not batch else list(points)
    n = limbs.shape[-1].bit_length() - 1
    if limbs.shape[-1] != 1 << n or any(len(q) != n for q in rows):
        raise ValueError(f"table of {limbs.shape[-1]} entries and points of {[len(q) for q in rows]} coordinates")
    t = reduce_2p(from_limbs(limbs))
    for k in range(n - 1, -1, -1):
        consts = [_digits_of(q[k] % P * R % P) for q in rows]
        c = torch.tensor(consts, dtype=torch.int64, device=t.device).T.reshape((DIGITS,) + batch + (1,))
        t = fold(t, c)
    return [v % P for v in to_ints(t.reshape(DIGITS, -1))]
