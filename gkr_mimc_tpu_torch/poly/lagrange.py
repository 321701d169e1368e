"""Univariate helpers: Lagrange interpolation on {0, ..., K-1} and Horner
evaluation (the reference's poly/lagrange.py)."""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L, P

MAX_DOMAIN_SIZE = 12


def eval_univariate(coeffs: list[int], x: int) -> int:
    """Horner evaluation from the highest coefficient (host ints)."""
    res = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        res = scalar.add(scalar.mul(res, x), c)
    return res


@lru_cache(maxsize=None)
def lagrange_coefficients(domain_size: int) -> tuple[tuple[int, ...], ...]:
    """[l][j]: coefficient j of the l-th Lagrange basis polynomial on
    {0, ..., domain_size - 1}."""
    assert domain_size <= MAX_DOMAIN_SIZE + 1
    result = []
    for l in range(domain_size):
        acc = [1] + [0] * (domain_size - 1)
        for i in range(domain_size):
            if i == l:
                continue
            upd = [0] * domain_size  # acc * (X - i)
            for j in range(domain_size):
                upd[j] = scalar.add(upd[j], scalar.mul(acc[j], scalar.neg(i % P)))
                if j + 1 < domain_size:
                    upd[j + 1] = scalar.add(upd[j + 1], acc[j])
            acc = upd
        norm = scalar.inverse(eval_univariate(acc, l))
        result.append(tuple(scalar.mul(c, norm) for c in acc))
    return tuple(result)


@lru_cache(maxsize=None)
def lagrange_tensor(domain_size: int, device: torch.device) -> torch.Tensor:
    """Montgomery Lagrange matrix (8, K eval points, K coefficients)."""
    lag = lagrange_coefficients(domain_size)
    flat = [lag[i][j] for i in range(domain_size) for j in range(domain_size)]
    return fr.encode_mont_ints(flat, device).reshape(L, domain_size, domain_size)


def interpolate_on_range_device(values: torch.Tensor) -> torch.Tensor:
    """values (8, K[, *B]) at 0..K-1 -> (8, K[, *B]) coefficients."""
    k = values.shape[1]
    batch = values.shape[2:]
    lag = lagrange_tensor(k, values.device).reshape((L, k, k) + (1,) * len(batch))
    prods = fr.mul(values.unsqueeze(2), lag)  # (8, K, K, *B)
    return fr.reduce_sum(prods, 0)


def eval_univariate_device(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner on the device: coeffs (8, K[, *B]), x (8[, *B]) -> (8[, *B]);
    a grouped batch B = (G,) evaluates each lane at its own x."""
    res = coeffs[:, -1]
    for j in range(coeffs.shape[1] - 2, -1, -1):
        res = fr.add(fr.mul(res, x), coeffs[:, j])
    return res