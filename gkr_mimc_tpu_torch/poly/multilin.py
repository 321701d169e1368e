"""Dense multilinear tables and eq tables.

A table is an (8, ..., N) Montgomery limb tensor: N = 2**n evaluations over
the boolean hypercube, variable 0 the most significant bit of the index
(the reference's order, gkr_mimc_tpu/poly/multilin.py).
"""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L
from ..ops import kernels as K


def evaluate(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Multilinear evaluation of an (8, 2**n) table at coords (n, 8) rows,
    folding once per coordinate through ``ops.kernels.fold`` -> (8,)."""
    t = table.contiguous()
    for i in range(coords.shape[0]):
        [t] = K.fold([t], coords[i].reshape(L, 1).contiguous())
    return t[:, 0]


MUL_SCALAR_MIN = 512  # doubling steps on tables this large multiply through the kernel


def eq_table(qprime: torch.Tensor, multiplier=None) -> torch.Tensor:
    """out[x] = mult * prod_i eq1(q_i, bit_i(x)), bit 0 the MSB:
    qprime (n, 8) rows -> (8, 2**n). Doubling with interleave; as the
    reference (gkr_mimc_tpu/poly/multilin.py:58-80), a step on a table of at
    least MUL_SCALAR_MIN entries multiplies through ``ops.kernels.mul_scalar``."""
    t = fr.one((), qprime.device) if multiplier is None else multiplier
    t = t.reshape(L, 1)
    for i in range(qprime.shape[0]):
        q = qprime[i].contiguous()
        rt = K.mul_scalar(t, q) if t.shape[-1] >= MUL_SCALAR_MIN else fr.mul(t, q.reshape(L, 1))
        t = torch.stack([fr.sub(t, rt), rt], dim=-1).reshape(L, -1)
    return t


def eq_table_grouped(qprime: torch.Tensor, multiplier=None) -> torch.Tensor:
    """One eq table per group: qprime (n, G, 8) -> (8, G, 2**n); the
    optional multiplier is (8, G)."""
    n, g, _ = qprime.shape
    t = fr.one((g,), qprime.device) if multiplier is None else multiplier
    t = t.reshape(L, g, 1)
    for i in range(n):
        rt = fr.mul(t, qprime[i].T.reshape(L, g, 1))
        t = torch.stack([fr.sub(t, rt), rt], dim=-1).reshape(L, g, -1)
    return t


def eq_prefix(qprime_bits: torch.Tensor, chunk_id: int, multiplier=None) -> torch.Tensor:
    """The factor of eq over k variables at the bits of ``chunk_id``:
    mult * prod_i (q_i if bit else 1 - q_i), qprime_bits[0] paired with the
    most significant of chunk_id's k bits (the reference's
    gkr_mimc_tpu/poly/multilin.py:101-118): qprime_bits (k, 8) rows ->
    (8,). A shard seeds its local eq table with it."""
    one = fr.one((), qprime_bits.device)
    r = one if multiplier is None else multiplier
    k = qprime_bits.shape[0]
    for pos in range(k):
        q = qprime_bits[pos]
        r = fr.mul(r, q if (chunk_id >> (k - 1 - pos)) & 1 else fr.sub(one, q))
    return r


def eq_eval_scalar(q: list[int], h: list[int]) -> int:
    """EvalEq(q, h) = prod_i (1 + 2 q_i h_i - q_i - h_i) on Python ints."""
    res = 1
    for qi, hi in zip(q, h):
        qh = scalar.mul(qi, hi)
        term = scalar.sub(scalar.add(scalar.add(qh, qh), 1), scalar.add(qi, hi))
        res = scalar.mul(res, term)
    return res


def eq_table_scalar(q: list[int], multiplier: int = 1) -> list[int]:
    t = [multiplier]
    for qi in q:
        nxt = []
        for v in t:
            rv = scalar.mul(v, qi)
            nxt.extend((scalar.sub(v, rv), rv))
        t = nxt
    return t


def evaluate_scalar(table: list[int], coords: list[int]) -> int:
    """Host-int oracle of ``evaluate``: fold once per coordinate."""
    t = list(table)
    for r in coords:
        mid = len(t) // 2
        t = [scalar.add(t[i], scalar.mul(r, scalar.sub(t[mid + i], t[i]))) for i in range(mid)]
    return t[0]
