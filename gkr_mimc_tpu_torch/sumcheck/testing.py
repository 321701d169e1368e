"""Deterministic sumcheck fixtures (the reference's
gkr_mimc_tpu/sumcheck/testing.py): the same inputs, so transcripts compare
against the JAX package and the golden files."""

from __future__ import annotations

import torch

from ..circuits.gates import CipherGate, IdentityGate
from ..fields import fr, scalar
from ..poly import multilin
from ..utils.common import get_challenge, random_fr_array
from ..utils.convert import ints_to_rows


def evaluation_scalar(gate, qprimes_int, claims_int, xs_int) -> int:
    """Host-int oracle of the (RLC-combined) claimed sum."""
    eq = multilin.eq_table_scalar(qprimes_int[0])
    if len(claims_int) >= 1 and len(qprimes_int) > 1:
        rlc = get_challenge(claims_int)
        mult = rlc
        for i in range(1, len(qprimes_int)):
            table_i = multilin.eq_table_scalar(qprimes_int[i], mult)
            eq = [scalar.add(a, b) for a, b in zip(eq, table_i)]
            mult = scalar.mul(mult, rlc)
    res = 0
    for n in range(len(xs_int[0])):
        g = gate.eval_scalar([x[n] for x in xs_int])
        res = scalar.add(res, scalar.mul(g, eq[n]))
    return res


def initialize_cipher_gate_instance(bn: int, device=None):
    """-> (xs tables on `device`, claims_int, qprimes_int, gate)."""
    q = random_fr_array(bn)
    gate = CipherGate(145646)
    vals = list(range(1 << bn))
    claim = evaluation_scalar(gate, [q], [], [vals, vals])
    xs = [fr.from_ints_mont(vals, device), fr.from_ints_mont(vals, device)]
    return xs, [claim], [q], gate


def initialize_multi_instance(bn: int, n_instance: int, device=None):
    """-> (xs tables on `device`, claims_int, qprimes_int, gate)."""
    gate = IdentityGate()
    qs = [[(i * j + i) for j in range(bn)] for i in range(n_instance)]
    vals = list(range(1 << bn))
    claims = [evaluation_scalar(gate, [q], [], [vals, vals]) for q in qs]
    xs = [fr.from_ints_mont(vals, device), fr.from_ints_mont(vals, device)]
    return xs, claims, qs, gate


def to_device_qprimes(qprimes_int, device=None) -> torch.Tensor:
    """J lists of bn ints -> (J, bn, 8) Montgomery rows."""
    return ints_to_rows(qprimes_int, device)


def to_device_claims(claims_int, device=None):
    """J ints -> (8, J) Montgomery tensor (None if empty)."""
    if not claims_int:
        return None
    return fr.encode_mont_ints(claims_int, device)
