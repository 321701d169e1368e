"""In-circuit MiMC hash (the counterpart of gkr_mimc_tpu/snark/hash.py).

The same transcript as ``hashes.mimc.mimc_hash``: 91 rounds, the
Miyaguchi-Preneel chaining and x^7 as a 4-multiply chain, so the
in-circuit Fiat-Shamir challenges equal the prover's. Cost: 4 constraints
a round, 364 a message word.
"""

from __future__ import annotations

from ..hashes.ark import ARKS_INT
from ..hashes.mimc import MIMC_ROUNDS
from .cs import ConstraintSystem, Variable


def mimc_hash(cs: ConstraintSystem, *stream) -> Variable:
    state = cs.constant(0)
    for m in stream:
        new_m = m
        for i in range(MIMC_ROUNDS):
            new_m = cs.add(new_m, state)
            new_m = cs.add(new_m, cs.constant(ARKS_INT[i]))
            tmp = cs.mul(new_m, new_m)  # ^2
            tmp = cs.mul(new_m, tmp)  # ^3
            tmp = cs.mul(tmp, tmp)  # ^6
            new_m = cs.mul(new_m, tmp)  # ^7
        state = cs.add(state, new_m, state, m)
    return state
