"""Helpers shared by the port's CPU test files (tests/test_torch_*.py):
lazy random field tables, the JAX layout, canonical values and the golden
transcripts. Not a test module."""

import gc
import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L, P
from gkr_mimc_tpu_torch.models.mimc import mimc_circuit
from gkr_mimc_tpu_torch.sumcheck import prover, testing
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints, to_jax_rows

GOLDEN = Path(__file__).resolve().parent / "golden" / "transcripts.json"
TWO_P_TOP = 0x60C89CE5  # top 32-bit limb of 2p
EDGE = [0, 1, 2, P - 2, P - 1, P, P + 1, 2 * P - 2, 2 * P - 1, (1 << 255) % P, 0xFFFFFFFF]


def golden() -> dict:
    return json.loads(GOLDEN.read_text())


def strs(x):
    """Nested ints -> nested decimal strings (the golden files' form)."""
    return [strs(v) for v in x] if isinstance(x, list) else str(x)


def transcript(scp):
    """A sumcheck proof's (coefficients, challenges, final claims) as ints."""
    return rows_to_ints(scp.coeffs), rows_to_ints(scp.challenges), rows_to_ints(scp.final_claims)


def sumcheck_golden(rounds, case, tail_bits):
    """(got, want): the golden sumcheck ``case`` ("cipher_bn<k>" or
    "multi_bn3_j10") proven on the ``rounds`` head-round path at
    ``tail_bits``, and its golden transcript, as decimal strings."""
    if case == "multi_bn3_j10":
        xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, "cpu")
    else:
        xs, claims, qps, gate = testing.initialize_cipher_gate_instance(int(case[-1]), "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate,
                       tail_bits, rounds=rounds)
    want = golden()["sumcheck"][case]
    return strs(list(transcript(scp))), [want["coeffs"], want["challenges"], want["final_claims"]]


def rand_lazy(rng, *shape, device="cpu"):
    """(8, *shape) field elements below 2p from a numpy generator."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + shape, dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)


def lazy_ints(n, seed):
    """n held integers below 2p: the lazy range's edges, then random ones."""
    rng = random.Random(seed)
    vals = EDGE + [rng.randrange(2 * P) for _ in range(n - len(EDGE))]
    return vals[:n]


def both(vals):
    """The same held integers in both layouts: (port (8, n), JAX (16, n))."""
    t = fr._limb_tensor(vals)
    return t, jnp.asarray(to_jax_rows(t))


def jx(t):
    """A port tensor (8, ...) as a JAX array (16, ...) of the same integers."""
    return jnp.asarray(to_jax_rows(t))


def vals(t):
    """Canonical values of a port tensor (limb axis first)."""
    return fr.to_ints(t)


def jvals(a):
    """Canonical values of a JAX array (limb axis first)."""
    return jfr.to_ints(a)


def mimc_instance(bn):
    """The MiMC-91 circuit and the generator's stream as block, state
    (Montgomery tables) and qprime (rows) at 2**bn hashes."""
    block = fr.encode_mont_ints(random_fr_array(1 << bn))
    state = fr.encode_mont_ints(random_fr_array(1 << bn))
    return mimc_circuit(), block, state, ints_to_rows(random_fr_array(bn))


def jax_proof(proof):
    """A port GKRProof in the JAX package's layout (rows (..., 16), numpy),
    for the JAX package's host readers (``snark.gkr.Proof.assign``)."""
    from gkr_mimc_tpu.gkr.prover import GKRProof
    from gkr_mimc_tpu.sumcheck.prover import SumcheckProof

    def rows(t):
        return None if t is None else np.moveaxis(to_jax_rows(t.movedim(-1, 0)), 0, -1)

    return GKRProof([None if p is None else SumcheckProof(rows(p.coeffs), rows(p.challenges), rows(p.final_claims))
                     for p in proof.sumcheck_proofs],
                    [rows(c) for c in proof.claims], [rows(q) for q in proof.qprimes])


@pytest.fixture(autouse=True)
def no_cyclic_gc():
    """Pause the cyclic garbage collector for a test: constraint traces
    allocate millions of acyclic tuples, and the collector's passes over
    them took ~40 % of such a test's time. Autouse in a test file that
    imports it."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
