"""The port's MiMC hash against the known answer and the JAX package.

On the CPU the hash wrappers take their plain twin (the chain on host
ints); the comparison with gkr_mimc_tpu.hashes.mimc is exact on canonical
values, and the port's outputs are canonical bits.
"""

import random

import jax
import jax.numpy as jnp
import pytest
import torch

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.hashes import mimc as jmimc
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P
from gkr_mimc_tpu_torch.hashes import mimc
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.utils.convert import from_jax_rows

VALS = [random.Random(7).randrange(P) for _ in range(12)]
MIMC_KAT = 1808205620575546259657963589762746470347087906694759866517376279978241663265


def test_known_answer():
    """MimcHash([12]), the reference's hard-coded vector."""
    assert mimc.mimc_hash([12]) == MIMC_KAT
    assert fr.to_int(mimc.mimc_hash_device(fr.encode_mont_ints([12]))) == MIMC_KAT


def test_device_hash_matches_jax():
    msgs = VALS[:3]
    jmsgs = jfr.from_ints_mont(msgs)
    want = jfr.to_int(jax.jit(jmimc.mimc_hash_device)(jmsgs))
    got = mimc.mimc_hash_device(from_jax_rows(jmsgs))
    assert fr.to_int(got) == want == jmimc.mimc_hash(msgs)
    assert torch.equal(got, fr.canonicalize(got))


def test_hash_batch_matches_jax():
    jmsgs = jnp.stack([jfr.from_ints_mont(VALS[:3]), jfr.from_ints_mont(VALS[3:6])], axis=2)  # (16, 3, 2)
    want = jfr.to_ints(jax.jit(jmimc.mimc_hash_batch)(jmsgs))
    got = mimc.mimc_hash_batch(from_jax_rows(jmsgs))
    assert got.shape == (8, 2)
    assert fr.to_ints(got) == want == [jmimc.mimc_hash(VALS[:3]), jmimc.mimc_hash(VALS[3:6])]


def test_hash_lanes_are_independent():
    """Lane g of mimc_hash_g equals the single hash of lane g's words, for
    lazy (non-canonical) inputs too."""
    words = [[(v + i * P) % (2 * P) for v in VALS[:4]] for i in range(2)]  # lane 1 holds v + p
    lanes = torch.stack([fr._limb_tensor(w) for w in words], dim=2)  # (8, 4, 2)
    out = K.mimc_hash_g(lanes)
    assert torch.equal(out[:, 0], out[:, 1])
    assert torch.equal(out[:, 0], K.mimc_hash(lanes[:, :, 0].contiguous()))


@pytest.mark.parametrize(
    "bad",
    [
        lambda: torch.zeros((8, 3), dtype=torch.int64),  # dtype
        lambda: torch.zeros((16, 3), dtype=torch.int32),  # limb count
        lambda: torch.zeros((3, 8), dtype=torch.int32).T,  # not contiguous
    ],
    ids=["dtype", "shape", "contiguity"],
)
def test_wrapper_rejects_bad_input(bad):
    with pytest.raises((TypeError, ValueError)):
        K.mimc_hash(bad())
