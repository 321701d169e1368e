"""The port's GMiMC and Poseidon hashers (gkr_mimc_tpu_torch.hashes) and the
Poseidon MDS matrix against the JAX package.

The device hashers (their S-boxes on the pow7 wrapper, its plain twin on
the CPU) are held, exactly on canonical values, against the port's host
hash and the JAX package's host hash at every width; the JAX device hasher
only at GMiMC T2, since compiling the JAX Poseidon hashers takes minutes
(tests/test_hash.py holds those equal to the JAX host hash). Seven
cases, as tests/test_torch_models.py explains.

    python -m pytest tests/test_torch_hashers.py -q -p no:cacheprovider
"""

import random

import jax
import jax.numpy as jnp
import pytest
import torch

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.hashes import gmimc as jgmimc
from gkr_mimc_tpu.hashes import poseidon as jposeidon
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import P
from gkr_mimc_tpu_torch.hashes import gmimc, poseidon


def test_mds_matrix_matches_jax():
    for t in (2, 4, 8):
        assert poseidon.generate_mds_matrix(t) == jposeidon.generate_mds_matrix(t)


@pytest.mark.parametrize("name", ["GMIMC_T2", "GMIMC_T4", "GMIMC_T8", "POSEIDON_T2", "POSEIDON_T4", "POSEIDON_T8"])
def test_device_hashers_match_host_and_jax(name):
    """N = 4 messages of t + 3 words (two blocks, the second zero-padded)
    through hash_batch, against the port's and the JAX package's host
    hash; GMiMC T2 also against the JAX hash_batch (of the first block
    alone: one compiled update)."""
    port = getattr(gmimc if name.startswith("GMIMC") else poseidon, name)
    ref = getattr(jgmimc if name.startswith("GMIMC") else jposeidon, name)
    rng = random.Random(name)
    msgs = [[rng.randrange(P) for _ in range(port.t + 3)] for _ in range(4)]
    dev = torch.stack([fr.from_ints_mont(m) for m in msgs], dim=2)  # (8, K, 4)
    got = port.hash_batch(dev)
    assert got.shape == (8, 4)
    want = [ref.hash(m) for m in msgs]
    assert fr.to_ints(got) == [port.hash(m) for m in msgs] == want
    state = [1, 2] + [0] * (port.t - 2)
    assert port.update(state, msgs[0][: port.t]) == ref.update(state, msgs[0][: port.t])
    if name == "GMIMC_T2":
        first = [m[: port.t] for m in msgs]
        jmsgs = jnp.stack([jfr.from_ints_mont(m) for m in first], axis=2)
        want = [ref.hash(m) for m in first]
        assert jfr.to_ints(jax.jit(ref.hash_batch)(jmsgs)) == want
        assert fr.to_ints(port.hash_batch(dev[:, : port.t].contiguous())) == want
