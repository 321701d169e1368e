"""The port's standalone gadget (gkr_mimc_tpu_torch.gadget) against the JAX
package's: the hasher updates, close() at bN = 2 on the io pattern of
tests/test_gadget.py (three chained updates, two of them public, padded to
four), verify_gadget and the wire format's round trip, and the verifier's
rejection of a tampered rho, proof vector and io.

On the CPU every kernel wrapper takes its plain twin; every field value,
rho and the commitment point are compared exactly. One JAX close() runs,
in a module fixture (about 40 s here, nearly all of it tracing and
compiling the JAX walk).

    python -m pytest tests/test_torch_gadget.py -q -p no:cacheprovider
"""

import copy
import dataclasses

import pytest

from gkr_mimc_tpu.gadget import GkrGadget as JaxGkrGadget
from gkr_mimc_tpu.hashes import mimc as jmimc
from gkr_mimc_tpu.utils.common import random_fr_array
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget import (
    GadgetVerifyError,
    GkrGadget,
    proof_from_vec,
    proof_size,
    proof_to_vec,
    verify_gadget,
)
from gkr_mimc_tpu_torch.gadget import bn254_g1 as g1
from gkr_mimc_tpu_torch.gkr.verifier import GKRError
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash, mimc_update_device


def _store(gadget):
    s = gadget.io_store
    return s.input_arity, s.inputs, s.outputs, s.public, s.index


def _close(gadget):
    """close() on the io pattern of tests/test_gadget.py's fixture."""
    state = 0
    for i, m in enumerate(random_fr_array(3)):
        state = gadget.update_hasher(state, m, public=i < 2)
    gadget._pad()  # so the setup is sized for the padded partition
    setup = gadget.make_setup()
    return gadget, setup, gadget.close(setup=setup, check=True)


@pytest.fixture(scope="module")
def jax_closed():
    return _close(JaxGkrGadget())


@pytest.fixture(scope="module")
def port_closed():
    return _close(GkrGadget(device="cpu"))


def test_update_hasher_matches_jax():
    """Chained host updates reproduce MimcHash and the JAX gadget's
    states and io store."""
    got, want = GkrGadget(device="cpu"), JaxGkrGadget()
    msgs = random_fr_array(5)
    s_got = s_want = 0
    for m in msgs:
        s_got, s_want = got.update_hasher(s_got, m), want.update_hasher(s_want, m)
        assert s_got == s_want
    assert s_got == mimc_hash(msgs)
    assert _store(got) == _store(want)


def test_update_hasher_batch_matches_jax():
    """The batch (91 cipher_layer calls, their plain twins here) against
    the JAX gadget's batch, public and private; the device update against
    the host update."""
    got, want = GkrGadget(device="cpu"), JaxGkrGadget()
    states, msgs = random_fr_array(9), random_fr_array(18)[9:][::-1]
    for public, part in ((True, slice(0, 4)), (False, slice(4, 9))):
        out = got.update_hasher_batch(states[part], msgs[part], public)
        assert out == want.update_hasher_batch(states[part], msgs[part], public)
        assert out == [jmimc.mimc_update(s, m) for s, m in zip(states[part], msgs[part])]
    assert _store(got) == _store(want)
    dev = mimc_update_device(fr.encode_mont_ints(states), fr.encode_mont_ints(msgs))
    assert fr.to_ints(dev) == [jmimc.mimc_update(s, m) for s, m in zip(states, msgs)]
    with pytest.raises(ValueError):
        got.update_hasher_batch(states, msgs[:8])


def test_close_matches_jax(jax_closed, port_closed):
    """Same setup, io store, rho, private commitment and proof vector."""
    jgadget, jsetup, jproof = jax_closed
    gadget, setup, proof = port_closed
    assert _store(gadget) == _store(jgadget)
    assert dataclasses.astuple(setup) == dataclasses.astuple(jsetup)
    assert proof.bn == jproof.bn == 2
    assert proof.initial_randomness == jproof.initial_randomness
    assert proof.krs_gkr_priv == jproof.krs_gkr_priv
    assert proof.proof_vec == jproof.proof_vec


def test_verify_gadget_and_serialize_round_trip(port_closed):
    gadget, setup, proof = port_closed
    assert len(proof.proof_vec) == proof_size(gadget.circuit, proof.bn)
    verify_gadget(gadget.circuit, setup, proof, gadget.io_store, device="cpu")
    parsed = proof_from_vec(gadget.circuit, proof.bn, proof.proof_vec, "cpu")
    assert proof_to_vec(gadget.circuit, parsed) == proof.proof_vec
    with pytest.raises(ValueError):
        proof_from_vec(gadget.circuit, proof.bn, proof.proof_vec[:-1], "cpu")


@pytest.mark.parametrize("where", ["rho", "proof", "io"])
def test_verify_rejects_tampering(port_closed, where):
    """rho + 1 fails the commitment check; the first coefficient + 1 fails
    the sumcheck; the private third output + 1 (its commitment is in the
    proof's KrsGkrPriv) fails the output check of the GKR transcript."""
    gadget, setup, proof = port_closed
    store = copy.deepcopy(gadget.io_store)
    if where == "rho":
        proof = dataclasses.replace(proof, initial_randomness=(proof.initial_randomness + 1) % g1.R)
        error = GadgetVerifyError
    elif where == "proof":
        proof = dataclasses.replace(proof, proof_vec=[(proof.proof_vec[0] + 1) % g1.R] + proof.proof_vec[1:])
        error = GKRError
    else:
        assert not store.public[2]
        store.outputs[2] = (store.outputs[2] + 1) % g1.R
        error = GKRError
    with pytest.raises(error):
        verify_gadget(gadget.circuit, setup, proof, store, device="cpu")
