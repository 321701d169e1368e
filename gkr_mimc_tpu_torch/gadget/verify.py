"""Standalone gadget proof verification, the counterpart of
gkr_mimc_tpu/gadget/verify.py.

Rebuild the io commitment KrsGkr = (public MSM) + KrsGkrPriv, re-derive
rho from it and check it against the proof's, then parse the wire vector
and verify the whole GKR transcript on the device. The succinct check, the
reference's pairing equation over sigma-marked keys, belongs to the
Groth16 tier, which this package does not have yet.
"""

from __future__ import annotations

from ..circuits.circuit import Circuit
from ..fields import fr
from ..gkr import verifier as gkr_verifier
from ..utils.convert import ints_to_rows
from . import bn254_g1 as g1
from .gadget import GadgetProof, device_in_use, expand_qprime
from .io_store import IoStore
from .serialize import proof_from_vec
from .setup import GadgetSetup


class GadgetVerifyError(Exception):
    pass


def verify_gadget(circuit: Circuit, setup: GadgetSetup, proof: GadgetProof, io_store: IoStore,
                  device="cuda") -> None:
    """Raise GadgetVerifyError or gkr.verifier.GKRError if anything is
    inconsistent. ``io_store`` is the statement, the claimed
    (inputs -> output) batch, given to the verifier explicitly. The tables
    go to ``device``, the card unless the caller names another; with no
    card the default raises."""
    device = device_in_use(device)
    scalars = io_store.dump_for_multiexp()
    mask = io_store.multiexp_public_mask()
    pub = [s for s, m in zip(scalars, mask) if m]
    krs = g1.add(g1.msm(setup.pub_k_gkr, pub), proof.krs_gkr_priv)
    rho = g1.derive_randomness_from_point(krs)
    if rho != proof.initial_randomness:
        raise GadgetVerifyError("initial randomness does not match the io commitment")

    gkr_proof = proof_from_vec(circuit, proof.bn, proof.proof_vec, device)
    inputs = [fr.encode_mont_ints(col, device) for col in io_store.inputs_for_verifier()]
    outputs = fr.encode_mont_ints(io_store.outputs_for_verifier(), device)
    qprime = ints_to_rows(expand_qprime(rho, proof.bn), device)
    gkr_verifier.verify(circuit, gkr_proof, inputs, outputs, qprime)
