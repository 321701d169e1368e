"""The SNARK-integration layer's standalone tier: record MiMC updates
(``GkrGadget.update_hasher`` / ``update_hasher_batch``), ``close()`` to
commit, derive rho, prove on the card and serialize, and
``verify_gadget`` to check the commitment, rho and the GKR transcript.
The host crypto (G1, Keccak) runs in the native runtime (``native``).
The Groth16 tier of the reference (gkr_mimc_tpu/gadget/groth16.py,
incircuit.py) is not ported yet."""

from .gadget import GadgetProof, GkrGadget, expand_qprime
from .io_store import IoStore
from .serialize import bn_from_input_size, proof_from_vec, proof_size, proof_to_vec
from .setup import GadgetSetup, dummy_setup
from .verify import GadgetVerifyError, verify_gadget

__all__ = [
    "GadgetProof",
    "GadgetSetup",
    "GadgetVerifyError",
    "GkrGadget",
    "IoStore",
    "bn_from_input_size",
    "dummy_setup",
    "expand_qprime",
    "proof_from_vec",
    "proof_size",
    "proof_to_vec",
    "verify_gadget",
]
