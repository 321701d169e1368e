"""The SNARK-integration layer, the counterpart of gkr_mimc_tpu/gadget/.

Two tiers:

  * the standalone gadget: record MiMC updates (``GkrGadget.update_hasher``
    / ``update_hasher_batch``), then ``close()`` pads the batch, commits to
    the ios (G1 MSM, Keccak, rho), proves on the card and serializes;
    ``verify_gadget`` checks the commitment, rho and the GKR transcript;
  * the Groth16 pipeline (``incircuit``, ``groth16``): wrap a user circuit
    with ``GadgetCircuit``, then compile, ``setup``, prove and
    ``groth16.verify``, with the split-K multiexp, the sigma-marked keys
    and the 4-term pairing check. The hash and GKR prover hints run on the
    card; the tracing, the in-circuit verifier (``snark``), the keys,
    computeH, the MSMs and the pairings on the host.

Host crypto: ``bn254_g1``, ``bn254_g2``, ``tower``, ``pairing`` and
``keccak``, with every batch in the native runtime (``native``), which
raises when it cannot build.
"""

from .gadget import GadgetProof, GkrGadget, expand_qprime
from .groth16 import GadgetGroth16Proof, Groth16ProvingKey, Groth16VerifyError, Groth16VerifyingKey
from .incircuit import GadgetCircuit, InCircuitGkrGadget, Solution
from .io_store import IoStore
from .serialize import bn_from_input_size, proof_from_vec, proof_size, proof_to_vec
from .setup import GadgetSetup, dummy_setup
from .verify import GadgetVerifyError, verify_gadget

__all__ = [
    "GadgetCircuit",
    "GadgetGroth16Proof",
    "GadgetProof",
    "GadgetSetup",
    "GadgetVerifyError",
    "GkrGadget",
    "Groth16ProvingKey",
    "Groth16VerifyError",
    "Groth16VerifyingKey",
    "InCircuitGkrGadget",
    "IoStore",
    "Solution",
    "bn_from_input_size",
    "dummy_setup",
    "expand_qprime",
    "proof_from_vec",
    "proof_size",
    "proof_to_vec",
    "verify_gadget",
]
