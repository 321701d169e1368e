"""GkrGadget: the batch-hashing service API, the counterpart of
gkr_mimc_tpu/gadget/gadget.py.

Record MiMC updates (``update_hasher`` one at a time on the host,
``update_hasher_batch`` N at once on the card), then ``close()`` pads the
batch to 2**bN, commits to every io with the split G1 MSM, derives the
initial randomness rho from the commitment with Keccak, expands rho into
the initial evaluation point qPrime, builds the witness and proves the
batch with the port's GKR walk, checks the proof with the port's verifier,
and serializes it in the reference's hint wire format. The same pipeline
as the reference's gnark gadget, with the constraint system replaced by
eager host and device work; ``GadgetProof`` carries what its Groth16
wrapper would consume (rho, KrsGkrPriv and the proof vector).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuits import circuit as circ_mod
from ..circuits.circuit import Circuit, assign_scalar
from ..fields import fr, scalar
from ..gkr import prover as gkr_prover
from ..gkr import verifier as gkr_verifier
from ..hashes.mimc import mimc_keyed_permutation, mimc_keyed_permutation_device
from ..models.mimc import mimc_circuit
from ..utils.common import log2_ceil
from ..utils.convert import ints_to_rows
from . import bn254_g1 as g1
from .io_store import IoStore
from .serialize import proof_to_vec
from .setup import GadgetSetup, dummy_setup


@dataclass
class GadgetProof:
    """The GKR part of the reference's proof and public witness: the
    sigma-marked private io commitment, the public initial randomness and
    the serialized GKR proof."""

    bn: int
    initial_randomness: int
    krs_gkr_priv: tuple  # Jacobian G1 point
    proof_vec: list[int]


# the padding output of the MiMC-91 circuit: Perm_0(0)
_HASH_OF_ZEROES = mimc_keyed_permutation(0, 0)


def zero_output(circuit: Circuit) -> int:
    """The circuit's output on all-zero inputs: the recorded output of a
    padding entry. For the 94-layer MiMC-91 circuit it must be
    ``_HASH_OF_ZEROES``."""
    out = assign_scalar(circuit, [[0]] * circuit.input_arity())[-1][0]
    assert len(circuit) != 94 or out == _HASH_OF_ZEROES
    return out


def expand_qprime(rho: int, bn: int) -> list[int]:
    """qPrime = [rho, rho^2, rho^4, ...] by successive squaring."""
    out = []
    tmp = rho
    for _ in range(bn):
        out.append(tmp)
        tmp = scalar.mul(tmp, tmp)
    return out


def device_in_use(device) -> torch.device:
    """``device`` as a torch.device, checked usable now: naming the card
    with no card raises here, before any host work."""
    device = torch.device(device)
    torch.empty(0, device=device)
    return device


class GkrGadget:
    def __init__(self, circuit: Circuit | None = None, device="cuda"):
        """The default circuit is MiMC-91, as the reference's; any circuit
        works through ``push_io``, padded with its own output on zeros.
        Tensors go to ``device``, the card unless the caller names another;
        with no card the default raises."""
        self.device = device_in_use(device)
        self.circuit = circuit if circuit is not None else mimc_circuit()
        self.io_store = IoStore(input_arity=self.circuit.input_arity())
        self._zero_output: int | None = None

    def push_io(self, inputs: list[int], output: int, public: bool = False) -> None:
        """Record one io entry (inputs in the circuit's input-layer order);
        close(check=True) holds every recorded output to the witness."""
        self.io_store.push(inputs, output, public)

    def _pad_output(self) -> int:
        """The circuit's output on all-zero inputs: the padding entries'
        recorded output (for MiMC-91, Perm_0(0))."""
        if self._zero_output is None:
            self._zero_output = zero_output(self.circuit)
        return self._zero_output

    def update_hasher(self, state: int, msg: int, public: bool = False) -> int:
        """One Miyaguchi-Preneel update on the host; returns the new state.
        The circuit proves the keyed permutation, so the completion
        perm + 2 * state + msg happens here."""
        perm = mimc_keyed_permutation(msg, state)
        self.io_store.push([state, msg], perm, public)
        return scalar.add(scalar.add(perm, scalar.add(state, state)), msg)

    def update_hasher_batch(self, states: list[int], msgs: list[int], public: bool = False) -> list[int]:
        """N independent updates, the keyed permutations on the device in
        one batch (91 ``cipher_layer`` launches); returns the new states."""
        if len(states) != len(msgs):
            raise ValueError("states and msgs must have equal length")
        perms = mimc_keyed_permutation_device(
            fr.encode_mont_ints(msgs, self.device), fr.encode_mont_ints(states, self.device)
        )
        out = []
        for s, m, p in zip(states, msgs, fr.to_ints(perms)):
            self.io_store.push([s, m], p, public)
            out.append(scalar.add(scalar.add(p, scalar.add(s, s)), m))
        return out

    def _pad(self) -> int:
        """Pad the io batch to a power of two with all-zero-input private
        entries; returns bN."""
        if self.io_store.index == 0:
            raise ValueError("close() on an empty gadget")
        bn = log2_ceil(self.io_store.index)
        zeros = [0] * self.io_store.input_arity
        pad_out = self._pad_output()
        while self.io_store.index < (1 << bn):
            self.io_store.push(zeros, pad_out, public=False)
        return bn

    def get_initial_randomness(self, setup: GadgetSetup) -> tuple[int, tuple, tuple]:
        """Commit to all ios with the split MSM and Keccak-derive rho.
        Returns (rho, KrsGkr, KrsGkrPriv)."""
        scalars = self.io_store.dump_for_multiexp()
        mask = self.io_store.multiexp_public_mask()
        pub = [s for s, m in zip(scalars, mask) if m]
        priv = [s for s, m in zip(scalars, mask) if not m]
        if len(pub) != len(setup.pub_k_gkr) or len(priv) != len(setup.priv_k_gkr_sigma):
            raise ValueError(
                f"setup sized for ({len(setup.pub_k_gkr)} pub, {len(setup.priv_k_gkr_sigma)} priv) ios, "
                f"gadget has ({len(pub)}, {len(priv)})"
            )
        krs_priv = g1.msm(setup.priv_k_gkr_sigma, priv)
        krs = g1.add(g1.msm(setup.pub_k_gkr, pub), krs_priv)
        return g1.derive_randomness_from_point(krs), krs, krs_priv

    def make_setup(self, seed: bytes = b"gkr-mimc-tpu") -> GadgetSetup:
        """Dummy setup sized to this gadget's padded io partition (padding
        entries are private)."""
        bn = log2_ceil(max(self.io_store.index, 1))
        n = (1 << bn) * (self.io_store.input_arity + 1)
        n_pub = sum(self.io_store.public) * (self.io_store.input_arity + 1)
        return dummy_setup(n_pub, n - n_pub, seed)

    def close(self, setup: GadgetSetup | None = None, check: bool = True) -> GadgetProof:
        """Pad, commit, prove on the device, serialize; with ``check`` also
        verify the proof and hold the witness outputs to the recorded ios."""
        bn = self._pad()
        if setup is None:
            setup = self.make_setup()
        rho, _krs, krs_priv = self.get_initial_randomness(setup)
        qprime = ints_to_rows(expand_qprime(rho, bn), self.device)
        inputs = [fr.encode_mont_ints(col, self.device) for col in self.io_store.inputs_for_verifier()]
        a = circ_mod.assign(self.circuit, inputs)
        proof = gkr_prover.prove(self.circuit, a, qprime)
        if check:
            gkr_verifier.verify(self.circuit, proof, inputs, a[-1], qprime)
            if fr.to_ints(a[-1]) != self.io_store.outputs_for_verifier():
                raise ValueError("witness outputs disagree with recorded ios")
        return GadgetProof(bn=bn, initial_randomness=rho, krs_gkr_priv=krs_priv,
                           proof_vec=proof_to_vec(self.circuit, proof))
