"""The system under test, as the benchmark drives it: the PyTorch and CUDA
prover ``gkr_mimc_tpu_torch``, through its own API.

One proof is the conversion of the inputs to Montgomery form
(``fields.fr.to_mont``), the witness (``models.mimc.assign_fused``, all 94
tables resident, or ``models.checkpoint.CheckpointedAssignment``, which
keeps a checkpoint every ``stride`` rounds and recomputes a span of tables
when the walk first reads one) and ``gkr.prover.prove`` over the MiMC-91
circuit. Nothing of the program is imported before ``Prover`` is made, and
nothing but these modules: not the gadget, not the host runtime.
"""

from __future__ import annotations

import importlib

import torch


class Prover:
    """The program's prover for one configuration on one device."""

    def __init__(self, config: dict, device: torch.device):
        self.fr = importlib.import_module("gkr_mimc_tpu_torch.fields.fr")
        self.gkr = importlib.import_module("gkr_mimc_tpu_torch.gkr.prover")
        mimc = importlib.import_module("gkr_mimc_tpu_torch.models.mimc")
        if device.type == "cuda":
            importlib.import_module("gkr_mimc_tpu_torch.ops.build").library()  # built once per checkout
        self.circuit = mimc.mimc_circuit()
        self.rounds = config["rounds"]
        if config["witness"] == "resident":
            self.assign = mimc.assign_fused
        elif config["witness"] == "checkpointed":
            ckpt = importlib.import_module("gkr_mimc_tpu_torch.models.checkpoint")
            self.assign = lambda block, state: ckpt.CheckpointedAssignment(block, state, stride=config["stride"])
        else:
            raise ValueError(f"witness {config['witness']!r}: expected resident or checkpointed")

    def witness(self, inputs):
        """-> (witness, initial point rows (bn[, G], 8)) from standard-form inputs."""
        fr = self.fr
        q = fr.canonicalize(fr.to_mont(inputs.point_words))
        q = q.movedim(0, -1).contiguous()
        return self.assign(fr.to_mont(inputs.block), fr.to_mont(inputs.state)), q

    def prove(self, witness, qprime):
        return self.gkr.prove(self.circuit, witness, qprime, rounds=self.rounds)

    @staticmethod
    def output(witness) -> torch.Tensor:
        """A copy of the output table, so that it does not pin the witness."""
        return witness[len(witness) - 1].clone()

    @staticmethod
    def proof_arrays(proof, lanes: int) -> dict:
        """The proof's tensors on the host, as the reference reads them."""

        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        sps = proof.sumcheck_proofs
        return {
            "lanes": lanes if lanes > 1 else 0,
            "coeffs": [None if p is None else host(p.coeffs) for p in sps],
            "challenges": [None if p is None else host(p.challenges) for p in sps],
            "final_claims": [None if p is None else host(p.final_claims) for p in sps],
            "claims": [host(c) for c in proof.claims],
            "qprimes": [host(q) for q in proof.qprimes],
        }
