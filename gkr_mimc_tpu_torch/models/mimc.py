"""The MiMC GKR circuit: 94 layers (the reference's gkr_mimc_tpu/models/mimc.py).

  layer 0: input `block` (the permutation key)
  layer 1: input `initial state`
  layer 2: Identity copy of layer 0 (it feeds all 91 cipher layers, so its
           sumcheck carries 91 claims)
  layer 3+i (i = 0..90): CipherGate(Arks[i]) with In = {2, i+2}
           (i = 0 takes layer 1, the state, directly)

The output layer 93 is MimcKeyedPermutation(state, block) per instance.
"""

from __future__ import annotations

import torch

from ..circuits.circuit import Circuit, Layer
from ..circuits.gates import CipherGate, IdentityGate
from ..fields.bn254 import L
from ..hashes.ark import ARKS_INT, arks_mont
from ..ops import kernels as K

MIMC_ROUNDS = 91


def mimc_circuit() -> Circuit:
    layers = [Layer(in_=[]), Layer(in_=[]), Layer(in_=[0], gate=IdentityGate())]
    for i in range(MIMC_ROUNDS):
        inp = i + 2 if i > 0 else 1
        layers.append(Layer(in_=[2, inp], gate=CipherGate(ARKS_INT[i])))
    return Circuit(layers)


def assign_fused(block: torch.Tensor, state: torch.Tensor) -> list:
    """Witness tables [block, state, block copy, cipher 0..90], all
    resident: the 91 cipher tables come from one witness kernel launch
    (views of one (91, 8, N) tensor). Grouped block and state tables
    (8, G, N) take one launch over the flattened G*N instances and give
    (8, G, N) views."""
    wit = K.mimc_witness(block.reshape(L, -1), state.reshape(L, -1), arks_mont(MIMC_ROUNDS, block.device))
    return [block, state, block] + [w.view(block.shape) for w in wit.unbind(0)]
