"""GMiMC sponge-width hashers (t in {2, 4, 8}), Miyaguchi-Preneel (the
reference's gkr_mimc_tpu/hashes/gmimc.py).

Semantics of hash/gmimc.go:8-74: each round adds (block[i] + Ark[r]) to
every state word, applies the x^7 S-box to word 0, then rotates the state
left by one. The device S-box is the ``pow7`` kernel (``ops.kernels``).
"""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L
from ..ops import kernels as K
from .ark import ARKS_INT, arks_mont


class GMimcHasher:
    def __init__(self, t: int, n_rounds: int = 91):
        self.t = t
        self.n_rounds = n_rounds

    # -- scalar (host oracle) ------------------------------------------------

    def update(self, state: list[int], block: list[int]) -> list[int]:
        s = list(state)
        for r in range(self.n_rounds):
            s = [scalar.add(scalar.add(x, block[i]), ARKS_INT[r]) for i, x in enumerate(s)]
            s[0] = scalar.pow7(s[0])
            s = s[1:] + s[:1]
        return [scalar.add(scalar.add(x, state[i]), block[i]) for i, x in enumerate(s)]

    def hash(self, msg: list[int]) -> int:
        state = [0] * self.t
        for i in range(0, max(len(msg), 1), self.t):
            block = list(msg[i : i + self.t]) + [0] * (self.t - len(msg[i : i + self.t]))
            state = self.update(state, block)
        return state[0]

    # -- device (batched) ----------------------------------------------------

    def update_device(self, state: list, block: list) -> list:
        """state, block: lists of t (8, *S) Montgomery tensors, carried as
        one (8, t, *S) tensor through the rounds."""
        batch_ndim = state[0].dim() - 1
        arks = arks_mont(self.n_rounds, state[0].device)
        s0, blk = torch.stack(state, 1), torch.stack(block, 1)
        s = s0
        for r in range(self.n_rounds):
            s = fr.add(fr.add(s, blk), arks[r].reshape((L,) + (1,) * (batch_ndim + 1)))
            s = torch.cat([s[:, 1:], K.pow7_batch(s[:, :1])], 1)  # S-box on word 0, rotate left
        return list(fr.add(fr.add(s, s0), blk).unbind(1))

    def hash_batch(self, msgs: torch.Tensor) -> torch.Tensor:
        """msgs (8, K, N) -> (8, N): N independent K-word messages."""
        k, batch = msgs.shape[1], msgs.shape[2:]
        state = [fr.zeros(batch, msgs.device) for _ in range(self.t)]
        for i in range(0, max(k, 1), self.t):
            block = [msgs[:, i + j] if i + j < k else fr.zeros(batch, msgs.device) for j in range(self.t)]
            state = self.update_device(state, block)
        return state[0]


GMIMC_T2 = GMimcHasher(2)
GMIMC_T4 = GMimcHasher(4)
GMIMC_T8 = GMimcHasher(8)
