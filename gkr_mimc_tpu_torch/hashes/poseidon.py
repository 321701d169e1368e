"""Poseidon hashers (t in {2, 4, 8}), Cauchy MDS, Miyaguchi-Preneel (the
reference's gkr_mimc_tpu/hashes/poseidon.py).

Semantics: RF=8 leading full rounds, RP partial rounds (82/83/84), RF
trailing full rounds; every round adds (block[i] + Ark[r]) to each word,
S-boxes (all words / word 0), then multiplies by the Cauchy matrix
1/(x_i + y_j) — the algorithm hash/poseidon.go:18-157 *intends*.

KNOWN PARITY DIVERGENCE from the Go reference's caller-visible values:
`MatrixMultiplication` returns a NEW slice, so the reference's
`PoseidonHasher.Update` (hash/poseidon.go:68-97) rebinds its local
`state` variable after the first MDS multiply — every later round and
the final Miyaguchi-Preneel recombination write into that new slice,
never the caller's array. `Hash` (hash/poseidon.go:43-63) then reads
`state[0]` from ITS array, which only saw the first round's in-place
ark/S-box — a Go aliasing accident, not a protocol choice. This module
implements the intended Miyaguchi-Preneel construction, so `hash()`
outputs differ from the Go binary's. Nothing downstream is affected:
Poseidon never feeds a transcript (the Fiat-Shamir hash is MiMC,
common/challenge.go:10-12) and the reference has no Poseidon GKR
circuit. The GKR-circuit parity target (models/poseidon.py) is the
*permutation*, which both implementations agree on.

The device S-boxes are the ``pow7`` kernel (``ops.kernels``); the MDS
multiply is plain field ops (t <= 8: the batch axis carries the
parallelism).
"""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L
from ..ops import kernels as K
from .ark import ARKS_INT, XARR_INT, YARR_INT, arks_mont


def generate_mds_matrix(t: int) -> list[list[int]]:
    return [[scalar.inverse(scalar.add(XARR_INT[i], YARR_INT[j])) for j in range(t)] for i in range(t)]


class PoseidonHasher:
    def __init__(self, t: int, n_rounds_f: int, n_rounds_p: int):
        self.t = t
        self.n_rounds_f = n_rounds_f
        self.n_rounds_p = n_rounds_p
        self.cauchy = generate_mds_matrix(t)

    def _partial(self, r: int) -> bool:
        return self.n_rounds_f <= r < self.n_rounds_f + self.n_rounds_p

    # -- scalar (host oracle) ------------------------------------------------

    def _matmul(self, vec):
        return [sum(scalar.mul(self.cauchy[i][j], vec[j]) for j in range(self.t)) % scalar.P for i in range(self.t)]

    def update(self, state: list[int], block: list[int]) -> list[int]:
        s = list(state)
        for r in range(2 * self.n_rounds_f + self.n_rounds_p):
            s = [scalar.add(scalar.add(x, block[i]), ARKS_INT[r]) for i, x in enumerate(s)]
            if self._partial(r):
                s[0] = scalar.pow7(s[0])
            else:
                s = [scalar.pow7(x) for x in s]
            s = self._matmul(s)
        return [scalar.add(scalar.add(x, state[i]), block[i]) for i, x in enumerate(s)]

    def hash(self, msg: list[int]) -> int:
        state = [0] * self.t
        for i in range(0, max(len(msg), 1), self.t):
            block = list(msg[i : i + self.t]) + [0] * (self.t - len(msg[i : i + self.t]))
            state = self.update(state, block)
        return state[0]

    # -- device (batched) ----------------------------------------------------

    def update_device(self, state: list, block: list) -> list:
        """state, block: lists of t (8, *S) Montgomery tensors. The words
        ride one (8, t, *S) tensor: a round's S-boxes are one ``pow7``
        launch, its MDS multiply one product and a sum over the words."""
        device, batch_ndim = state[0].device, state[0].dim() - 1
        arks = arks_mont(2 * self.n_rounds_f + self.n_rounds_p, device)
        mds = fr.encode_mont_ints([c for row in self.cauchy for c in row], device)
        mds = mds.reshape((L, self.t, self.t) + (1,) * batch_ndim)
        s0, blk = torch.stack(state, 1), torch.stack(block, 1)
        s = s0
        for r in range(arks.shape[0]):
            s = fr.add(fr.add(s, blk), arks[r].reshape((L,) + (1,) * (batch_ndim + 1)))
            if self._partial(r):
                s = torch.cat([K.pow7_batch(s[:, :1]), s[:, 1:]], 1)
            else:
                s = K.pow7_batch(s)
            s = fr.reduce_sum(fr.mul(mds, s.unsqueeze(1)), 1)  # s'_i = sum_j M[i][j] s_j
        return list(fr.add(fr.add(s, s0), blk).unbind(1))

    def hash_batch(self, msgs: torch.Tensor) -> torch.Tensor:
        """msgs (8, K, N) -> (8, N): N independent K-word messages."""
        k, batch = msgs.shape[1], msgs.shape[2:]
        state = [fr.zeros(batch, msgs.device) for _ in range(self.t)]
        for i in range(0, max(k, 1), self.t):
            block = [msgs[:, i + j] if i + j < k else fr.zeros(batch, msgs.device) for j in range(self.t)]
            state = self.update_device(state, block)
        return state[0]


POSEIDON_T2 = PoseidonHasher(2, 8, 82)
POSEIDON_T4 = PoseidonHasher(4, 8, 83)
POSEIDON_T8 = PoseidonHasher(8, 8, 84)
