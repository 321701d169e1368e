"""Seeded inputs: full-width BN254 field elements made on the device.

Every table is drawn from its own generator, seeded from (seed, proof,
lane, stream) through SHA-256, so the same seed gives the same inputs and
any seed (a Python int of any size) is accepted. An element's eight 32-bit
words are uniform, with the top word drawn below the top word of p: every
value lies below p and spans all 254 bits. The values are in standard
form; the program's Montgomery conversion runs inside the measured window.
"""

from __future__ import annotations

import hashlib

import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
TOP = P >> 224  # the top 32-bit word of p
BLOCK, STATE, POINT = 0, 1, 2  # streams


def generator(seed: int, proof: int, lane: int, stream: int, device) -> torch.Generator:
    digest = hashlib.sha256(f"bench_h100:{seed}:{proof}:{lane}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def elements(count: int, gen: torch.Generator, device) -> torch.Tensor:
    """(8, count) int32 words of field elements below p, standard form."""
    w = torch.randint(0, 1 << 32, (8, count), dtype=torch.int64, generator=gen, device=device)
    w[7] %= TOP
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def to_ints(words: torch.Tensor) -> list[int]:
    """(8, k) words -> the k integers."""
    cols = (words.to(torch.int64) & 0xFFFFFFFF).cpu().T.tolist()
    return [sum(v << (32 * i) for i, v in enumerate(col)) for col in cols]


class ProofInputs:
    """One proof's inputs: block and state (8, N), or (8, G, N) for G
    lanes, and each lane's initial point (bn ints and as (8, bn[, G])
    words)."""

    def __init__(self, seed: int, proof: int, bn: int, lanes: int, device):
        n = 1 << bn
        tables = {}
        for stream in (BLOCK, STATE):
            parts = [elements(n, generator(seed, proof, i, stream, device), device) for i in range(lanes)]
            tables[stream] = parts[0] if lanes == 1 else torch.stack(parts, dim=1)
        points = [elements(bn, generator(seed, proof, i, POINT, device), device) for i in range(lanes)]
        self.block, self.state = tables[BLOCK], tables[STATE]
        self.point_words = points[0] if lanes == 1 else torch.stack(points, dim=2)
        self.points = [to_ints(p) for p in points]
        self.hashes = lanes * n

    def nbytes(self) -> int:
        return self.block.nbytes + self.state.nbytes + self.point_words.nbytes
