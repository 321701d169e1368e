"""Checkpointed MiMC witness (the reference's gkr_mimc_tpu/models/checkpoint.py).

A resident witness is 94 tables of 2**bn entries, 32 B each: 101 GB at
bn = 25, more than the card holds. The witness is a cheap forward scan, so
instead of every table this keeps the scan state entering every
``stride``-th round and regenerates a span of ``stride`` tables when the
GKR walk first reads one of them, as the walk descends from the output.
Each cipher table is read once (layer l reads table l - 1), so a span is
freed as soon as its last row has been handed out: one extra witness pass
in all, for about a quarter of the residency at stride 13 (91 = 7 * 13).

Departures from the reference, each a defect it has there
(ADVICE.md:3-5) or a trap that only torch sets:

* a second read of a consumed table raises an error naming the table, its
  span and "single-use" (the reference would regenerate from a freed
  checkpoint and fail opaquely);
* the output table is pinned once, when the last span is made, so no span
  is ever made twice and no stale marker keeps a span alive;
* a row is handed out as a copy (``clone``), as the reference's JAX slice
  is: a view would keep its whole span (13 tables, 13.9 GB at bn = 25)
  alive for as long as the row lives. The checkpoints and the pinned
  output are copies for the same reason.
"""

from __future__ import annotations

import torch

from ..fields.bn254 import L
from ..hashes.ark import arks_mont
from ..ops import kernels as K
from .mimc import MIMC_ROUNDS

N_TABLES = MIMC_ROUNDS + 3  # block, state, block copy, the 91 cipher tables


def _witness_span(block: torch.Tensor, state: torch.Tensor, r0: int, nr: int) -> torch.Tensor:
    """The cipher tables of witness rounds r0 .. r0 + nr - 1 from the state
    entering round r0, in one ``mimc_witness`` launch: -> (nr, *block.shape)."""
    arks = arks_mont(MIMC_ROUNDS, block.device)[r0 : r0 + nr]
    wit = K.mimc_witness(block.reshape(L, -1), state.reshape(L, -1), arks)
    return wit.reshape((nr,) + tuple(block.shape))


class CheckpointedAssignment:
    """The MiMC witness as the GKR walk reads it (``assignment[j]``,
    ``len(assignment)``): tables 0 and 2 are the block, 1 the state, 3..93
    the cipher tables (93 the output). Single or grouped ((8, N) or
    (8, G, N)) tables, on the device of the inputs.

    Span i covers witness rounds [i * stride, min((i + 1) * stride, 91)),
    tables 3 + r for r in that range; ``_ckpt[i]`` is the scan state
    entering span i until the span is made."""

    def __init__(self, block: torch.Tensor, state: torch.Tensor, stride: int = 13):
        if block.shape != state.shape or block.shape[0] != L:
            raise ValueError(f"block {tuple(block.shape)} and state {tuple(state.shape)}: expected equal (8, ...)")
        if stride < 1:
            raise ValueError(f"stride={stride}")
        self.block, self.state, self.stride = block, state, stride
        self.n_spans = -(-MIMC_ROUNDS // stride)
        self._ckpt: list = [None] * self.n_spans
        self._spans: list = [None] * self.n_spans
        self._live = [0] * self.n_spans  # rows of a made span not yet handed out
        self._cache: dict = {}  # cipher table j -> (span, row) until it is handed out
        self._consumed: set = set()
        cur = state
        for i in range(self.n_spans):  # the forward pass: keep each span's entry state
            self._ckpt[i] = cur
            if i < self.n_spans - 1:
                r0, nr = self._range(i)
                cur = _witness_span(block, cur, r0, nr)[nr - 1].clone()  # the span itself is dropped
        self._fill_span(self.n_spans - 1)  # the walk starts at the top; the output is pinned here

    def _range(self, i: int) -> tuple:
        r0 = i * self.stride
        return r0, min(self.stride, MIMC_ROUNDS - r0)

    def _fill_span(self, i: int) -> None:
        """Make span i once, as one (nr, ...) buffer, and free its
        checkpoint; the output table is copied out of the last span."""
        r0, nr = self._range(i)
        span = _witness_span(self.block, self._ckpt[i], r0, nr)
        self._ckpt[i] = None
        rows = range(nr - 1) if i == self.n_spans - 1 else range(nr)
        if i == self.n_spans - 1:
            self.output = span[nr - 1].clone()
        for r in rows:
            self._cache[3 + r0 + r] = (i, r)
        self._live[i] = len(rows)
        self._spans[i] = span if rows else None

    def _take(self, j: int) -> torch.Tensor:
        i, r = self._cache.pop(j)
        row = self._spans[i][r].clone()
        self._consumed.add(j)
        self._live[i] -= 1
        if self._live[i] == 0:
            self._spans[i] = None
        return row

    def __len__(self) -> int:
        return N_TABLES

    def __getitem__(self, j: int) -> torch.Tensor:
        if not -N_TABLES <= j < N_TABLES:
            raise IndexError(f"table {j} of {N_TABLES}")
        j %= N_TABLES
        if j in (0, 2):
            return self.block
        if j == 1:
            return self.state
        if j == N_TABLES - 1:
            return self.output  # pinned: the verifier reads it after the walk
        i = (j - 3) // self.stride
        if j in self._consumed:
            raise RuntimeError(f"CheckpointedAssignment: table {j} (span {i}) was already read; the cipher "
                               "tables are single-use")
        if j not in self._cache:
            self._fill_span(i)
        return self._take(j)
