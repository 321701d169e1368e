"""The plain reference: MiMC's known answer, the multilinear evaluation, the seeded inputs."""

import random

import pytest
import torch

from bench_h100.inputs import P, ProofInputs, elements, generator, to_ints
from bench_h100.reference import field, mle


def test_mimc_known_answer():
    # hash/hash_test.go:21-26 of the gnark reference (BASELINE.md)
    assert field.mimc_hash([12]) == 1808205620575546259657963589762746470347087906694759866517376279978241663265


def _mle_ints(values, point):
    t = [v % P for v in values]
    for r in reversed(point):  # the last coordinate is the index's least significant bit
        t = [(t[2 * i] + r * (t[2 * i + 1] - t[2 * i])) % P for i in range(len(t) // 2)]
    return t[0]


def _words(values):
    t = torch.tensor([[(v >> (32 * i)) & 0xFFFFFFFF for v in values] for i in range(8)], dtype=torch.int64)
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_mle_matches_python_ints(n):
    rng = random.Random(n)
    # any word pattern below 2^256 (up to 5.3 p), as lazy tables hold
    values = [rng.randrange(1 << 256) for _ in range(1 << n)]
    values[0], values[-1] = (1 << 256) - 1, 2 * P - 1
    point = [rng.randrange(P) for _ in range(n)]
    assert mle.evaluate(_words(values), point) == [_mle_ints(values, point)]
    lanes = [[rng.randrange(2 * P) for _ in range(1 << n)] for _ in range(3)]
    points = [[rng.randrange(P) for _ in range(n)] for _ in range(3)]
    table = torch.stack([_words(v) for v in lanes], dim=1)
    assert mle.evaluate(table, points) == [_mle_ints(v, q) for v, q in zip(lanes, points)]


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    seed = 2**31 + 77
    a, b = ProofInputs(seed, 0, 6, 1, "cpu"), ProofInputs(seed, 0, 6, 1, "cpu")
    assert torch.equal(a.block, b.block) and torch.equal(a.state, b.state) and a.points == b.points
    c, d = ProofInputs(seed + 1, 0, 6, 1, "cpu"), ProofInputs(seed, 1, 6, 1, "cpu")
    assert not torch.equal(a.block, c.block) and not torch.equal(a.block, d.block)
    assert not torch.equal(a.block, a.state)
    g = ProofInputs(seed, 0, 4, 3, "cpu")
    assert g.block.shape == (8, 3, 16) and g.point_words.shape == (8, 4, 3) and len(g.points) == 3
    assert not torch.equal(g.block[:, 0], g.block[:, 1])


def test_inputs_are_full_width_and_below_p():
    vals = to_ints(elements(4096, generator(2**40 + 3, 0, 0, 0, "cpu"), "cpu"))
    assert max(vals) < P and min(vals) >= 0
    assert sum(v >> 253 for v in vals) > 1000  # bit 253 set in about a third
    assert len(set(vals)) == len(vals)
