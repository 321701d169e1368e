"""Deterministic inputs and small math helpers (the reference's common/)."""

from __future__ import annotations

import torch

from ..fields import fr
from ..fields.bn254 import L, P
from ..hashes.mimc import mimc_hash
from .convert import ints_to_rows

_RAND_XOR = 0xF45C9DF123F
_U64 = 1 << 64


def get_challenge(seed: list[int]) -> int:
    """Fiat-Shamir challenge = MimcHash(seed)."""
    return mimc_hash(seed)


def random_fr_array(size: int) -> list[int]:
    """Deterministic field elements, bit-exact with the reference's
    generator (gkr_mimc_tpu/utils/common.py:40-44):
    res[i] = SetUint64(uint64(i*i) ^ 0xf45c9df123f)."""
    return [(((i * i) % _U64) ^ _RAND_XOR) % P for i in range(size)]


def random_fr_device(size: int, offset: int = 0, device="cuda") -> torch.Tensor:
    """The same generator computed on the device: (8, size) standard-form
    limbs (not Montgomery), on the card unless ``device`` says otherwise.
    i*i mod 2**64 is built from 16-bit halves in int64 (no overflow), then
    the XOR constant is applied per 32-bit limb. Requires
    offset + size <= 2**32."""
    if offset < 0 or offset + size > 1 << 32:
        raise ValueError(f"index range [{offset}, {offset + size}) leaves [0, 2**32)")
    i = torch.arange(offset, offset + size, dtype=torch.int64, device=device)
    h, lo = i >> 16, i & 0xFFFF
    p0, pm, p2 = lo * lo, h * lo, h * h  # i*i = p0 + 2 pm 2**16 + p2 2**32
    c0 = p0 + ((2 * pm) & 0xFFFF) * (1 << 16)  # < 2**33
    c1 = ((2 * pm) >> 16) + p2 + (c0 >> 32)
    limb0 = (c0 & 0xFFFFFFFF) ^ (_RAND_XOR & 0xFFFFFFFF)
    limb1 = (c1 & 0xFFFFFFFF) ^ (_RAND_XOR >> 32)
    out = torch.zeros((L, size), dtype=torch.int64, device=device)
    out[0], out[1] = limb0, limb1
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def grouped_inputs(bn: int, g: int, device="cuda"):
    """Inputs of G independent 2**bn-hash instances, as the reference's
    grouped bench builds them (bench.py:260-277): lane i's block is the
    generator's stream at offset i * 2**bn, its state the stream at offset
    (G + i) * 2**bn, its initial evaluation point random_fr_array(bn + i)[i:].
    -> block, state (8, G, 2**bn) Montgomery tables and qprime (bn, G, 8)
    rows, on the card unless ``device`` says otherwise."""
    n = 1 << bn
    block = fr.to_mont(random_fr_device(g * n, 0, device)).reshape(L, g, n)
    state = fr.to_mont(random_fr_device(g * n, g * n, device)).reshape(L, g, n)
    qprime = ints_to_rows([random_fr_array(bn + i)[i:] for i in range(g)], device).transpose(0, 1)
    return block, state, qprime.contiguous()
