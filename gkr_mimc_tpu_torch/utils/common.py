"""Deterministic inputs and small math helpers (the reference's common/)."""

from __future__ import annotations

import torch

from ..fields import fr
from ..fields.bn254 import L, P
from ..hashes.mimc import mimc_hash
from .convert import ints_to_rows

_RAND_XOR = 0xF45C9DF123F
_U64 = 1 << 64


def log2_floor(x: int) -> int:
    """The largest k with 2**k <= x (0 for x <= 1)."""
    res = 0
    while (1 << (res + 1)) <= x:
        res += 1
    return res


def log2_ceil(x: int) -> int:
    """The smallest k with 2**k >= x (0 for x <= 1)."""
    f = log2_floor(x)
    return f + (0 if x == (1 << f) else 1)


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
    limbs (not Montgomery) of elements offset .. offset + size - 1, on the
    card unless ``device`` says otherwise. Requires
    offset + size <= 2**32."""
    if offset < 0 or offset + size > 1 << 32:
        raise ValueError(f"index range [{offset}, {offset + size}) leaves [0, 2**32)")
    return random_fr_at(torch.arange(offset, offset + size, dtype=torch.int64, device=device))


def random_fr_at(idx: torch.Tensor) -> torch.Tensor:
    """The generator at the given indices (the reference's
    ``random_fr_array_np``, gkr_mimc_tpu/utils/common.py:47, at any index
    set): idx (k,) int64 in [0, 2**32) -> (8, k) standard-form limbs on
    idx's device (the caller keeps the indices in range: checking them
    would wait for the device). A shard builds its slab from its own
    indices rank + D * j. i*i mod 2**64 is built from 16-bit halves in int64 (no
    overflow), then the XOR constant is applied per 32-bit limb."""
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"random_fr_at: expected a 1-D int64 index tensor, got {idx.dtype} {tuple(idx.shape)}")
    h, lo = idx >> 16, idx & 0xFFFF
    p0, pm, p2 = lo * lo, h * lo, h * h  # i*i = p0 + 2 pm 2**16 + p2 2**32
    c0 = p0 + ((2 * pm) & 0xFFFF) * (1 << 16)  # < 2**33
    c1 = ((2 * pm) >> 16) + p2 + (c0 >> 32)
    limb0 = (c0 & 0xFFFFFFFF) ^ (_RAND_XOR & 0xFFFFFFFF)
    limb1 = (c1 & 0xFFFFFFFF) ^ (_RAND_XOR >> 32)
    out = torch.zeros((L, idx.numel()), dtype=torch.int64, device=idx.device)
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
