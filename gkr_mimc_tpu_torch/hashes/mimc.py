"""MiMC (91 rounds, x^7 S-box, Miyaguchi-Preneel) over BN254 fr.

Semantics of the reference (gkr_mimc_tpu/hashes/mimc.py:29-49, 57-78):
  * keyed permutation: res = x; 91 times res = (res + key + Ark[i])^7
  * hash update:       state' = Perm_state(block) + 2 * state + block
  * MimcHash: chain updates from state 0.

MimcHash is also the Fiat-Shamir challenge function. Both device hash
functions go to one lane-parallel CUDA kernel (``ops.kernels.mimc_hash`` /
``mimc_hash_g``); the batched keyed permutation is 91 launches of the
cipher-gate kernel (``ops.kernels.cipher_layer``). All device outputs are
canonical.
"""

from __future__ import annotations

import torch

from ..fields import fr, scalar
from ..fields.bn254 import L, P
from ..ops import kernels as K
from .ark import ARKS_INT, arks_mont

MIMC_ROUNDS = 91
_ROUND_ARKS = tuple(ARKS_INT[:MIMC_ROUNDS])


def mimc_keyed_permutation(x: int, key: int) -> int:
    res = x
    for ark in _ROUND_ARKS:  # pow reduces the unreduced sum: same value as add, add, pow7
        res = pow(res + key + ark, 7, P)
    return res


def mimc_update(state: int, block: int) -> int:
    perm = mimc_keyed_permutation(block, state)
    return scalar.add(scalar.add(perm, scalar.add(state, state)), block)


def mimc_hash(inputs: list[int]) -> int:
    """Host oracle on Python ints."""
    state = 0
    for x in inputs:
        state = mimc_update(state, x)
    return state


def mimc_keyed_permutation_device(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Batched keyed permutation Perm_key(x): x, key (8, N) Montgomery
    tables -> (8, N) canonical. Round i is one ``K.cipher_layer`` launch,
    the gate ((r + ark_i) + l)^7 with l = key and r = the running value."""
    arks = arks_mont(MIMC_ROUNDS, x.device)
    res = x
    for i in range(MIMC_ROUNDS):
        res = K.cipher_layer(key, res, arks[i])
    return fr.canonicalize(res)


def mimc_update_device(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One Miyaguchi-Preneel update per lane: state' = Perm_state(block) +
    2 * state + block, (8, N) Montgomery tables -> (8, N) canonical."""
    perm = mimc_keyed_permutation_device(block, state)
    return fr.canonicalize(fr.add(fr.add(perm, fr.add(state, state)), block))


def mimc_hash_device(msgs: torch.Tensor) -> torch.Tensor:
    """Transcript hash of K field elements: (8, K) -> (8,); grouped
    (8, K, G) -> (8, G)."""
    msgs = msgs.contiguous()
    if msgs.dim() == 3:
        return K.mimc_hash_g(msgs)
    return K.mimc_hash(msgs)


def mimc_hash_batch(msgs: torch.Tensor) -> torch.Tensor:
    """N independent K-word hashes in parallel lanes: (8, K, N) -> (8, N)."""
    if msgs.dim() != 3 or msgs.shape[0] != L:
        raise ValueError(f"mimc_hash_batch: shape {tuple(msgs.shape)}, expected (8, K, N)")
    return K.mimc_hash_g(msgs.contiguous())
