"""The port's CUDA kernels against their plain torch twins, bit for bit.

These tests need a CUDA device and skip elsewhere (the kernels have no CPU
mode). The file imports neither jax nor gkr_mimc_tpu, so it also runs on a
machine without JAX; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.hashes.ark import arks_mont
from gkr_mimc_tpu_torch.ops import kernels as K

TWO_P_TOP = 0x60C89CE5  # top 32-bit limb of 2p


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _cases(rng, dev):
    """Per kernel: argument tuples at the smallest sizes, ragged blocks
    and several groups."""

    def r(*shape):
        limbs = rng.integers(0, 1 << 32, size=(L,) + shape, dtype=np.uint64)
        limbs[L - 1] %= TWO_P_TOP
        return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)

    arks = arks_mont(91, dev)
    return {
        "mimc_witness": [(r(1), r(1), arks), (r(300), r(300), arks)],
        "mimc_hash": [(r(1),), (r(9),), (r(130),)],
        "mimc_hash_g": [(r(9, 1),), (r(3, 70),)],
        "fold": [([r(2)], r(1)), ([r(3 * 64), r(3 * 64)], r(3)), ([r(600 * 4)] * 4, r(600)),
                 ([r(4 * 1024) for _ in range(3)], r(4))],
        "suffix_step": [(r(1), r(1)), (r(3 * 32), r(3)), (r(1 << 12), r(1))],
        "multi_eq": [(r(1, 1).permute(1, 0, 2).contiguous(), r(1, 2)),
                     (r(5, 91).permute(1, 0, 2).contiguous(), r(91, 64)),
                     (r(8, 1).permute(1, 0, 2).contiguous(), r(1, 1024))],
        "mul_scalar": [(r(1), r(1)[:, 0].contiguous()), (r(700), r(1)[:, 0].contiguous())],
        "gruen_acc": [(r(1), r(2), r(2), r(1)), (r(3 * 512), r(3 * 1024), r(3 * 1024), r(3)),
                      (r(1 << 15), r(1 << 16), r(1 << 16), r(1))],
        "cipher_coeff_acc": [(r(2), r(2), r(2), r(1), 1), (r(3 * 1024), r(3 * 1024), r(3 * 1024), r(3), 3),
                             (r(1 << 16), r(1 << 16), r(1 << 16), r(1), 1)],
        "identity_acc": [(r(2), r(2), 1), (r(3 * 1024), r(3 * 1024), 3), (r(1 << 16), r(1 << 16), 1)],
        "cipher_partial_evals": [(r(2), r(2), r(2), r(1), 1, 9, False), (r(4 * 512), r(4 * 512), r(4 * 512), r(4), 4, 9, True),
                                 (r(1 << 16), r(1 << 16), r(1 << 16), r(1), 1, 9, True)],
        "identity_partial_evals": [(r(2), r(2), 1, 3, True), (r(4 * 512), r(4 * 512), 4, 3, False),
                                   (r(1 << 16), r(1 << 16), 1, 3, True)],
        "pow7": [(r(1),), (r(300),), (r(1 << 16),)],
        "cipher_layer": [(r(1), r(1), r(1)[:, 0].contiguous()), (r(300), r(300), r(1)[:, 0].contiguous()),
                         (r(1 << 16), r(1 << 16), r(1)[:, 0].contiguous())],
        "gruen_round_scalar": [(r(8, 1), r(1), r(1), r(1), r(1)), (r(8, 3), r(3), r(3), r(3), r(3)),
                               (r(8, 70), r(70), r(70), r(70), r(70))],
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_matches_plain_twin(cuda_device, name):
    for args in _cases(np.random.default_rng(7), cuda_device)[name]:
        before = K.LAUNCHES[name]
        got = getattr(K, name)(*args)
        want = K.PLAIN[name](*args)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 1
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
