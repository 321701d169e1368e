"""The port's lazy field arithmetic (gkr_mimc_tpu_torch.fields.fr) against
host ints: both of its paths (host ints for small CPU batches, torch limbs
for large ones) give the same bits, every value below 2p.

    python -m pytest tests/test_torch_field_lazy.py -q -p no:cacheprovider
"""

import pytest
import torch

from gkr_mimc_tpu_torch.fields import bn254, fr
from torch_common import both, lazy_ints

P = bn254.P


def test_ops_stay_lazy_and_agree_across_paths():
    """Both paths give the same bits (not only values), all below 2p."""
    a, _ = both(lazy_ints(100, 3))
    b, _ = both(lazy_ints(100, 4))
    small = [(fr.mul(a[:, i : i + 1], b[:, i : i + 1]), fr.add(a[:, i : i + 1], b[:, i : i + 1])) for i in range(100)]
    big_mul, big_add = fr.mul(a, b), fr.add(a, b)
    assert torch.equal(torch.cat([m for m, _ in small], 1), big_mul)
    assert torch.equal(torch.cat([s for _, s in small], 1), big_add)
    assert max(fr.limb_values(big_mul)) < 2 * P
    assert fr.limb_values(fr.canonicalize(big_mul)) == [v % P for v in fr.limb_values(big_mul)]


@pytest.mark.parametrize("c", [1, 7, 21, 35])
def test_mul_small_is_the_held_multiple_mod_2p(c):
    """c * a by doubling and adding: the held integer c * a mod 2p, the
    same bits on the host-int and the torch limb paths (the binomial
    scaling of cipher_coeff_acc)."""
    vals = lazy_ints(100, 6)
    a = fr._limb_tensor(vals)
    want = [c * v % (2 * P) for v in vals]
    assert fr.limb_values(fr.mul_small(a, c)) == want
    assert fr.limb_values(fr.mul_small(a[:, :40], c)) == want[:40]


def test_reduce_sum_matches_host_sums():
    vals = lazy_ints(3 * 37, 5)
    t = fr._limb_tensor(vals).reshape(8, 3, 37)
    got = fr.to_ints(fr.reduce_sum(t, 1))
    assert got == [sum(vals[37 * i : 37 * i + 37]) * bn254.RINV % P for i in range(3)]
