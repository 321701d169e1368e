"""The port's field operations (gkr_mimc_tpu_torch.fields.fr) against the
JAX package's (gkr_mimc_tpu.fields.fr).

Same integers go through the JAX package's 16-bit limbs and the port's
32-bit limbs; results are compared as canonical field values, exactly.
Inputs include lazy representatives up to 2p - 1. Both of the port's
paths run: host ints for small CPU batches and the torch limb arithmetic
(the one the card uses) for large ones.

    python -m pytest tests/test_torch_field_ops.py -q -p no:cacheprovider
"""

import jax
import pytest

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu_torch.fields import fr
from torch_common import both, lazy_ints


@pytest.fixture(scope="module")
def operands():
    return both(lazy_ints(160, 1)), both(lazy_ints(160, 2)[::-1])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "pow7", "to_mont", "from_mont", "canonicalize"])
def test_ops_match_jax(operands, op):
    """160 elements take the torch limb path, the first 40 the host-int
    path; both equal the JAX package's values."""
    (a, ja), (b, jb) = operands
    assert 40 <= fr.SMALL < 160
    f, jf = getattr(fr, op), jax.jit(getattr(jfr, op))
    if op in ("add", "sub", "mul"):
        want, full, small = jf(ja, jb), f(a, b), f(a[:, :40], b[:, :40])
    else:
        want, full, small = jf(ja), f(a), f(a[:, :40])
    want = jfr.to_ints(want)
    assert fr.to_ints(full) == want
    assert fr.to_ints(small) == want[:40]
