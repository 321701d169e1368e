"""Each elementwise kernel's plain twin (gkr_mimc_tpu_torch.ops.kernels)
against the JAX function the kernel replaces: the witness, the fold, the
eq-table multiply, the suffix chain and the multi-claim eq build.

On the CPU a wrapper takes its plain twin, so these cases hold the twins
(the kernels' references on the card) against gkr_mimc_tpu, exactly, on
canonical values. tests/test_torch_cuda.py holds the CUDA kernels against
the twins on the card. The round sums are in tests/test_torch_ops_rounds.py,
the rounds' scalar stage, the verifier's evaluation and the wrappers'
checks in tests/test_torch_ops_scalar.py (seven cases or fewer a file, as
tests/test_torch_models.py explains).

    python -m pytest tests/test_torch_ops*.py -q -p no:cacheprovider
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.models.mimc import _assign_fused_jit
from gkr_mimc_tpu.poly import multilin as jml
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.hashes.ark import arks_mont
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.sumcheck import prover as sp
from torch_common import jvals, jx, rand_lazy, vals

_jfold = jax.jit(jml.fold)


def test_witness_matches_jax():
    rng = np.random.default_rng(1)
    block, state = rand_lazy(rng, 8), rand_lazy(rng, 8)
    got = K.mimc_witness(block, state, arks_mont(91))
    want = _assign_fused_jit(jx(block), jx(state))
    assert got.shape == (91, L, 8)
    assert vals(got.permute(1, 0, 2).contiguous()) == jvals(jnp.moveaxis(want, 0, 1))


@pytest.mark.parametrize("g", [1, 2])
def test_fold_matches_jax(g):
    rng = np.random.default_rng(2)
    n = 16
    tables = [rand_lazy(rng, g * n) for _ in range(2)]
    r = rand_lazy(rng, g)
    got = K.fold(tables, r)
    for t, out in zip(tables, got):
        for gi in range(g):
            want = _jfold(jx(t[:, gi * n : (gi + 1) * n].contiguous()), jx(r[:, gi].contiguous()))
            assert vals(out[:, gi * n // 2 : (gi + 1) * n // 2].contiguous()) == jvals(want)


def test_fold_three_tables_matches_jax():
    """nt = 3, the fold of [eq, x0, x1] in the direct and evaluation-form
    round paths, at two groups."""
    rng = np.random.default_rng(12)
    g, n = 2, 16
    tables = [rand_lazy(rng, g * n) for _ in range(3)]
    r = rand_lazy(rng, g)
    got = K.fold(tables, r)
    for t, out in zip(tables, got):
        for gi in range(g):
            want = _jfold(jx(t[:, gi * n : (gi + 1) * n].contiguous()), jx(r[:, gi].contiguous()))
            assert vals(out[:, gi * n // 2 : (gi + 1) * n // 2].contiguous()) == jvals(want)


def test_mul_scalar_matches_jax():
    rng = np.random.default_rng(13)
    x, r = rand_lazy(rng, 16), rand_lazy(rng, 1)[:, 0].contiguous()
    got = K.mul_scalar(x, r)
    assert got.shape == (L, 16)
    assert vals(got) == jvals(jax.jit(jfr.mul)(jx(x), jx(r)[:, None]))


def test_suffix_step_matches_jax():
    """The port's suffix chain (suffix_step per variable) against the
    portable doubling branch of JAX _suffix_tables."""
    rng = np.random.default_rng(3)
    bn, n_head = 5, 3
    qrows = rand_lazy(rng, bn).T.contiguous()  # (bn, 8)
    got = sp._suffix_tables(qrows.unsqueeze(-1).contiguous(), n_head)  # one group: (bn, 8, 1)
    want = jax.jit(jsp._suffix_tables, static_argnums=1)(jx(qrows.T.contiguous()).T, n_head)
    assert [vals(x) for x in got] == [jvals(x) for x in want]


def test_multi_eq_matches_jax_make_eq():
    """J = 10 claims at bn = 4 with 2 low bits: the hi/lo split runs."""
    rng = np.random.default_rng(4)
    j, bn = 10, 4
    qprimes = rand_lazy(rng, j, bn).permute(1, 2, 0).contiguous()  # (J, bn, 8)
    claims = rand_lazy(rng, j)
    got = sp._make_eq(qprimes, claims, lo_bits=2)
    want = jsp._make_eq_jit(jnp.moveaxis(jx(qprimes.permute(2, 0, 1).contiguous()), 0, -1), jx(claims))
    assert vals(got) == jvals(want)
