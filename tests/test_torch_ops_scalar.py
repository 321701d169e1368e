"""The gruen round's scalar stage (K.gruen_round_scalar's plain twin)
against the JAX package's unfused stage, the verifier's evaluation and the
device Horner against the JAX package's, and the wrappers' checks of their
inputs.

    python -m pytest tests/test_torch_ops_scalar.py -q -p no:cacheprovider
"""

import jax
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.hashes import mimc as jmimc
from gkr_mimc_tpu.poly import lagrange as jlag
from gkr_mimc_tpu.poly import multilin as jml
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.poly import lagrange as lag
from gkr_mimc_tpu_torch.poly import multilin as ml
from torch_common import jvals, jx, rand_lazy, vals


def test_evaluate_and_horner_match_jax():
    """The verifier's fold-kernel evaluation and the device Horner."""
    rng = np.random.default_rng(8)
    table, coords = rand_lazy(rng, 8), rand_lazy(rng, 3).T.contiguous()  # (8, 8), (3, 8)
    coeffs, x = rand_lazy(rng, 3), rand_lazy(rng, 1)[:, 0]
    want_eval = jax.jit(jml.evaluate)(jx(table), jx(coords.T.contiguous()).T)
    want_horner = jax.jit(jlag.eval_univariate_device)(jx(coeffs), jx(x))
    assert fr.to_ints(ml.evaluate(table, coords)) == jfr.to_ints(want_eval)
    assert fr.to_ints(lag.eval_univariate_device(coeffs, x)) == jfr.to_ints(want_horner)


@jax.jit
def _jax_gruen_unfused(qc, qk, ck):
    """The JAX package's unfused round stage (GKR_GRUEN_FUSE=0), which the
    fused TPU kernel was held equal to: combine, transcript hash, eq1."""
    p = jsp._gruen_combine(qc, qk, ck)
    r = jmimc.mimc_hash_device(p)
    return p, r, jfr.mul(ck, jsp._eq1_at(qk, r))


@pytest.fixture(scope="module")
def gruen_round_case():
    """Four lanes of lazy inputs and the JAX stage on all four in one
    program; the cases take lane 0 (G = 1) and lanes 1..3 (G = 3)."""
    rng = np.random.default_rng(9)
    qc, qk, ck = rand_lazy(rng, 8, 4), rand_lazy(rng, 4), rand_lazy(rng, 4)
    return (qc, qk, ck), _jax_gruen_unfused(jx(qc), jx(qk), jx(ck))


@pytest.mark.parametrize("lanes", [slice(0, 1), slice(1, 4)], ids=["g1", "g3"])
def test_gruen_round_scalar_matches_jax_unfused(gruen_round_case, lanes):
    (qc, qk, ck), want = gruen_round_case
    qc, qk, ck = qc[..., lanes].contiguous(), qk[:, lanes].contiguous(), ck[:, lanes].contiguous()
    g = qk.shape[1]
    one = fr.one((g,))
    alpha, beta = fr.sub(one, qk), fr.sub(fr.add(qk, qk), one)
    p, r, ck2 = K.gruen_round_scalar(qc, alpha, beta, ck, qk)
    assert (p.shape, r.shape, ck2.shape) == ((L, 9, g), (L, g), (L, g))
    for got, w in zip((p, r, ck2), want):
        assert vals(got) == jvals(w[..., lanes])
    assert torch.equal(r, fr.canonicalize(r))


def test_wrappers_reject_bad_shapes():
    rng = np.random.default_rng(6)
    with pytest.raises(ValueError):
        K.fold([rand_lazy(rng, 6)], rand_lazy(rng, 1))  # not a power of two
    with pytest.raises(ValueError):
        K.fold([rand_lazy(rng, 8), rand_lazy(rng, 4)], rand_lazy(rng, 1))  # unequal tables
    with pytest.raises(ValueError):
        K.gruen_acc(rand_lazy(rng, 8), rand_lazy(rng, 8), rand_lazy(rng, 8), rand_lazy(rng, 1))
    with pytest.raises(TypeError):
        K.suffix_step(rand_lazy(rng, 4).to(torch.int64), rand_lazy(rng, 1))
    with pytest.raises(ValueError):  # 2 lanes of sums, 3 lanes of scalars
        K.gruen_round_scalar(rand_lazy(rng, 8, 2), *(rand_lazy(rng, 3) for _ in range(4)))
    with pytest.raises(ValueError):
        K.gruen_round_scalar(rand_lazy(rng, 8, 2), *(rand_lazy(rng, 2) for _ in range(3)), rand_lazy(rng, 2).T)
    with pytest.raises(ValueError):  # the cipher gate's round has 9 evaluations
        K.cipher_partial_evals(*(rand_lazy(rng, 8) for _ in range(3)), rand_lazy(rng, 1), 1, 8, False)
    with pytest.raises(ValueError):  # eq and x of different sizes
        K.identity_partial_evals(rand_lazy(rng, 8), rand_lazy(rng, 4), 1, 3, True)
    with pytest.raises(ValueError):  # 2 groups of tables, 1 group of ark
        K.cipher_coeff_acc(*(rand_lazy(rng, 8) for _ in range(3)), rand_lazy(rng, 1), 2)
    with pytest.raises(ValueError):
        K.mul_scalar(rand_lazy(rng, 8), rand_lazy(rng, 2))
    with pytest.raises(ValueError):  # a batch that is not one (8, N) table
        K.pow7(rand_lazy(rng, 2, 4))
    with pytest.raises(ValueError):  # a strided view
        K.pow7(rand_lazy(rng, 4, 2)[:, :, 0])
    with pytest.raises(ValueError):  # ark of two elements
        K.cipher_layer(rand_lazy(rng, 4), rand_lazy(rng, 4), rand_lazy(rng, 2))
    with pytest.raises(ValueError):  # l and r of different sizes
        K.cipher_layer(rand_lazy(rng, 4), rand_lazy(rng, 8), rand_lazy(rng, 1)[:, 0].contiguous())
