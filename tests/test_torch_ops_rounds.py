"""The round-sum kernels' plain twins (gkr_mimc_tpu_torch.ops.kernels:
gruen_acc, identity_acc, cipher_coeff_acc and the two partial
evaluations) against the JAX package's round sums, exactly, on canonical
values, at two groups. tests/test_torch_cuda.py holds the CUDA kernels
against the twins on the card.

    python -m pytest tests/test_torch_ops_rounds.py -q -p no:cacheprovider
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.ops import kernels as K
from torch_common import jvals, jx, rand_lazy, vals


def _jax_round_sums(s, x0, x1, ark):
    """Q_m = C(7,m) sum_y S[y] u^(7-m) v^m and the identity P0..P2 (on
    (eq, x) = (x0, x1)), from the JAX package's field ops (products
    stacked so the traced program stays small)."""
    h = x0.shape[-1] // 2
    a = ark[:, None]
    u = jfr.add(jfr.add(x0[:, :h], x1[:, :h]), a)
    v = jfr.sub(jfr.add(jfr.add(x0[:, h:], x1[:, h:]), a), u)
    uv = jnp.stack([u, v], axis=1)  # (16, 2, h)
    pows = [jfr.one((2, h))]
    for _ in range(7):
        pows.append(jfr.mul(pows[-1], uv))
    raws = jfr.mul(jnp.stack([pows[7 - m][:, 0] for m in range(8)], 1), jnp.stack([pows[m][:, 1] for m in range(8)], 1))
    binom = jfr.from_ints_mont([math.comb(7, m) for m in range(8)])
    q = jfr.mul(jfr.reduce_sum(jfr.mul(s[:, None], raws), 1), binom)
    e, xu = x0[:, :h], x1[:, :h]
    de, xv = jfr.sub(x0[:, h:], e), jfr.sub(x1[:, h:], xu)
    prods = jfr.mul(jnp.stack([e, e, de, de], 1), jnp.stack([xu, xv, xu, xv], 1))
    terms = jnp.stack([prods[:, 0], jfr.add(prods[:, 1], prods[:, 2]), prods[:, 3]], 1)
    return q, jfr.reduce_sum(terms, 1)


_jax_round_sums_jit = jax.jit(_jax_round_sums)


@pytest.fixture(scope="module")
def round_case():
    rng = np.random.default_rng(5)
    g, n = 2, 16
    s, x0, x1, ark = rand_lazy(rng, g * n // 2), rand_lazy(rng, g * n), rand_lazy(rng, g * n), rand_lazy(rng, g)
    wants = [
        _jax_round_sums_jit(*(jx(t[:, gi * m : (gi + 1) * m].contiguous()) for t, m in ((s, n // 2), (x0, n), (x1, n))), jx(ark)[:, gi])
        for gi in range(g)
    ]
    return (s, x0, x1, ark, g), wants


def test_gruen_acc_matches_jax(round_case):
    (s, x0, x1, ark, g), wants = round_case
    got = K.gruen_acc(s, x0, x1, ark)  # (8, 8, G)
    assert got.shape == (L, 8, g)
    assert all(v < jfr.P for v in fr.limb_values(got.reshape(L, -1)))  # Q canonical
    for gi, (q, _) in enumerate(wants):
        assert vals(got[:, :, gi].contiguous()) == jvals(q)


def test_identity_acc_matches_jax(round_case):
    (_, x0, x1, _, g), wants = round_case
    got = K.identity_acc(x0, x1, g)  # (8, 3, G)
    assert got.shape == (L, 3, g)
    assert all(v < jfr.P for v in fr.limb_values(got.reshape(L, -1)))  # canonical
    for gi, (_, p) in enumerate(wants):
        assert vals(got[:, :, gi].contiguous()) == jvals(p)


def test_cipher_coeff_acc_matches_jax(round_case):
    """P_m = C(7,m) <e, raw_m> + C(7,m-1) <de, raw_(m-1)>: the JAX round
    sums Q_m of ``_jax_round_sums`` weighted by e and by de (the program
    of ``round_case``, same shapes), added on host ints. The eq tables are
    random: a kernel that dropped the de stream would still match where eq
    is constant along the round variable."""
    (_, x0, x1, ark, g), _ = round_case
    n = x0.shape[-1] // g
    eq = rand_lazy(np.random.default_rng(14), g * n)
    got = K.cipher_coeff_acc(eq, x0, x1, ark, g)
    assert got.shape == (L, 9, g)
    for gi in range(g):
        e, top = eq[:, gi * n : gi * n + n // 2].contiguous(), eq[:, gi * n + n // 2 : (gi + 1) * n].contiguous()
        xs = [jx(t[:, gi * n : (gi + 1) * n].contiguous()) for t in (x0, x1)]
        qe, _ = _jax_round_sums_jit(jx(e), *xs, jx(ark)[:, gi])
        qde, _ = _jax_round_sums_jit(jx(fr.sub(top, e)), *xs, jx(ark)[:, gi])
        qe, qde = jvals(qe), jvals(qde)
        want = [(a + b) % jfr.P for a, b in zip(qe + [0], [0] + qde)]
        assert vals(got[:, :, gi].contiguous()) == want


@pytest.fixture(scope="module")
def partial_evals_case():
    """Two groups of n = 16 and the JAX package's portable round sums
    (sumcheck.prover._partial_evals, which the TPU kernels were held equal
    to) of each lane at t = 0.. (one program a gate: the cipher gate's takes
    ~10 s to compile here), whose columns 1.. are the claim-trick sums,
    computed by the same adds."""
    rng = np.random.default_rng(15)
    g, n = 2, 16
    eq, x0, x1, ark = rand_lazy(rng, g * n), rand_lazy(rng, g * n), rand_lazy(rng, g * n), rand_lazy(rng, g)
    cipher, ident = jgates.CipherGate(0), jgates.IdentityGate()
    pe = jax.jit(jsp._partial_evals, static_argnums=(0, 5))
    want = {}
    for gi in range(g):
        e, a0, a1 = (jx(t[:, gi * n : (gi + 1) * n].contiguous()) for t in (eq, x0, x1))
        full = pe(cipher, (jx(ark)[:, gi],), e, [a0, a1], None, False)
        want["cipher", gi, False], want["cipher", gi, True] = full, full[:, 1:]
        full = pe(ident, (), e, [a0], None, False)
        want["identity", gi, False], want["identity", gi, True] = full, full[:, 1:]
    return (eq, x0, x1, ark, g), want


@pytest.mark.parametrize("skip_t0", [False, True], ids=["t0", "skip_t0"])
def test_partial_evals_match_jax(partial_evals_case, skip_t0):
    (eq, x0, x1, ark, g), want = partial_evals_case
    got = {
        "cipher": K.cipher_partial_evals(eq, x0, x1, ark, g, 9, skip_t0),
        "identity": K.identity_partial_evals(eq, x0, g, 3, skip_t0),
    }
    assert got["cipher"].shape == (L, 9 - skip_t0, g) and got["identity"].shape == (L, 3 - skip_t0, g)
    assert all(v < jfr.P for v in fr.limb_values(got["identity"].reshape(L, -1)))  # canonical
    for kind, out in got.items():
        for gi in range(g):
            assert vals(out[:, :, gi].contiguous()) == jvals(want[kind, gi, skip_t0])
