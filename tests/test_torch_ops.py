"""Each kernel's plain twin (gkr_mimc_tpu_torch.ops.kernels) against the
JAX function the kernel replaces.

On the CPU a wrapper takes its plain twin, so these cases hold the twins
(the kernels' references on the card) against gkr_mimc_tpu, exactly, on
canonical values. tests/test_torch_cuda.py holds the CUDA kernels against
the twins on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.hashes import mimc as jmimc
from gkr_mimc_tpu.models.mimc import _assign_fused_jit
from gkr_mimc_tpu.poly import lagrange as jlag
from gkr_mimc_tpu.poly import multilin as jml
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L
from gkr_mimc_tpu_torch.hashes.ark import arks_mont
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.poly import lagrange as lag
from gkr_mimc_tpu_torch.poly import multilin as ml
from gkr_mimc_tpu_torch.sumcheck import prover as sp
from gkr_mimc_tpu_torch.utils.convert import to_jax_rows

TWO_P_TOP = 0x60C89CE5  # top 32-bit limb of 2p


def rand_lazy(rng, *shape, device="cpu"):
    """(8, *shape) field elements below 2p from a numpy generator."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + shape, dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)


def jx(t):
    return jnp.asarray(to_jax_rows(t))


def vals(t):
    """Canonical values of a port tensor (limb axis first)."""
    return fr.to_ints(t)


def jvals(a):
    return jfr.to_ints(a)


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


def test_evaluate_and_horner_match_jax():
    """The verifier's fold-kernel evaluation and the device Horner."""
    rng = np.random.default_rng(8)
    table, coords = rand_lazy(rng, 8), rand_lazy(rng, 3).T.contiguous()  # (8, 8), (3, 8)
    coeffs, x = rand_lazy(rng, 3), rand_lazy(rng, 1)[:, 0]
    want_eval = jax.jit(jml.evaluate)(jx(table), jx(coords.T.contiguous()).T)
    want_horner = jax.jit(jlag.eval_univariate_device)(jx(coeffs), jx(x))
    assert fr.to_ints(ml.evaluate(table, coords)) == jfr.to_ints(want_eval)
    assert fr.to_ints(lag.eval_univariate_device(coeffs, x)) == jfr.to_ints(want_horner)


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
    for kind, out in got.items():
        for gi in range(g):
            assert vals(out[:, :, gi].contiguous()) == jvals(want[kind, gi, skip_t0])


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
