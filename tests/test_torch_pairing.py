"""The port's pairing layer against the JAX package's, exactly: the Fp2
and Fp12 towers, G2, the optimal-ate pairing and pairing_check
(gkr_mimc_tpu_torch.gadget.{tower,bn254_g2,pairing}), the native G2 MSM,
fixed-base batch and add and computeH (gkr_mimc_tpu_torch.native) against
the pure-Python ``*_plain`` versions and the JAX package's runtime, and the
Groth16 entry points raising, with no fallback, when the native runtime
cannot build. Only host functions run.

    python -m pytest tests/test_torch_pairing.py -q -p no:cacheprovider
"""

import random

import numpy as np
import pytest

from gkr_mimc_tpu import native as jnative
from gkr_mimc_tpu.gadget import bn254_g2 as jg2
from gkr_mimc_tpu.gadget import groth16 as jgroth16
from gkr_mimc_tpu.gadget import pairing as jpairing
from gkr_mimc_tpu.gadget import tower as jtower
from gkr_mimc_tpu_torch import native
from gkr_mimc_tpu_torch.gadget import bn254_g1 as g1
from gkr_mimc_tpu_torch.gadget import bn254_g2 as g2
from gkr_mimc_tpu_torch.gadget import groth16 as G
from gkr_mimc_tpu_torch.gadget import pairing as pr
from gkr_mimc_tpu_torch.gadget import tower as tw
from gkr_mimc_tpu_torch.snark.r1cs import RecordingCS

GEN1, GEN2 = g1.to_jac(g1.GEN), g2.to_jac(g2.GEN)


def test_towers_match_jax():
    """Fp2 and Fp12 arithmetic, inversion, powers and the Fp2 embedding."""
    rng = random.Random(0)
    assert (tw.P, tw.FP12_ONE, tw.FP2_ONE) == (jtower.P, jtower.FP12_ONE, jtower.FP2_ONE)
    for _ in range(4):
        a = tw.fp2(rng.randrange(tw.P), rng.randrange(tw.P))
        b = tw.fp2(rng.randrange(tw.P), rng.randrange(tw.P))
        for name in ("fp2_add", "fp2_sub", "fp2_mul"):
            assert getattr(tw, name)(a, b) == getattr(jtower, name)(a, b), name
        for name in ("fp2_neg", "fp2_sqr", "fp2_conj", "fp2_inv", "fp12_from_fp2"):
            assert getattr(tw, name)(a) == getattr(jtower, name)(a), name
        assert tw.fp2_mul(a, tw.fp2_inv(a)) == tw.FP2_ONE
        assert tw.fp2_pow(a, 12345) == jtower.fp2_pow(a, 12345)
    x = tw.fp12([rng.randrange(tw.P) for _ in range(12)])
    y = tw.fp12([rng.randrange(tw.P) for _ in range(12)])
    for name in ("fp12_add", "fp12_sub", "fp12_mul"):
        assert getattr(tw, name)(x, y) == getattr(jtower, name)(x, y), name
    for name in ("fp12_neg", "fp12_sqr", "fp12_inv"):
        assert getattr(tw, name)(x) == getattr(jtower, name)(x), name
    assert tw.fp12_mul(x, tw.fp12_inv(x)) == tw.FP12_ONE
    assert tw.fp12_pow(x, 2**70 + 3) == jtower.fp12_pow(x, 2**70 + 3)


def test_g2_matches_jax():
    """Add, double, negation and scalar multiplication, the same Jacobian
    coordinates as the JAX package's; the order r; the curve equation."""
    assert (g2.P, g2.R, g2.B2, g2.GEN, g2.INF) == (jg2.P, jg2.R, jg2.B2, jg2.GEN, jg2.INF)
    rng = random.Random(1)
    pts = [g2.scalar_mul(GEN2, rng.randrange(1, g2.R)) for _ in range(4)] + [g2.INF]
    for p, q in zip(pts, pts[1:] + pts[:1]):
        assert g2.add(p, q) == jg2.add(p, q)
        assert g2.double(p) == jg2.double(p)
        assert g2.neg(p) == jg2.neg(p)
        assert g2.on_curve(p) and g2.is_inf(g2.add(p, g2.neg(p)))
    for k in (0, 1, 6, g2.R - 1, g2.R, rng.randrange(1 << 256)):
        assert g2.scalar_mul(pts[0], k) == jg2.scalar_mul(pts[0], k)
    assert g2.is_inf(g2.scalar_mul(GEN2, g2.R))
    assert g2.to_affine(g2.add(g2.scalar_mul(GEN2, 5), GEN2)) == g2.to_affine(g2.scalar_mul(GEN2, 6))


def test_pairing_matches_jax_and_is_bilinear():
    """e(6 G1, 11 G2) is the JAX package's Fp12 value, of order r, and
    equals e(G1, 66 G2) and e(G1, G2)^66; the identity pairs to 1."""
    p, q = g1.scalar_mul(GEN1, 6), g2.scalar_mul(GEN2, 11)
    e = pr.pairing(p, q)
    assert e == jpairing.pairing(p, q) != tw.FP12_ONE
    assert tw.fp12_pow(e, g2.R) == tw.FP12_ONE
    assert e == pr.pairing(GEN1, g2.scalar_mul(GEN2, 66)) == tw.fp12_pow(pr.pairing(GEN1, GEN2), 66)
    assert pr.pairing(g1.INF, q) == pr.pairing(p, g2.INF) == tw.FP12_ONE
    assert pr.miller_loop(g2.to_affine(q), g1.to_affine(p)) == jpairing.miller_loop(jg2.to_affine(q), g1.to_affine(p))


def test_pairing_check():
    """e(9 P, Q) e(-P, 9 Q) == 1 holds; with 10 Q it does not; an identity
    pair is skipped."""
    a = 9
    good = [(g1.scalar_mul(GEN1, a), GEN2), (g1.neg(GEN1), g2.scalar_mul(GEN2, a)), (g1.INF, GEN2)]
    bad = [(g1.scalar_mul(GEN1, a), GEN2), (g1.neg(GEN1), g2.scalar_mul(GEN2, a + 1))]
    assert pr.pairing_check(good) and jpairing.pairing_check(good)
    assert not pr.pairing_check(bad) and not jpairing.pairing_check(bad)


def test_native_g2_and_adds_match_plain_and_jax():
    """The G2 fixed-base batch and MSM against scalar_mul loops (the
    ``*_plain`` versions) and the JAX package's runtime (the same
    Jacobian coordinates); the two bound add entries against the group
    laws."""
    rng = random.Random(2)
    scalars = [0, 1, 2, 3, g2.R - 1, 2**163 + 12345, rng.randrange(1 << 256)]
    batch = native.batch_scalar_mul_g2(GEN2, scalars)
    assert batch == jnative.batch_scalar_mul_g2(GEN2, scalars)
    assert [g2.to_affine(x) for x in batch] == [g2.to_affine(x) for x in G.g2_batch_plain(scalars)]
    assert [g1.to_affine(x) for x in G._g1_batch(scalars)] == [g1.to_affine(x) for x in G.g1_batch_plain(scalars)]
    ms = [rng.randrange(1 << 256) for _ in batch]
    got = native.msm_g2(batch, ms)
    assert got == jnative.msm_g2(batch, ms)
    assert g2.to_affine(got) == g2.to_affine(G.msm_g2_plain(batch, ms))
    pts1 = G.g1_batch_plain(scalars)
    assert g1.to_affine(native.msm(pts1, ms)) == g1.to_affine(G.msm_plain(pts1, ms))
    assert g2.is_inf(native.msm_g2([], []))

    lib = native.library()
    for p, q in zip(batch, batch[1:] + batch[:1]):
        out = np.zeros((1, 24), dtype=np.uint64)
        lib.gkr_g2_add(native._u64p(native._pack_points_g2([p])), native._u64p(native._pack_points_g2([q])),
                       native._u64p(out))
        assert g2.to_affine(native._unpack_points_g2(out)[0]) == g2.to_affine(g2.add(p, q))
    for p, q in zip(pts1, pts1[1:] + pts1[:1]):
        out = np.zeros((1, 12), dtype=np.uint64)
        lib.gkr_g1_add(native._u64p(native._pack_points([p])), native._u64p(native._pack_points([q])),
                       native._u64p(out))
        assert g1.to_affine(native._unpack_points(out)[0]) == g1.to_affine(g1.add(p, q))


def test_native_compute_h():
    """computeH: the native NTT equals the plain NTT and the JAX package's,
    and A B - C = h (X^d - 1) as polynomials (A, B, C interpolated by a
    slow Lagrange oracle)."""
    R = g1.R
    rng = random.Random(4)
    n, d = 6, 8
    a = [rng.randrange(R) for _ in range(n)]
    b = [rng.randrange(R) for _ in range(n)]
    c = [x * y % R for x, y in zip(a, b)]
    h = G.compute_h(a, b, c, d)
    assert h == G.compute_h_plain(a, b, c, d) == jgroth16.compute_h(a, b, c, d)
    assert len(h) == d and h[-1] == 0
    omega = pow(5, (R - 1) // d, R)
    dinv = pow(d, R - 2, R)

    def interp(vals):
        vals = vals + [0] * (d - len(vals))
        return [dinv * sum(vals[i] * pow(omega, (-i * j) % d, R) for i in range(d)) % R for j in range(d)]

    A, B, C = interp(a), interp(b), interp(c)
    lhs = [0] * (2 * d - 1)
    for i, x in enumerate(A):
        for j, y in enumerate(B):
            lhs[i + j] = (lhs[i + j] + x * y) % R
    for i in range(d):
        lhs[i] = (lhs[i] - C[i]) % R
    rhs = [0] * (2 * d)
    for i, hi in enumerate(h):
        rhs[i + d] = (rhs[i + d] + hi) % R
        rhs[i] = (rhs[i] - hi) % R
    assert lhs + [0] == rhs
    with pytest.raises(ValueError):
        native.compute_h(a, b, c, 6)


def test_groth16_raises_without_native(tmp_path, monkeypatch):
    """With a runtime source that does not compile, setup, prove, verify
    and compute_h raise NativeBuildError: no path drops to the plain
    versions."""
    cs = RecordingCS()
    cs.public_input(5)
    x = cs.witness(3)
    cs.assert_is_equal(cs.mul(x, x), cs.constant(9))
    r1cs = cs.compile()
    partition = ([], [], [1], list(range(2, r1cs.n_wires)))
    pk, vk = G.setup(r1cs, partition, seed=b"before")
    proof = G.prove(r1cs, pk, g1.INF, 5, seed=b"before")
    bad = tmp_path / "bn254.cpp"
    bad.write_text("this is not C++\n")
    native.library.cache_clear()
    monkeypatch.setattr(native, "SOURCE", bad)
    try:
        for call in (lambda: G.setup(r1cs, partition, seed=b"s"), lambda: G.prove(r1cs, pk, g1.INF, 5, seed=b"s"),
                     lambda: G.verify(proof, vk, [5]), lambda: G.compute_h([1], [1], [1], 2)):
            with pytest.raises(native.NativeBuildError):
                call()
    finally:
        monkeypatch.undo()
        native.library.cache_clear()
    assert native.available()
