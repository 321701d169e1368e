"""The port's gadget host runtime against the JAX package: Keccak, the G1
group law and MSM, the initial randomness, the dummy setup, the io store,
the wire format's sizes and log2 (gkr_mimc_tpu_torch.gadget, .native,
.utils.common), exactly. Only host functions of the JAX package run, so
no JAX program is traced. The port's native runtime (native/bn254.cpp,
built with g++) and its pure-Python oracles both answer; the loader
raises, with no fallback, when it cannot build.

    python -m pytest tests/test_torch_gadget_host.py -q -p no:cacheprovider
"""

import random

import pytest

from gkr_mimc_tpu import native as jnative
from gkr_mimc_tpu.gadget import bn254_g1 as jg1
from gkr_mimc_tpu.gadget import io_store as jio
from gkr_mimc_tpu.gadget import keccak as jkeccak
from gkr_mimc_tpu.gadget import serialize as jser
from gkr_mimc_tpu.gadget import setup as jsetup
from gkr_mimc_tpu.models.mimc import mimc_circuit as jax_mimc_circuit
from gkr_mimc_tpu.utils import common as jcommon
from gkr_mimc_tpu_torch import native
from gkr_mimc_tpu_torch.gadget import bn254_g1 as g1
from gkr_mimc_tpu_torch.gadget import keccak
from gkr_mimc_tpu_torch.gadget.io_store import IoStore
from gkr_mimc_tpu_torch.gadget.serialize import bn_from_input_size, proof_size
from gkr_mimc_tpu_torch.gadget.setup import dummy_setup
from gkr_mimc_tpu_torch.models.mimc import mimc_circuit
from gkr_mimc_tpu_torch.utils import common

GEN = g1.to_jac(g1.GEN)


def _points(rng, n):
    return [g1.scalar_mul(GEN, rng.randrange(1, g1.R)) for _ in range(n)]


def test_keccak_matches_jax():
    """Known vectors of tests/test_gadget.py, then random lengths across
    the 136-byte rate: native and pure digests equal the JAX package's."""
    known = {
        b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
        b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    }
    for data, digest in known.items():
        assert keccak.keccak256(data).hex() == keccak._keccak256_py(data).hex() == digest
    rng = random.Random(7)
    for n in [1, 31, 64, 135, 136, 137, 271, 272, 300, 64 + 8] + [rng.randrange(600) for _ in range(6)]:
        data = bytes(rng.randrange(256) for _ in range(n))
        want = jkeccak.keccak256(data)
        assert keccak.keccak256(data) == want, n
        assert keccak._keccak256_py(data) == want, n


def test_g1_matches_jax():
    """Group law, scalar multiplication, MSM (native above 16 points,
    pure up to 16, as the JAX package splits them, so even the Jacobian
    coordinates agree) and the native fixed-base batch."""
    assert (g1.P, g1.R, g1.B, g1.GEN, g1.INF) == (jg1.P, jg1.R, jg1.B, jg1.GEN, jg1.INF)
    rng = random.Random(3)
    pts = _points(rng, 23) + [g1.INF]
    for p, q in zip(pts, pts[1:] + pts[:1]):
        assert g1.add(p, q) == jg1.add(p, q)
        assert g1.double(p) == jg1.double(p)
        assert g1.neg(p) == jg1.neg(p)
        assert g1.add(p, g1.neg(p))[2] == 0 and g1.on_curve(p)
    for k in [0, 1, 2, 5, g1.R - 1, g1.R, g1.R + 7, rng.randrange(1 << 256)]:
        assert g1.scalar_mul(pts[0], k) == jg1.scalar_mul(pts[0], k)
    assert g1.to_affine(g1.scalar_mul(GEN, 2)) == jg1.to_affine(jg1.scalar_mul(jg1.to_jac(jg1.GEN), 2))
    scalars = [rng.randrange(1 << 256) for _ in pts]
    for n in [0, 1, 6, 16, 17, 24]:
        got = g1.msm(pts[:n], scalars[:n])
        assert got == jg1.msm(pts[:n], scalars[:n]), n
        assert g1.to_affine(g1._msm_py(pts[:n], scalars[:n])) == g1.to_affine(got), n
    assert g1.to_affine(native.msm(pts[:6], scalars[:6])) == g1.to_affine(g1._msm_py(pts[:6], scalars[:6]))
    batch = native.batch_scalar_mul(GEN, scalars[:9])
    assert batch == jnative.batch_scalar_mul(jg1.to_jac(jg1.GEN), scalars[:9])
    assert [g1.to_affine(p) for p in batch] == [g1.to_affine(g1.scalar_mul(GEN, s)) for s in scalars[:9]]


def test_derive_randomness_matches_jax():
    """rho = Keccak(RawBytes(point)) mod r, the identity's flag byte
    included; the pure Keccak gives the same."""
    rng = random.Random(11)
    for p in [g1.INF, GEN] + _points(rng, 4):
        rho = g1.derive_randomness_from_point(p)
        assert g1.raw_bytes(p) == jg1.raw_bytes(p)
        assert rho == jg1.derive_randomness_from_point(p)
        assert rho == int.from_bytes(keccak._keccak256_py(g1.raw_bytes(p)), "big") % g1.R


def test_dummy_setup_matches_jax():
    got, want = dummy_setup(3, 9), jsetup.dummy_setup(3, 9)
    assert (got.pub_k_gkr, got.priv_k_gkr_sigma) == (want.pub_k_gkr, want.priv_k_gkr_sigma)
    assert (got.sigma, got.sigma_inv) == (want.sigma, want.sigma_inv)
    assert got.sigma * got.sigma_inv % g1.R == 1
    h = int.from_bytes(keccak._keccak256_py(b"gkr-mimc-tpu" + b"priv" + (4).to_bytes(8, "big")), "big") % g1.R
    assert g1.to_affine(got.priv_k_gkr_sigma[4]) == g1.to_affine(g1.scalar_mul(GEN, got.sigma * h))


def test_io_store_matches_jax():
    """Dumps (multiexp and prover orders), the public mask and the
    verifier's columns, on a mix of public and private entries."""
    got, want = IoStore(), jio.IoStore()
    vals = jcommon.random_fr_array(12)
    for i in range(4):
        for store in (got, want):
            store.push(vals[3 * i : 3 * i + 2], vals[3 * i + 2], public=i % 3 == 0)
    qprime = vals[:2]
    assert got.index == want.index == 4
    assert got.dump_for_multiexp() == want.dump_for_multiexp()
    assert got.dump_for_gkr_prover(qprime) == want.dump_for_gkr_prover(qprime)
    assert got.multiexp_public_mask() == want.multiexp_public_mask()
    assert got.inputs_for_verifier() == want.inputs_for_verifier()
    assert got.outputs_for_verifier() == want.outputs_for_verifier()
    with pytest.raises(ValueError):
        got.push([1], 2)
    with pytest.raises(ValueError):
        got.dump_for_gkr_prover(vals[:3])


def test_sizes_and_log2_match_jax():
    c, jc = mimc_circuit(), jax_mimc_circuit()
    for bn in (2, 3):
        assert proof_size(c, bn) == jser.proof_size(jc, bn)
        n_inputs = (1 << bn) * (c.input_arity() + 1) + bn
        assert bn_from_input_size(c, n_inputs) == jser.bn_from_input_size(jc, n_inputs) == bn
    with pytest.raises(ValueError):
        bn_from_input_size(c, 13)
    for x in list(range(70)) + [(1 << 20) - 1, 1 << 20, (1 << 20) + 1]:
        assert common.log2_floor(x) == jcommon.log2_floor(x)
        assert common.log2_ceil(x) == jcommon.log2_ceil(x)


def test_native_loader_raises_without_fallback(tmp_path, monkeypatch):
    """A source that does not compile: the loader raises with g++'s output,
    and so do Keccak, an MSM of more than 16 points and the setup; the
    pure oracles still answer by name."""
    bad = tmp_path / "bn254.cpp"
    bad.write_text("this is not C++\n")
    pts = _points(random.Random(5), 17)
    native.library.cache_clear()
    monkeypatch.setattr(native, "SOURCE", bad)
    try:
        assert not native.available()
        with pytest.raises(native.NativeBuildError, match="error"):
            native.library()
        for call in (lambda: keccak.keccak256(b"abc"), lambda: g1.msm(pts, list(range(17))),
                     lambda: dummy_setup(1, 1)):
            with pytest.raises(native.NativeBuildError):
                call()
        monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
        with pytest.raises(native.NativeBuildError, match="not found"):
            native.library()
        assert keccak._keccak256_py(b"abc").hex().startswith("4e03657a")
    finally:
        monkeypatch.undo()
        native.library.cache_clear()
    assert native.available()
