"""The tail rounds of a cipher or identity layer in one call,
``ops.kernels.tail_rounds``, against the JAX package's tail program.

On the CPU the wrapper takes its plain twin, ``tail_rounds_plain`` (the
loop of the generic round over the tail). It must give the coefficients,
challenges and final values of the reference's masked tail program
(``gkr_mimc_tpu.sumcheck.prover._tail_jit_keep``) on the same tables,
made from a numpy seed: canonical values, tolerance 0. Then the sumcheck
prover, which sends every cipher and identity tail through one
``tail_rounds`` call, still reproduces the golden transcripts.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu.circuits import gates as jgates
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.fields.bn254 import L, P
from gkr_mimc_tpu_torch.ops import kernels as K
from gkr_mimc_tpu_torch.sumcheck import prover, testing
from gkr_mimc_tpu_torch.utils.convert import from_jax_rows, rows_to_ints, to_jax_rows

GOLDEN = Path(__file__).resolve().parent / "golden" / "transcripts.json"
ARK = 145646
EDGES = [0, P - 1, P, 2 * P - 1]  # held integers at the edges of the lazy range [0, 2p)


def _table(values, g):
    """(8, G, m) limbs holding the given integers (< 2p) as they are."""
    raw = b"".join(int(v).to_bytes(4 * L, "little") for v in values)
    limbs = np.frombuffer(raw, dtype="<u4").reshape(len(values), L).T.copy()
    return torch.from_numpy(limbs.view(np.int32)).reshape(L, g, -1)


def _random(rng, g, m):
    limbs = rng.integers(0, 1 << 32, size=(L, g, m), dtype=np.uint64)
    limbs[L - 1] %= 0x60C89CE5  # top limb of 2p: values below 2p
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32))


def _canon(t: torch.Tensor, limb_axis: int) -> np.ndarray:
    return fr.canonicalize(t.movedim(limb_axis, 0).contiguous()).numpy()


def _check_against_jax(eq, xs, ark):
    """tail_rounds on (8, G, m) tables against _tail_jit_keep on the same
    integers (a single-instance (16, m) program for G = 1)."""
    g = eq.shape[1]
    coeffs, rs, finals = K.tail_rounds(eq, xs, None if ark is None else fr.from_int_mont(ARK))
    jgate = jgates.CipherGate(ARK) if ark is not None else jgates.IdentityGate()

    def jax_rows(t):
        return jnp.asarray(to_jax_rows(t[:, 0] if g == 1 else t))

    jc, jr, jf = jsp._tail_jit_keep(jgate, jgate.params(), jax_rows(eq), tuple(map(jax_rows, xs)))

    def from_jax(a, limb_axis):  # -> limbs first, G axis last, canonical
        t = from_jax_rows(np.moveaxis(np.asarray(a), limb_axis, 0))
        return fr.canonicalize(t.unsqueeze(-1) if g == 1 else t).numpy()

    s = eq.shape[-1].bit_length() - 1
    assert coeffs.shape == (s, L, K.CIPHER_EVALS if ark is not None else K.IDENTITY_EVALS, g)
    np.testing.assert_array_equal(_canon(coeffs, 1), from_jax(jc, 1))
    np.testing.assert_array_equal(_canon(rs, 1), from_jax(jr, 1))
    np.testing.assert_array_equal(_canon(finals, 1), from_jax(jf, -1))


def test_cipher_tail_matches_jax():
    rng = np.random.default_rng(11)
    _check_against_jax(_random(rng, 1, 1 << 4), [_random(rng, 1, 1 << 4) for _ in range(2)], ARK)


def test_identity_tail_matches_jax_in_two_lanes():
    rng = np.random.default_rng(12)
    _check_against_jax(_random(rng, 2, 1 << 3), [_random(rng, 2, 1 << 3)], None)


def test_single_round_on_lazy_edges():
    """m = 2, one round, G = 4 lanes: every table entry one of 0, p - 1, p
    and 2p - 1, each table in another order."""
    vals = [EDGES[i % 4] for i in range(8)]
    eq, x0, x1 = _table(vals, 4), _table(vals[::-1], 4), _table(vals[2:] + vals[:2], 4)
    _check_against_jax(eq, [x0, x1], ARK)


@pytest.mark.parametrize("tail_bits", [8, 1])
def test_prove_reproduces_goldens_through_tail_rounds(monkeypatch, tail_bits):
    """Cipher bn = 1..3, each tail in one tail_rounds call (the gate never
    through cipher_layer), and the 10-claim layer at bn = 3 (its fixture
    gives the identity gate two tables, so it keeps the generic rounds)
    equal their golden transcripts."""
    golden = json.loads(GOLDEN.read_text())["sumcheck"]
    calls = []
    monkeypatch.setattr(K, "tail_rounds", lambda *args, _f=K.tail_rounds: calls.append(1) or _f(*args))
    monkeypatch.setattr(K, "cipher_layer", lambda *args: pytest.fail("cipher_layer called in a tail"))
    cases = [(f"cipher_bn{bn}", testing.initialize_cipher_gate_instance(bn, "cpu")) for bn in (1, 2, 3)]
    cases.append(("multi_bn3_j10", testing.initialize_multi_instance(3, 10, "cpu")))
    for name, (xs, claims, qps, gate) in cases:
        scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"),
                           gate, tail_bits)
        want = golden[name]
        assert _strs(rows_to_ints(scp.coeffs)) == want["coeffs"], name
        assert _strs(rows_to_ints(scp.challenges)) == want["challenges"], name
        assert _strs(rows_to_ints(scp.final_claims)) == want["final_claims"], name
    assert len(calls) == 3


def _strs(x):
    return [_strs(v) for v in x] if isinstance(x, list) else str(x)
