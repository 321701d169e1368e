"""The port's sumcheck prover and verifier against the JAX package and the
golden transcripts: the 91-claim and the 10-claim multi-instance shapes,
the cipher gate with kernel-path head rounds, and the head/tail split.

With tail_bits = 2 the port runs its kernel-path head rounds (Gruen rounds
for the cipher gate, coefficient-form rounds for the identity gate) before
the generic tail; the JAX package on the CPU runs its portable path. The
round polynomials are the same field values, so transcripts must be equal.

    python -m pytest tests/test_torch_sumcheck_jax.py -q -p no:cacheprovider
"""

import jax.numpy as jnp
import pytest

from gkr_mimc_tpu.circuits.gates import IdentityGate as JaxIdentityGate
from gkr_mimc_tpu.fields import fr as jfr
from gkr_mimc_tpu.sumcheck import prover as jsp
from gkr_mimc_tpu.sumcheck import testing as jtesting
from gkr_mimc_tpu.utils.convert import ints_to_rows as jax_ints_to_rows
from gkr_mimc_tpu.utils.convert import rows_to_ints as jax_rows_to_ints
from gkr_mimc_tpu_torch.circuits.gates import IdentityGate
from gkr_mimc_tpu_torch.fields import fr, scalar
from gkr_mimc_tpu_torch.poly.lagrange import eval_univariate
from gkr_mimc_tpu_torch.poly.multilin import eq_eval_scalar
from gkr_mimc_tpu_torch.sumcheck import prover, testing, verifier
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows
from torch_common import golden as load_golden
from torch_common import strs, transcript


def _jax_transcript(scp):
    return jax_rows_to_ints(scp.coeffs), jax_rows_to_ints(scp.challenges), jax_rows_to_ints(scp.final_claims)


def _check_with_verifier(scp, claims_int, qprimes_int, gate):
    """The port's host verifier accepts, and the final claims close it."""
    coeffs, chals, final = transcript(scp)
    got_chals, final_claim, recomb = verifier.verify(claims_int, coeffs)
    assert got_chals == chals
    eq_evals = [eq_eval_scalar(q, chals) for q in qprimes_int]
    assert scalar.mul(gate.eval_scalar(final[1:]), eval_univariate(eq_evals, recomb)) == final_claim


@pytest.fixture(scope="module")
def golden():
    return load_golden()["sumcheck"]


@pytest.mark.parametrize("lo_bits", [10, 2])
def test_multi_instance_golden(golden, lo_bits):
    xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, lo_bits=lo_bits)
    coeffs, chals, final = transcript(scp)
    want = golden["multi_bn3_j10"]
    assert (strs(coeffs), strs(chals), strs(final)) == (want["coeffs"], want["challenges"], want["final_claims"])
    _check_with_verifier(scp, claims, qps, gate)


def test_cipher_matches_jax_with_head_rounds():
    bn = 6
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tail_bits=2)
    jxs, jclaims, jqps, jgate = jtesting.initialize_cipher_gate_instance(bn)
    want = jsp.prove(jxs, jtesting.to_device_qprimes(jqps), jtesting.to_device_claims(jclaims), jgate)
    assert transcript(scp) == _jax_transcript(want)
    _check_with_verifier(scp, claims, qps, gate)


def test_91_claim_identity_matches_jax_with_head_rounds():
    """The fan-out layer's shape: one table, 91 claims (multi-claim eq
    build, coefficient-form head rounds)."""
    bn, j = 6, 91
    vals = random_fr_array(j * bn + (1 << bn) + j)
    table = vals[: 1 << bn]
    qps = [vals[(1 << bn) + i * bn : (1 << bn) + (i + 1) * bn] for i in range(j)]
    claims = vals[-j:]
    scp = prover.prove([fr.from_ints_mont(table)], ints_to_rows(qps), fr.encode_mont_ints(claims), IdentityGate(), tail_bits=2)
    want = jsp.prove(
        [jfr.from_ints_mont(table)], jnp.asarray(jax_ints_to_rows(qps)), jfr.encode_mont_ints(claims), JaxIdentityGate()
    )
    assert transcript(scp) == _jax_transcript(want)
    assert scp.coeffs.shape == (bn, 3, 8)


def test_head_tail_split_is_invisible():
    """tail_bits only moves rounds between the kernel path and the
    generic path; the transcript does not change."""
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(5, "cpu")
    runs = [
        transcript(prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tb))
        for tb in (0, 1, 3, 8)
    ]
    assert all(r == runs[0] for r in runs[1:])
