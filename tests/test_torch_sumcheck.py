"""The port's sumcheck prover and verifier against the JAX package and the
golden transcripts.

With tail_bits = 2 the port runs its kernel-path head rounds (Gruen rounds
for the cipher gate, coefficient-form rounds for the identity gate) before
the generic tail; the JAX package on the CPU runs its portable path. The
round polynomials are the same field values, so transcripts must be equal.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

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
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints

GOLDEN = Path(__file__).resolve().parent / "golden" / "transcripts.json"


def _strs(x):
    return [_strs(v) for v in x] if isinstance(x, list) else str(x)


def _transcript(scp):
    return rows_to_ints(scp.coeffs), rows_to_ints(scp.challenges), rows_to_ints(scp.final_claims)


def _jax_transcript(scp):
    return jax_rows_to_ints(scp.coeffs), jax_rows_to_ints(scp.challenges), jax_rows_to_ints(scp.final_claims)


def _check_with_verifier(scp, claims_int, qprimes_int, gate):
    """The port's host verifier accepts, and the final claims close it."""
    coeffs, chals, final = _transcript(scp)
    got_chals, final_claim, recomb = verifier.verify(claims_int, coeffs)
    assert got_chals == chals
    eq_evals = [eq_eval_scalar(q, chals) for q in qprimes_int]
    assert scalar.mul(gate.eval_scalar(final[1:]), eval_univariate(eq_evals, recomb)) == final_claim


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())["sumcheck"]


@pytest.mark.parametrize("tail_bits", [8, 1])
@pytest.mark.parametrize("bn", [1, 2, 3])
def test_cipher_golden(golden, bn, tail_bits):
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tail_bits)
    coeffs, chals, final = _transcript(scp)
    want = golden[f"cipher_bn{bn}"]
    assert (_strs(coeffs), _strs(chals), _strs(final)) == (want["coeffs"], want["challenges"], want["final_claims"])


@pytest.mark.parametrize("lo_bits", [10, 2])
def test_multi_instance_golden(golden, lo_bits):
    xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, lo_bits=lo_bits)
    coeffs, chals, final = _transcript(scp)
    want = golden["multi_bn3_j10"]
    assert (_strs(coeffs), _strs(chals), _strs(final)) == (want["coeffs"], want["challenges"], want["final_claims"])
    _check_with_verifier(scp, claims, qps, gate)


def test_cipher_matches_jax_with_head_rounds():
    bn = 6
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tail_bits=2)
    jxs, jclaims, jqps, jgate = jtesting.initialize_cipher_gate_instance(bn)
    want = jsp.prove(jxs, jtesting.to_device_qprimes(jqps), jtesting.to_device_claims(jclaims), jgate)
    assert _transcript(scp) == _jax_transcript(want)
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
    assert _transcript(scp) == _jax_transcript(want)
    assert scp.coeffs.shape == (bn, 3, 8)


def test_head_tail_split_is_invisible():
    """tail_bits only moves rounds between the kernel path and the
    generic path; the transcript does not change."""
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(5, "cpu")
    runs = [
        _transcript(prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate, tb))
        for tb in (0, 1, 3, 8)
    ]
    assert all(r == runs[0] for r in runs[1:])


def test_bn0_empty_proof():
    xs, claims, qps, gate = testing.initialize_cipher_gate_instance(0, "cpu")
    scp = prover.prove(xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate)
    assert scp.coeffs.shape == (0, 9, 8) and scp.challenges.shape == (0, 8)
    assert scp.final_claims.dtype == torch.int32 and scp.final_claims.shape == (3, 8)
