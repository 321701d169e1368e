"""The plain verifier against the program's proofs, made on the CPU at bn = 4."""

import subprocess
import sys

import pytest
import torch

from bench_h100.cell import Bench
from bench_h100.reference import verifier
from bench_h100.spec import ROOT

from .cpu import CPU, small_cell


def _proof(workload, lanes, seed=2**31 + 11):
    bench = Bench(small_cell(workload, 4, lanes), CPU)
    inputs = bench.inputs(seed, 0)
    out, proof, *_ = bench.one_proof(inputs)
    return bench, inputs, out, proof


@pytest.mark.parametrize("workload,lanes", [("mimc91-resident.single-2e22", 1),
                                            ("mimc91-resident.grouped-4x2e20", 2),
                                            ("mimc91-ckpt.single-2e25", 1)])
def test_accepts_the_programs_proof(workload, lanes):
    bench, inputs, out, proof = _proof(workload, lanes)
    rep = verifier.check_proof(bench.prover.proof_arrays(proof, lanes), inputs.block, inputs.state, out,
                               inputs.points)
    assert rep.failures == {}
    cols = torch.arange(out.reshape(8, -1).shape[1])
    assert verifier.hash_mismatches(inputs.block, inputs.state, out, cols) == 0


def test_rejects_a_tampered_coefficient_and_a_wrong_output():
    bench, inputs, out, proof = _proof("mimc91-resident.single-2e22", 1)
    arrays = bench.prover.proof_arrays(proof, 1)
    arrays["coeffs"][40] = arrays["coeffs"][40].copy()
    arrays["coeffs"][40][2, 3, 0] ^= 1
    rep = verifier.check_proof(arrays, inputs.block, inputs.state, out, inputs.points)
    assert rep.total > 0 and "round_sum" in rep.failures
    bad = out.clone()
    bad[0, 5] ^= 4
    rep = verifier.check_proof(bench.prover.proof_arrays(proof, 1), inputs.block, inputs.state, bad, inputs.points)
    assert rep.failures.get("round_sum", 0) >= 1
    assert verifier.hash_mismatches(inputs.block, inputs.state, bad, torch.arange(16)) == 1


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, bench_h100.reference.verifier, bench_h100.reference.hashing; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"gkr_mimc_tpu_torch", "gkr_mimc_tpu", "jax", "jaxlib", "flax"}
