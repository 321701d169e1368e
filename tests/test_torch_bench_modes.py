"""The other modes of ``python -m gkr_mimc_tpu_torch.bench`` on the CPU:
grouped (each lane equal to a single proof of its inputs), chunked (every
chunk verified, its outputs the host permutation of the stream, its inputs
the JAX package's generator at the reference's offsets), sharded at world
size 1 on gloo (the single walk's proof), and the order in which the
environment picks a mode (bench.py:392-403). No JAX GKR walk runs here.

    python -m pytest tests/test_torch_bench_modes.py -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch import bench
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from gkr_mimc_tpu_torch.hashes.mimc import mimc_keyed_permutation
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.utils.common import random_fr_array

CPU = torch.device("cpu")


def stream(i: int) -> int:
    return random_fr_array(i + 1)[i]


def test_grouped_lanes_equal_single_proofs():
    run = bench.grouped(2, 2, CPU, ckpt=True, warmup=False)
    assert run.record()["metric"] == "mimc_hashes_proven_per_sec_grouped_bn2_g2"
    assert run.verified == 2 and run.hashes == 8
    for i in range(2):
        a = assign_fused(run.block[:, i].contiguous(), run.state[:, i].contiguous())
        single = gkr_prover.prove(run.circuit, a, run.qprime[:, i].contiguous())
        assert proof_to_vec(run.circuit, gkr_verifier.slice_group(run.proof, i)) == proof_to_vec(run.circuit, single)


def test_chunked_verifies_every_chunk():
    """T = 4, bn = 2: four chunks, each verified, each output table the
    host MiMC permutation of its state (the stream at (4 + ci) * 4) keyed
    by its block (the stream at ci * 4)."""
    run = bench.chunked(2, 4, CPU, sample=[0, 1, 2, 3])
    assert run.record()["metric"] == "mimc_hashes_proven_per_sec_total2e4_bn2"
    assert run.verified == 4 and run.hashes == 16
    assert [(b, s) for b, s, _ in run.outputs] == [(4 * ci, 4 * (4 + ci)) for ci in range(4)]
    assert {"warmup_s", "loop_s"} <= set(run.times)
    for b, s, out in run.outputs:
        assert fr.to_ints(out) == [mimc_keyed_permutation(stream(s + i), stream(b + i)) for i in range(4)]
    assert bench.chunked(2, 3, CPU, warmup=False).outputs == []


def test_chunk_inputs_are_the_jax_generator_stream():
    """Chunk ci's block and state against the JAX package's
    random_fr_array_np(2^bn, offset) at bench.py's offsets."""
    from gkr_mimc_tpu.utils.common import random_fr_array_np

    bn, chunks = 3, 4
    for ci in range(chunks):
        block, state = bench.chunk_inputs(ci, chunks, bn, CPU)
        for got, off in ((block, ci << bn), (state, (chunks + ci) << bn)):
            want = random_fr_array_np(1 << bn, off)
            assert want.dtype == np.uint64
            assert fr.to_ints(got) == [int(v) for v in want]


def test_sharded_world_size_1_on_gloo_equals_the_single_walk():
    run = bench.sharded(3, CPU)
    assert run.record()["metric"] == "mimc_hashes_proven_per_sec_sharded_bn3_d1"
    assert run.verified == 1 and run.extra["backend"] == "gloo" and run.extra["world"] == 1
    assert not torch.distributed.is_initialized()
    single = bench.single(3, CPU, ckpt=False, verify=False, warmup=False)
    assert proof_to_vec(run.circuit, run.proof) == proof_to_vec(single.circuit, single.proof)


@pytest.mark.parametrize("env, mode", [
    ({"GKR_BENCH_SHARDED": "1", "GKR_BENCH_GROUP": "4", "GKR_BENCH_TOTAL_LOG2": "23"}, "sharded"),
    ({"GKR_BENCH_GROUP": "4", "GKR_BENCH_TOTAL_LOG2": "23"}, "grouped"),
    ({"GKR_BENCH_GROUP": "1", "GKR_BENCH_TOTAL_LOG2": "21"}, "single"),
], ids=["sharded-first", "grouped-before-chunked", "total-not-above-bn"])
def test_mode_dispatch_order(env, mode):
    assert bench.mode_of(21, env) == mode
    assert bench.mode_of(20, {"GKR_BENCH_TOTAL_LOG2": "21"}) == "chunked"
