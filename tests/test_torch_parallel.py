"""The port's sharded prover (gkr_mimc_tpu_torch/parallel/mesh.py) on the
CPU, in two gloo process groups: D = 2 ranks brought up explicitly
(``initialize(address, 2, pid)``) and D = 4 ranks from torchrun's
variables, as two "hosts" of two local ranks. A module fixture starts both
groups at once; every rank runs every case (tests/torch_parallel_worker.py)
and saves its results, and the cases here hold them against the port's
single prove, the golden vector (the JAX package's pinned bn = 2 proof)
and the JAX package's ``prove_sharded`` on its 8-device CPU mesh. Exact
comparisons throughout.

    python -m pytest tests/test_torch_parallel.py -q -p no:cacheprovider
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover
from gkr_mimc_tpu_torch.models.mimc import assign_fused
from gkr_mimc_tpu_torch.parallel import mesh as pmesh
from gkr_mimc_tpu_torch.parallel import multihost
from gkr_mimc_tpu_torch.poly import multilin
from gkr_mimc_tpu_torch.sumcheck import prover
from gkr_mimc_tpu_torch.utils.common import random_fr_array
from gkr_mimc_tpu_torch.utils.convert import from_jax_rows, ints_to_rows, rows_to_ints, to_jax_rows
from torch_common import golden, mimc_instance
from torch_parallel_worker import BN_SUMCHECK, BN_WALK, sumcheck_instance, transcript

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
GROUP_TIMEOUT_S = 180
GROUPS = {2: "explicit", 4: "env"}  # D -> how the group comes up


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{D: [rank results]} from both groups, run at once, and under "jax"
    the JAX package's sharded proof of the multi-claim instance, made in
    this process while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    def run(d):
        out = tmp_path_factory.mktemp(f"d{d}")
        multihost.launch_local(d, [WORKER, GROUPS[d], out], GROUP_TIMEOUT_S, local_size=2)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(d)]

    with ThreadPoolExecutor(len(GROUPS)) as pool:
        futures = {d: pool.submit(run, d) for d in GROUPS}
        results = {"jax": jax_prove_sharded_multiclaim()}
        return results | {d: f.result() for d, f in futures.items()}


def jax_prove_sharded_multiclaim():
    """The JAX package's sharded prover on a 2-device mesh of its virtual
    CPU devices, on the multi-claim instance: its transcript as the port's
    nested ints."""
    from gkr_mimc_tpu.parallel import mesh as jmesh
    from gkr_mimc_tpu.sumcheck import testing as jtesting

    xs, claims, qps, gate = jtesting.initialize_multi_instance(BN_SUMCHECK, 3)
    m = jmesh.make_mesh(2)
    proof = jmesh.prove_sharded([jmesh.shard_table(x, m) for x in xs], jtesting.to_device_qprimes(qps),
                                jtesting.to_device_claims(claims), gate, m)
    return tuple(rows_to_ints(from_jax_rows(np.moveaxis(np.asarray(t), -1, 0)).movedim(0, -1))
                 for t in (proof.coeffs, proof.challenges, proof.final_claims))


def groups(ranks):
    return [(d, ranks[d]) for d in GROUPS]


def single(kind):
    xs, qp, cl, gate = sumcheck_instance(kind)
    return transcript(prover.prove(xs, qp, cl, gate))


def test_shard_round_trip_eq_prefix_and_local_eq(ranks):
    """The slabs interleave back to the table; eq_prefix equals the JAX
    package's at every 3-bit chunk; each rank's eq slab is its share of
    the single prover's eq table (one claim: the seeded doubling build;
    three claims: the contraction with the RLC multipliers)."""
    from gkr_mimc_tpu.fields import fr as jfr
    from gkr_mimc_tpu.poly import multilin as jmultilin

    x = fr.from_ints_mont(list(range(64)))
    q = ints_to_rows(random_fr_array(3))
    mult = fr.from_int_mont(12345)
    jq = jnp.asarray(np.moveaxis(to_jax_rows(q.T), 0, -1))  # (3, 16) rows
    for d in range(8):
        want = jfr.to_ints(jmultilin.eq_prefix(jq, d, jnp.asarray(to_jax_rows(mult))).reshape(16, 1))
        assert fr.to_ints(multilin.eq_prefix(q, d, mult).reshape(8, 1)) == want
    for d, rs in groups(ranks):
        assert [r["rank"] for r in rs] == list(range(d)) and all(r["size"] == d for r in rs)
        assert torch.equal(pmesh.unshard_table([r["slab"] for r in rs]), x)
        for kind in ("cipher", "multi"):
            xs, qp, cl, gate = sumcheck_instance(kind)
            want = prover._make_eq(qp, cl, prover.LO_BITS)
            got = pmesh.unshard_table([r[f"eq_{kind}"] for r in rs])
            assert fr.to_ints(got) == fr.to_ints(want), (d, kind)


def test_sharded_cipher_sumcheck_matches_single(ranks):
    want = single("cipher")
    for d, rs in groups(ranks):
        for r in rs:
            assert r["cipher_coeff"] == want, (d, r["rank"])


def test_sharded_multiclaim_matches_single(ranks):
    """Three claims on an identity gate over two tables: the generic round
    with its sums all-reduced, then the replicated generic tail."""
    want = single("multi")
    for d, rs in groups(ranks):
        for r in rs:
            assert r["multi_coeff"] == want, (d, r["rank"])


def test_evals_equal_coeff_and_gruen_raises(ranks):
    for d, rs in groups(ranks):
        for r in rs:
            for kind in ("cipher", "multi"):
                assert r[f"{kind}_evals"] == r[f"{kind}_coeff"], (d, kind)
                assert "no Gruen path" in r[f"{kind}_gruen_error"]


def test_sharded_mimc_walk_matches_single(ranks):
    """bn = 6: every rank holds the single walk's proof vector; rank 0
    verified it with the unsharded tables."""
    c, block, state, qprime = mimc_instance(BN_WALK)
    want = [str(v) for v in proof_to_vec(c, gkr_prover.prove(c, assign_fused(block, state), qprime))]
    for d, rs in groups(ranks):
        assert all(r["walk"]["vec"] == want for r in rs), d
        assert rs[0]["walk"]["verified"]


def test_sharded_walk_gives_the_golden_vector(ranks):
    """The golden bn = 2 instance: at D = 2 one local round a layer, at
    D = 4 none (the whole walk replicated after the gather), on both
    round paths."""
    want = golden()["gkr_mimc"]
    for d, rs in groups(ranks):
        for rounds in pmesh.ROUNDS:
            assert all(r[f"golden_{rounds}"]["vec"] == want["proof_vec"] for r in rs), (d, rounds)


def test_multiclaim_matches_jax_prove_sharded(ranks):
    """The same instance through the JAX package's prove_sharded on
    make_mesh(2) (made in the fixture)."""
    assert ranks[2][0]["multi_coeff"] == ranks["jax"]
