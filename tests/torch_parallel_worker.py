"""One rank of tests/test_torch_parallel.py's process groups (not a test
module): brings the gloo group up, runs every case of that file on the
CPU, and saves its results to <outdir>/rank<r>.pt.

    python tests/torch_parallel_worker.py explicit|env <outdir>

"explicit" reads the address, world size and rank that the launcher set
in torchrun's variables, removes the variables and passes them to
``multihost.initialize``; "env" lets ``initialize`` read them.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec  # noqa: E402
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gkr_mimc_tpu_torch.parallel import multihost  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import testing  # noqa: E402
from gkr_mimc_tpu_torch.utils.common import random_fr_array  # noqa: E402
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints  # noqa: E402

BN_SUMCHECK = 4
BN_WALK = 6


def transcript(scp):
    return rows_to_ints(scp.coeffs), rows_to_ints(scp.challenges), rows_to_ints(scp.final_claims)


def sumcheck_instance(kind):
    if kind == "cipher":
        xs, claims, qps, gate = testing.initialize_cipher_gate_instance(BN_SUMCHECK, "cpu")
    else:
        xs, claims, qps, gate = testing.initialize_multi_instance(BN_SUMCHECK, 3, "cpu")
    return xs, testing.to_device_qprimes(qps, "cpu"), testing.to_device_claims(claims, "cpu"), gate


def walk(m, bn, rounds, verify=True):
    """The sharded MiMC walk on the main path's inputs at 2**bn; with
    ``verify``, rank 0 verifies it with the gathered (unsharded) tables."""
    c = mimc_circuit()
    block = multihost.shard_mimc_inputs_global(m, 1 << bn)
    state = block.clone()
    qprime = ints_to_rows(random_fr_array(bn))
    a = pmesh.assign_sharded_mimc(block, state)
    proof = pmesh.prove_gkr_sharded(c, a, qprime, m, rounds)
    out = {"vec": [str(v) for v in proof_to_vec(c, proof)]}
    if not verify:
        return out
    full = [pmesh.unshard_table(pmesh.all_gather_slab(t, m)) for t in (block, state, a[93])]
    if m.rank == 0:
        gkr_verifier.verify(c, proof, full[:2], full[2], qprime)
        out["verified"] = True
    return out


def main():
    mode, outdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)  # six ranks of tiny tensors beside the other test workers
    if mode == "explicit":
        addr = f"{os.environ.pop('MASTER_ADDR')}:{os.environ.pop('MASTER_PORT')}"
        world, rank = int(os.environ.pop("WORLD_SIZE")), int(os.environ.pop("RANK"))
        multihost.initialize(addr, world, rank, backend="gloo", timeout_s=120)
    else:
        multihost.initialize(backend="gloo", timeout_s=120)
    m = multihost.make_global_mesh(device="cpu", backend="gloo")
    res = {"rank": m.rank, "size": m.size, "report": multihost.process_local_report()}

    x = fr.from_ints_mont(list(range(64)))
    res["slab"] = pmesh.shard_table(x, m)
    for kind in ("cipher", "multi"):
        xs, qp, cl, gate = sumcheck_instance(kind)
        res[f"eq_{kind}"] = pmesh._make_eq_local(qp, cl, m.rank, BN_SUMCHECK - m.log_size)
        slabs = [pmesh.shard_table(t, m) for t in xs]
        for rounds in pmesh.ROUNDS:
            res[f"{kind}_{rounds}"] = transcript(pmesh.prove_sharded(slabs, qp, cl, gate, m, rounds))
        try:
            pmesh.prove_sharded(slabs, qp, cl, gate, m, "gruen")
        except ValueError as e:
            res[f"{kind}_gruen_error"] = str(e)
    res["walk"] = walk(m, BN_WALK, "coeff")
    for rounds in pmesh.ROUNDS:
        res[f"golden_{rounds}"] = walk(m, 2, rounds, verify=False)  # the pinned vector says more
    res["collectives"] = dict(m.counts)
    torch.save(res, outdir / f"rank{m.rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
