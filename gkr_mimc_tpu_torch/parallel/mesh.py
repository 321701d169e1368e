"""The sharded GKR prover over D processes (the reference's
gkr_mimc_tpu/parallel/mesh.py).

Layout: hypercube index x = q * D + d lives on rank d at local position q
("cyclic", low-bit sharding). A sumcheck round pairs x with x + n/2, which
share their low bits, so every fold is rank-local until the local tables
hold one entry; then the D entries are all-gathered in rank order, and
every rank finishes the last log2(D) rounds on the same replicated tables.
Each rank seeds its local eq table with the prefix product of its rank's
bits (``multilin.eq_prefix``) over the last log2(D) variables.

Transcript parity: each round's sums are canonical values on every rank;
``all_reduce_fr`` adds their 32-bit limbs as int64 columns over the ranks
(exact for D < 2**31) and reduces the carried sum mod p, so every rank
holds the single-device round polynomial, hashes the same challenge and
folds at it. The proofs equal the single walk's bit for bit.

The reference holds one global array sharded over a JAX mesh; here each
rank holds its own slab, ``Mesh`` names the process group, and
``jax.lax.psum`` and ``all_gather`` are ``torch.distributed`` collectives
on the ranks' device tensors (nccl, or gloo, which takes CUDA tensors for
both through the host).

The ranks' entry point, under torchrun's variables (``multihost.initialize``
reads them):

    python -m gkr_mimc_tpu_torch.parallel.mesh --bn 22 --backend nccl

proves 2**bn MiMC hashes on the sharded walk, each rank building only its
slab of the inputs, and prints one JSON line of the rank's times and
counts. ``dryrun(n)`` starts n such ranks on this host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..circuits.circuit import Circuit
from ..circuits.gates import Gate
from ..fields import fr
from ..fields.bn254 import L
from ..gkr import prover as gkr_prover
from ..gkr.prover import GKRProof
from ..models.mimc import assign_fused
from ..ops import kernels as K
from ..poly import lagrange, multilin
from ..sumcheck import prover as sp
from ..sumcheck.prover import SumcheckProof

ROUNDS = ("coeff", "evals")  # the sharded head rounds; the reference's sharded walk has no Gruen path


@dataclass
class Mesh:
    """D ranks, one device each: ``group`` is the process group (None for
    a single process without one), ``rank`` this process's index, ``size``
    D (a power of two), ``device`` this rank's device. ``counts`` counts the
    collectives this rank took part in."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None = None
    counts: dict = field(default_factory=lambda: {"all_reduce": 0, "all_gather": 0})

    @property
    def log_size(self) -> int:
        return self.size.bit_length() - 1


def _rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: "cuda" takes card local_rank modulo the cards on
    the host and raises without one; "cpu" or an indexed device as given."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for and none is available")
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def make_mesh(n_devices: int | None = None, backend: str | None = None, device="cuda") -> Mesh:
    """The mesh of the process group that is already initialised (see
    ``multihost.initialize``), or of this process alone when none is.
    n_devices, if given, must be the group's size; backend, if given, its
    backend. The device defaults to the card (by local rank), and the call
    raises without one."""
    if dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
        have = dist.get_backend()
    else:
        size, rank, group, have = 1, 0, None, None
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"a {n_devices}-rank mesh was asked for, the process group has {size}")
    if size & (size - 1):
        raise ValueError(f"the mesh needs a power-of-two size, the group has {size}")
    if backend is not None and have is not None and backend != have:
        raise RuntimeError(f"the process group runs {have}, {backend} was asked for")
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs CUDA devices")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group, rank, size, dev, have)


def shard_table(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(8, N) table -> this rank's slab (8, N/D): entry q = x[q * D + rank]."""
    if x.shape[-1] % mesh.size:
        raise ValueError(f"{x.shape[-1]} entries do not split over {mesh.size} ranks")
    return x[..., mesh.rank :: mesh.size].contiguous()


def unshard_table(slabs: list) -> torch.Tensor:
    """The D slabs of a table, in rank order -> the (8, D * M) table."""
    return torch.stack(list(slabs), dim=-1).reshape(slabs[0].shape[:-1] + (-1,))


def all_reduce_fr(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The field sum over the ranks of canonical (8, *S) values: their
    limbs widened to int64 columns, summed by the process group (exact for
    D < 2**31), carried and reduced mod p -> canonical (8, *S), the same
    on every rank. The reference's psum of limb columns (``_renorm_psum``)."""
    if mesh.size == 1 and mesh.group is None:
        return x
    if mesh.group is None:
        raise RuntimeError(f"a mesh of {mesh.size} ranks without a process group")
    w = fr.widen(x)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.counts["all_reduce"] += 1
    return fr.from_limb_sums(w, mesh.size)


def all_gather_entries(tables: list, mesh: Mesh) -> list:
    """Local (8, 1, 1) tables -> replicated (8, 1, D) tables, rank d's entry
    at position d (the reference's ``_gather_fn``), in one collective."""
    local = torch.cat([t.reshape(L, 1) for t in tables], dim=1).contiguous()  # (8, T)
    if mesh.group is None:
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks without a process group")
        outs = [local]
    else:
        outs = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(outs, local, group=mesh.group)
    mesh.counts["all_gather"] += 1
    full = torch.stack(outs, dim=-1)  # (8, T, D)
    return [full[:, i].reshape(L, 1, mesh.size).contiguous() for i in range(len(tables))]


# ---------------------------------------------------------------------------
# The sharded sumcheck
# ---------------------------------------------------------------------------


def _make_eq_local(qprimes: torch.Tensor, claims: torch.Tensor, rank: int, local_bn: int,
                   lo_bits: int = sp.LO_BITS) -> torch.Tensor:
    """This rank's slab of the combined eq table sum_j rlc^j eq(q_j, x)
    (the reference's ``_make_eq_local`` and ``_make_eq_local_fast``):
    x = q * D + rank, so eq(q_j, x) = eq(q_j[:local_bn], q) *
    eq_prefix(q_j[local_bn:], rank). One claim below 2**13 local entries
    takes the doubling build seeded with its prefix; otherwise each claim's
    RLC multiplier times its prefix enters the hi/lo contraction over the
    local variables. qprimes (J, bn, 8), claims (8, J) -> (8, 2**local_bn)."""
    j = qprimes.shape[0]
    prefs = [multilin.eq_prefix(qprimes[i, local_bn:], rank) for i in range(j)]
    if j == 1 and local_bn < sp.MULTI_EQ_MIN_BITS:
        return multilin.eq_table(qprimes[0, :local_bn], multiplier=prefs[0])
    ms = fr.mul(sp._rlc_multipliers(claims.unsqueeze(-1))[..., 0], torch.stack(prefs, dim=1))
    return sp.eq_contraction(qprimes[:, :local_bn], ms, lo_bits)


def _kernel_round(kind: str, rounds: str, n_evals: int, ark, eq, xs, mesh: Mesh):
    """One head round on the rank's (8, 1, m) tables through the kernels:
    the local round sums ("coeff": the coefficients; "evals": the values at
    every t, no claim trick, as the reference's GKR_COEFF_PE=0 branch), the
    all-reduce, interpolation ("evals"), the challenge, one fold."""
    flat = [t.reshape(L, -1) for t in [eq] + xs]
    if rounds == "coeff":
        sums = K.cipher_coeff_acc(*flat, ark, 1) if kind == "cipher" else K.identity_acc(*flat, 1)
        coeffs = all_reduce_fr(sums, mesh)
    else:
        if kind == "cipher":
            sums = K.cipher_partial_evals(*flat, ark, 1, n_evals, False)
        else:
            sums = K.identity_partial_evals(*flat, 1, n_evals, False)
        coeffs = lagrange.interpolate_on_range_device(all_reduce_fr(sums, mesh))
    r = sp._challenge(coeffs)
    eq, xs = sp._fold_all(flat, r, 1)
    return eq, xs, coeffs, r


def prove_sharded(xs_local: list, qprimes: torch.Tensor, claims, gate: Gate, mesh: Mesh,
                  rounds: str = "coeff") -> SumcheckProof:
    """The sharded counterpart of ``sumcheck.prover.prove`` (single
    instance): xs_local are this rank's slabs (8, 2**bn / D) of the layer's
    tables; qprimes (J, bn, 8) and claims (8, J) (or None for the output
    layer) are the same on every rank. Returns the single-device proof, the
    same on every rank.

    The local rounds of a cipher or identity layer run on the kernels
    (rounds="coeff", the reference's default, or "evals"); any other gate
    takes the generic round with its sums all-reduced. Once the local
    tables hold one entry they are all-gathered, and the last log2(D)
    rounds run replicated: ``tail_rounds`` for a cipher or identity layer,
    generic rounds otherwise."""
    if rounds not in ROUNDS:
        raise ValueError(f"rounds={rounds!r}: the sharded walk runs {ROUNDS}; it has no Gruen path "
                         "(the reference's sharded walk has none)")
    j, bn = qprimes.shape[0], qprimes.shape[1]
    local_bn = bn - mesh.log_size
    if local_bn < 0:
        raise ValueError(f"a hypercube of 2^{bn} entries is smaller than the mesh of {mesh.size}")
    m = 1 << local_bn
    for x in xs_local:
        if tuple(x.shape) != (L, m):
            raise ValueError(f"slab shape {tuple(x.shape)}, expected {(L, m)}")
    device = qprimes.device
    if claims is None:
        if j != 1:
            raise ValueError("a layer without claims takes exactly one qPrime")
        claims = fr.zeros((0,), device)
    params = gate.params(device)
    kind = sp._kernel_kind(gate, xs_local)
    n_evals = gate.degree + 2
    ark = params[0].reshape(L, 1).contiguous() if kind == "cipher" else None
    eq = _make_eq_local(qprimes, claims, mesh.rank, local_bn).reshape(L, 1, m)
    xs = [x.reshape(L, 1, m) for x in xs_local]
    coeffs, rs = [], []

    def evaluate(xs_t):
        return gate.eval_batch(params, xs_t)

    def combine(evals):
        return all_reduce_fr(fr.canonicalize(evals), mesh)

    for _ in range(local_bn):
        if kind is None:
            eq, xs, c, r = K.generic_round(evaluate, n_evals, eq, xs, sp._challenge, combine)
        else:
            eq, xs, c, r = _kernel_round(kind, rounds, n_evals, ark, eq, xs, mesh)
        coeffs.append(c)
        rs.append(r)
    if mesh.size > 1:
        eq, *xs = all_gather_entries([eq] + xs, mesh)
        while eq.shape[-1] > (1 if kind is None else 1 << K.TAIL_MAX_BITS):
            eq, xs, c, r = K.generic_round(evaluate, n_evals, eq, xs, sp._challenge)
            coeffs.append(c)
            rs.append(r)
        if kind is not None and eq.shape[-1] > 1:
            eq, xs = sp._tail(kind, params, eq, xs, coeffs, rs)
    return sp._package(coeffs, rs, eq, xs, n_evals, grouped=False)


# ---------------------------------------------------------------------------
# The sharded GKR walk
# ---------------------------------------------------------------------------


def assign_sharded_mimc(block_local: torch.Tensor, state_local: torch.Tensor) -> list:
    """The MiMC witness of this rank's slabs: the witness is elementwise,
    so it is ``assign_fused`` on the slabs, one ``mimc_witness`` launch a
    rank."""
    return assign_fused(block_local, state_local)


def prove_gkr_sharded(circuit: Circuit, assignment: list, qprime: torch.Tensor, mesh: Mesh,
                      rounds: str = "coeff") -> GKRProof:
    """The GKR walk over this rank's slabs of the assignment tables: every
    layer proven by ``prove_sharded``. qprime (bn, 8) is the same on every
    rank; the proof equals the single walk's and is the same on every
    rank, so ``proof_to_vec`` and ``gkr.verifier.verify`` take it as
    they are."""
    return gkr_prover.walk(circuit, assignment, qprime,
                           lambda xs, qprimes, claims, gate: prove_sharded(xs, qprimes, claims, gate, mesh, rounds))


# ---------------------------------------------------------------------------
# The ranks' entry point and the dry run
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(bn: int, backend: str, device="cuda", repeat: int = 1, verify: bool = False,
             vec_out: str | None = None) -> dict:
    """One rank of a sharded "coeff" proof of 2**bn MiMC hashes (the main path's
    inputs: block = state = the generator's stream at 0, qprime =
    random_fr_array(bn)), the group brought up from torchrun's variables:
    this rank's slabs of the inputs, the witness, ``repeat`` proofs (each
    timed), and with ``verify`` the tables gathered and the proof verified
    on rank 0. Rank 0 writes the proof vector to ``vec_out`` (JSON) if
    given. Returns the rank's report: its times, the last walk's
    collectives and the first walk's launches (inputs and witness
    included)."""
    from ..gadget.serialize import proof_to_vec
    from ..gkr import verifier as gkr_verifier
    from ..models.mimc import mimc_circuit
    from ..utils.common import random_fr_array
    from ..utils.convert import ints_to_rows
    from . import multihost

    t0 = time.perf_counter()
    multihost.initialize(backend=backend)
    mesh = multihost.make_global_mesh(device=device, backend=backend)
    up_s = time.perf_counter() - t0
    c = mimc_circuit()
    K.reset_launch_counts()
    _sync(mesh.device)
    t0 = time.perf_counter()
    block = multihost.shard_mimc_inputs_global(mesh, 1 << bn)
    state = block.clone()
    qprime = ints_to_rows(random_fr_array(bn), mesh.device)
    _sync(mesh.device)
    t1 = time.perf_counter()
    a = assign_sharded_mimc(block, state)
    _sync(mesh.device)
    t2 = time.perf_counter()
    prove_s = []
    for i in range(repeat):
        mesh.counts.update(all_reduce=0, all_gather=0)
        _sync(mesh.device)
        t3 = time.perf_counter()
        proof = prove_gkr_sharded(c, a, qprime, mesh)
        _sync(mesh.device)
        prove_s.append(time.perf_counter() - t3)
        if i == 0:  # the first walk's, with its inputs and witness
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
    counts = dict(mesh.counts)
    vec = proof_to_vec(c, proof)
    report = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend, "device": str(mesh.device),
              "bn": bn, "bring_up_s": up_s, "inputs_s": t1 - t0, "witness_s": t2 - t1,
              "prove_s": prove_s, "collectives": counts, "launches": launches, "vec_len": len(vec),
              "vec_sha256": hashlib.sha256(",".join(map(str, vec)).encode()).hexdigest()}
    if mesh.device.type == "cuda":
        report["peak_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9
    if verify:
        full = [unshard_table(all_gather_slab(t, mesh)) for t in (block, state, a[-1])]
        if mesh.rank == 0:
            gkr_verifier.verify(c, proof, full[:2], full[2], qprime)
            report["verified"] = True
    if vec_out is not None and mesh.rank == 0:
        with open(vec_out, "w") as f:
            json.dump([str(v) for v in vec], f)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
        dist.destroy_process_group()
    return report


def all_gather_slab(t: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's slab of a table, in rank order (for checks at small
    sizes: each rank then holds the whole table)."""
    if mesh.group is None:
        return [t]
    outs = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(outs, t.contiguous(), group=mesh.group)
    mesh.counts["all_gather"] += 1
    return outs


def dryrun(n_devices: int, device="cuda", timeout_s: float = 600.0) -> list:
    """The driver hook: start n_devices ranks on this host, each on card
    rank modulo the cards (gloo when two ranks share a card, since nccl
    refuses two ranks on one device; nccl otherwise; gloo for "cpu"), and
    run the sharded walk at bn = log2(n_devices) + 2 twice, verified on
    rank 0. Prints the reference's ``dryrun_multichip OK`` line and returns
    the ranks' reports; raises if a rank fails or outlives timeout_s."""
    from . import multihost

    if n_devices < 1 or n_devices & (n_devices - 1):
        raise ValueError(f"n_devices={n_devices}: expected a power of two")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun: a CUDA device was asked for and none is available")
        backend = "gloo" if n_devices > torch.cuda.device_count() else "nccl"
        from ..ops import build

        build.build()  # once here, not in every rank
    else:
        backend = "gloo"
    bn = n_devices.bit_length() + 1
    outs = multihost.launch_local(n_devices, ["-m", "gkr_mimc_tpu_torch.parallel.mesh", "--bn", str(bn),
                                              "--backend", backend, "--device", dev.type, "--repeat", "2",
                                              "--verify"], timeout_s)
    reports = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    if len({r["vec_sha256"] for r in reports}) != 1 or not reports[0].get("verified"):
        raise RuntimeError(f"dryrun: the ranks' proofs differ or rank 0's did not verify: {reports}")
    cold, warm = reports[0]["prove_s"]
    print(f"dryrun_multichip OK: {n_devices} devices, bn={bn}, sharded prove {cold:.1f}s cold / "
          f"{warm:.2f}s warm ({backend}, {reports[0]['device']})")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One rank of the sharded MiMC GKR walk (torchrun's variables).")
    ap.add_argument("--bn", type=int, required=True, help="log2 of the hashes proven")
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    ap.add_argument("--device", default="cuda", help="cuda (card local rank modulo the cards) or cpu")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--verify", action="store_true", help="gather the tables and verify on rank 0")
    ap.add_argument("--vec-out", help="rank 0 writes the proof vector here (JSON)")
    args = ap.parse_args(argv)
    report = run_rank(args.bn, args.backend, args.device, args.repeat, args.verify, args.vec_out)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    from gkr_mimc_tpu_torch.parallel import mesh as _package_module  # run in the package's module, not a copy

    sys.exit(_package_module.main())
