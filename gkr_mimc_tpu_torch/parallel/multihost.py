"""Several processes or hosts proving one sharded walk (the reference's
gkr_mimc_tpu/parallel/multihost.py).

The sharded prover of ``mesh.py`` runs unchanged: the hypercube splits
over every rank of the job, one device a rank, and each round's sums are
all-reduced over the process group, within a host and across hosts alike.
Every rank derives the same Fiat-Shamir challenge from the reduced sums,
so the transcripts agree without a coordinator message. Every rank builds
only its own slab of the inputs (``shard_table_global``), so no process
holds the whole 2**bn table.

Usage, one process a device (torchrun sets the variables ``initialize``
reads; ``initialize(address, n, pid)`` names them instead):

    from gkr_mimc_tpu_torch.parallel import mesh, multihost
    multihost.initialize(backend="nccl")
    m = multihost.make_global_mesh()
    block = multihost.shard_mimc_inputs_global(m, n)
    ... mesh.prove_gkr_sharded(circuit, mesh.assign_sharded_mimc(block, state), qprime, m)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from ..fields import fr
from ..fields.bn254 import L
from ..utils.common import random_fr_at
from .mesh import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 300.0  # process-group bring-up and collectives


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """``torch.distributed`` bring-up over TCP at coordinator_address
    ("host:port"), num_processes ranks, this one process_id. With no
    argument, torchrun's variables apply (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). The backend is named, never guessed: "nccl" (the
    default, one card a rank) or "gloo" (CPU ranks, or ranks sharing a
    card). A no-op once a group is up.

    Failure policy, the reference's: a cluster requested explicitly (any
    of the first three arguments) or by WORLD_SIZE > 1 must come up, and a
    failed bring-up raises RuntimeError: a job meant for many ranks never
    goes on as one. Only the zero-config single process (no argument,
    WORLD_SIZE unset or 1) returns without a group, world size 1."""
    if dist.is_initialized():
        return
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and env_world <= 1:
        return
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}, expected one of {BACKENDS}")
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    address = coordinator_address
    if address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    try:
        if address is None:
            raise ValueError("no coordinator address: pass one or set MASTER_ADDR and MASTER_PORT")
        dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError, TimeoutError, OSError) as e:  # the store's and the backends' errors
        raise RuntimeError(f"torch.distributed bring-up failed for rank {rank} of {world} at {address} "
                           f"({backend}): {e}") from e


def make_global_mesh(device="cuda", backend: str | None = None) -> Mesh:
    """The mesh over every rank of the job (``mesh.make_mesh`` of the
    initialised group), this rank on card LOCAL_RANK modulo the host's
    cards; raises without a card unless device="cpu"."""
    return make_mesh(None, backend, device)


def shard_table_global(mesh: Mesh, n: int, fill) -> torch.Tensor:
    """This rank's slab of an n-entry cyclic-sharded table, built by this
    rank alone: ``fill(rank, n // D)`` returns the (8, n // D) slab of
    indices rank, rank + D, rank + 2D, ... on (or moved to) the rank's
    device."""
    if n % mesh.size:
        raise ValueError(f"{n} entries do not split over {mesh.size} ranks")
    m = n // mesh.size
    slab = fill(mesh.rank, m)
    if tuple(slab.shape) != (L, m):
        raise ValueError(f"fill returned {tuple(slab.shape)}, expected {(L, m)}")
    return slab.to(mesh.device).contiguous()


def mimc_inputs(idx: torch.Tensor) -> torch.Tensor:
    """The main path's inputs at global indices idx: the generator's
    stream there, in Montgomery form."""
    return fr.to_mont(random_fr_at(idx))


def shard_mimc_inputs_global(mesh: Mesh, n: int, gen_fn=mimc_inputs) -> torch.Tensor:
    """This rank's slab of deterministic inputs: ``gen_fn(idx)`` maps the
    rank's global indices idx = rank + D * k (an int64 tensor on the rank's
    device) to the (8, n // D) slab. By default the generator's stream in
    Montgomery form (block = state = this at the main path's inputs)."""
    if n > 1 << 32:
        raise ValueError(f"{n} inputs: the generator's indices stop at 2**32")

    def fill(rank, m):
        return gen_fn(rank + mesh.size * torch.arange(m, dtype=torch.int64, device=mesh.device))

    return shard_table_global(mesh, n, fill)


def process_local_report() -> dict:
    """A small record of this process's place in the job."""
    up = dist.is_initialized()
    cuda = torch.cuda.is_available()
    world = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": world,  # one device a rank
        "platform": "gpu" if cuda else "cpu",
        "backend": dist.get_backend() if up else None,
    }


def free_port() -> int:
    """A TCP port on this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(n: int, args: list, timeout_s: float, local_size: int | None = None) -> list:
    """Start n ranks ``python <args>`` on this host with torchrun's
    variables (MASTER_ADDR=127.0.0.1, a free MASTER_PORT, WORLD_SIZE=n,
    RANK, LOCAL_RANK = RANK mod local_size, LOCAL_WORLD_SIZE and
    GROUP_RANK: local_size ranks a "host", all of them by default) and wait
    for them. A rank that exits non-zero, or is still running after
    timeout_s, stops every rank and raises RuntimeError with its output.
    The ranks run from the repository's root. Returns each rank's output
    (stdout and stderr), in rank order."""
    local_size = local_size or n
    cwd = Path(__file__).resolve().parents[2]
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(n),
                LOCAL_WORLD_SIZE=str(local_size))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = []

    def output(r):
        logs[r].flush()
        logs[r].seek(0)
        return logs[r].read()

    try:
        for r in range(n):
            procs.append(subprocess.Popen([sys.executable] + [str(a) for a in args], cwd=cwd, stdout=logs[r],
                                          stderr=subprocess.STDOUT, text=True,
                                          env=dict(base, RANK=str(r), LOCAL_RANK=str(r % local_size),
                                                   GROUP_RANK=str(r // local_size))))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} of {n} exited with {codes[r]}:\n{output(r)[-6000:]}")
            if all(c == 0 for c in codes):
                return [output(r) for r in range(n)]
            if time.monotonic() > deadline:
                r = codes.index(None)
                raise RuntimeError(f"rank {r} of {n} still running after {timeout_s:.0f} s:\n{output(r)[-6000:]}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
