"""The port's process-group bring-up and global slabs
(gkr_mimc_tpu_torch/parallel/multihost.py) on the CPU: the reference's
failure policy (an explicit or WORLD_SIZE > 1 request that cannot come up
raises; only the zero-config single process goes on without a group),
``process_local_report``, the local launcher's handling of a failed or
hung rank, and each rank's slab of the inputs equal to the
generator at that rank's indices, built without the whole table.

    python -m pytest tests/test_torch_multihost.py -q -p no:cacheprovider
"""

import time

import pytest
import torch
import torch.distributed as dist

from gkr_mimc_tpu.utils import common as jcommon
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.parallel import multihost
from gkr_mimc_tpu_torch.parallel.mesh import Mesh
from gkr_mimc_tpu_torch.utils.common import random_fr_at, random_fr_device

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_torchrun(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("how", ["explicit", "env"])
def test_unreachable_cluster_raises(no_torchrun, monkeypatch, how):
    """Rank 1 of 2 at a local port where no coordinator listens: the
    bring-up times out after 5 s and raises RuntimeError, leaving no group."""
    port = multihost.free_port()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="bring-up failed for rank 1 of 2"):
        if how == "explicit":
            multihost.initialize(f"127.0.0.1:{port}", 2, 1, backend="gloo", timeout_s=5)
        else:
            for var, value in zip(TORCHRUN_VARS, ("127.0.0.1", str(port), "2", "1", "1")):
                monkeypatch.setenv(var, value)
            multihost.initialize(backend="gloo", timeout_s=5)
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


def test_zero_config_is_one_process_and_a_second_call_is_a_no_op(no_torchrun):
    multihost.initialize()
    assert not dist.is_initialized()
    m = multihost.make_global_mesh(device="cpu")
    assert (m.group, m.rank, m.size, m.device) == (None, 0, 1, torch.device("cpu"))
    rep = multihost.process_local_report()
    assert rep["process_index"] == 0 and rep["process_count"] == 1 and rep["global_devices"] == 1
    assert rep["backend"] is None and rep["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    from gkr_mimc_tpu.parallel import multihost as jmultihost

    assert set(jmultihost.process_local_report()) <= set(rep)  # the reference's keys
    try:  # a one-rank gloo group, then initialize again: nothing changes
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="gloo", timeout_s=30)
        group = dist.group.WORLD
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 4, 3, backend="gloo", timeout_s=30)
        assert dist.group.WORLD is group and dist.get_world_size() == 1
        m = multihost.make_global_mesh(device="cpu", backend="gloo")
        assert (m.size, m.backend) == (1, "gloo") and m.group is not None
        assert multihost.process_local_report()["backend"] == "gloo"
        with pytest.raises(RuntimeError, match="runs gloo, nccl was asked for"):
            multihost.make_global_mesh(device="cpu", backend="nccl")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_launch_local_fails_with_the_ranks_output():
    """A rank that exits non-zero, or outlives the time limit, stops every
    rank and raises with its output."""
    prog = ("import os, sys, time\n"
            "r = int(os.environ['RANK'])\n"
            "print('rank', r, 'of', os.environ['WORLD_SIZE'], 'host', os.environ['GROUP_RANK'], flush=True)\n"
            "if r == 1 and sys.argv[1] == 'fail': sys.exit(3)\n"
            "if r == 1 and sys.argv[1] == 'hang': time.sleep(60)\n")
    outs = multihost.launch_local(4, ["-c", prog, "ok"], 60, local_size=2)
    assert [o.strip() for o in outs] == [f"rank {r} of 4 host {r // 2}" for r in range(4)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 exited with 3:\nrank 1 of 2 host 0"):
        multihost.launch_local(2, ["-c", prog, "fail"], 60)
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 still running after 2 s:\nrank 1 of 2 host 0"):
        multihost.launch_local(2, ["-c", prog, "hang"], 2)
    assert time.monotonic() - t0 < 30


def test_random_fr_at_matches_the_generator():
    """At any indices: the reference's numpy generator and the port's
    stream (random_fr_device) at the same places."""
    idx = torch.tensor([0, 1, 5, 70000, (1 << 32) - 1, 12345678], dtype=torch.int64)
    got = fr.limb_values(random_fr_at(idx))
    want = [int(jcommon.random_fr_array_np(1, int(i))[0]) for i in idx]
    assert got == want
    assert torch.equal(random_fr_at(torch.arange(40, 104)), random_fr_device(64, 40, "cpu"))


@pytest.mark.parametrize("d", [2, 4])
def test_global_slabs_are_the_generator_at_the_ranks_indices(d):
    """Each rank's slab holds indices rank + D * k, built by that rank
    alone: ``shard_table_global`` from a fill and
    ``shard_mimc_inputs_global`` (the main path's inputs in Montgomery
    form); the D slabs interleave back to the whole table."""
    n = 64
    whole = fr.to_mont(random_fr_device(n, 0, "cpu"))
    slabs = []
    for rank in range(d):
        m = Mesh(None, rank, d, torch.device("cpu"))
        calls = []

        def fill(r, size):
            calls.append((r, size))
            return random_fr_at(r + d * torch.arange(size))

        slab = multihost.shard_table_global(m, n, fill)
        assert calls == [(rank, n // d)]
        want = [int(jcommon.random_fr_array_np(1, rank + d * k)[0]) for k in range(n // d)]
        assert fr.limb_values(slab) == want
        slabs.append(multihost.shard_mimc_inputs_global(m, n))
        assert torch.equal(slabs[-1], whole[:, rank::d])
    assert torch.equal(torch.stack(slabs, dim=-1).reshape(8, n), whole)
    with pytest.raises(ValueError):
        multihost.shard_table_global(Mesh(None, 0, d, torch.device("cpu")), n + 1, fill)
