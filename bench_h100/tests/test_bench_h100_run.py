"""The run as a whole: its refusals, its imports, and `correct` under each planted fault."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_h100 import cell as C
from bench_h100.faults import CONTROL, FAULTS
from bench_h100.run import FORBIDDEN
from bench_h100.spec import ROOT

from .cpu import CPU, small_cell

SEED = 2**33 + 2024
ARGS = ["--workload", "mimc91-resident.single-2e22", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]


def _run(cwd, args=ARGS):
    return subprocess.run([sys.executable, "-m", "bench_h100.run", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600, check=False)


def test_exits_without_a_result_on_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this case is for a machine without one")
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_exits_without_a_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_run_loads_no_jax_and_no_host_runtime():
    code = ("import sys, time, torch\n"
            "from bench_h100 import cell as C\n"
            "from bench_h100.tests.cpu import CPU, small_cell\n"
            "out = C.run(small_cell('mimc91-ckpt.single-2e25', 3), CPU, 7, 0.01, False, time.perf_counter(), "
            "lambda m: None)\n"
            "assert out['correct'], out\n"
            "print(sorted(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    mods = eval(res.stdout.strip().splitlines()[-1])
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN
    assert "gkr_mimc_tpu_torch.models.checkpoint" in mods
    assert not [m for m in mods if m.startswith(("gkr_mimc_tpu_torch.gadget", "gkr_mimc_tpu_torch.native"))]


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_correct_comes_out_false_under_each_fault(fault):
    """A whole run but the look for a card, on the CPU at bn = 4, with the
    timed path broken underneath: `correct` is false under every fault (the
    control, ``skip_last_round``, among them) and true without one. A run
    on one card has no exchange between chips to leave out."""
    out = C.run(small_cell("mimc91-resident.single-2e22"), CPU, SEED, 0.01, False, time.perf_counter(),
                lambda m: None, fault=fault)
    assert out["correct"] is (fault is None)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["proofs_checked"] == 1
    if fault == CONTROL:
        assert checks["proof_failures"] >= 1 and checks["hash_mismatches"] >= 1


def test_grouped_lanes_fault_is_named_by_the_check():
    out = C.run(small_cell("mimc91-resident.grouped-4x2e20", 4, 2), CPU, SEED, 0.01, False, time.perf_counter(),
                lambda m: None, fault="half_batch")
    assert not out["correct"] and out["failed"] == 1


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs one cell of the benchmark on the card")
    res = _run(ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu" and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"hashes_per_s", "setup_s"}
