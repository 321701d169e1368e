"""The port's entry points on the CPU: ``python -m gkr_mimc_tpu_torch.bench``
in its single mode (one JSON line, the reference's metric name and
vs_baseline, printed only after verification; its proof the golden one
pinned from the JAX package), the checkpointed witness against the
resident one, ``python -m gkr_mimc_tpu_torch.bench_pipeline``'s record,
and both entry points' refusal to run without a card unless the CPU is
asked for. No JAX program runs here.

    python -m pytest tests/test_torch_bench.py -q -p no:cacheprovider
"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from gkr_mimc_tpu_torch import bench, bench_pipeline
from gkr_mimc_tpu_torch.fields import fr
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier
from torch_common import golden, strs

CPU = torch.device("cpu")
PIPELINE_KEYS = ["n_hashes", "constraints", "constraints_per_hash", "direct_constraints_91N", "wires",
                 "compile_s", "setup_s", "prove_s", "verify_s"]  # scripts/bench_pipeline.py's record
JAX_PIPELINE_BN0_CONSTRAINTS = 66_887  # the JAX package's GadgetCircuit over one hash (tests/test_torch_groth16.py)


def run_main(module, argv, env: dict):
    """module.main(argv) under ``env`` -> (stdout lines, the Runs its modes returned)."""
    runs = []
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in ("GKR_BENCH_SHARDED", "GKR_BENCH_GROUP", "GKR_BENCH_TOTAL_LOG2", "GKR_BENCH_CKPT",
                  "GKR_BENCH_DEVICE", "GKR_BENCH_VERIFY"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        single = bench.single
        mp.setattr(bench, "single", lambda *a, **kw: runs.append(single(*a, **kw)) or runs[-1])
        with redirect_stdout(out):
            assert module.main(argv) == 0
    return out.getvalue().splitlines(), runs


@pytest.fixture(scope="module")
def single_bn2():
    return run_main(bench, ["--device", "cpu"], {"GKR_BENCH_BN": "2"})


def test_single_mode_prints_one_line(single_bn2):
    lines, [run] = single_bn2
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "mimc_hashes_proven_per_sec_bn2" and rec["unit"] == "hashes/s"
    hps = 4 / (run.times["witness_s"] + run.times["prove_s"])
    assert rec["value"] == round(hps, 1)
    assert rec["vs_baseline"] == round(hps / bench.EPYC_BASELINE_HASHES_PER_SEC, 3)
    assert bench.EPYC_BASELINE_HASHES_PER_SEC == 300_000.0
    assert run.verified == 2 and "warmup_s" in run.times


def test_single_mode_proof_is_golden(single_bn2):
    """bn = 2, block = state = the stream at 0: the proof vector and the
    outputs pinned from the JAX package."""
    _, [run] = single_bn2
    want = golden()["gkr_mimc"]
    assert want["bn"] == 2
    assert strs(fr.to_ints(run.witness[93])) == want["outputs"]
    assert strs(proof_to_vec(run.circuit, run.proof)) == want["proof_vec"]


def test_checkpointed_witness_gives_the_resident_proof():
    runs = {ckpt: bench.single(3, CPU, ckpt, verify=ckpt, warmup=False) for ckpt in (False, True)}
    assert runs[True].verified == 2
    vecs = {ckpt: proof_to_vec(r.circuit, r.proof) for ckpt, r in runs.items()}
    assert vecs[True] == vecs[False]


def test_no_line_unless_the_proof_verifies(monkeypatch):
    def reject(*args, **kwargs):
        raise gkr_verifier.GKRError("rejected")

    monkeypatch.setattr(gkr_verifier, "verify", reject)
    out = io.StringIO()
    with pytest.raises(gkr_verifier.GKRError), redirect_stdout(out):
        run_main(bench, ["--device", "cpu"], {"GKR_BENCH_BN": "1"})
    assert out.getvalue() == ""


@pytest.mark.parametrize("module", [bench, bench_pipeline], ids=["bench", "bench_pipeline"])
def test_no_card_and_no_cpu_request_exits_nonzero(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GKR_BENCH_DEVICE", raising=False)
    with pytest.raises(SystemExit) as e:
        module.main(["0"] if module is bench_pipeline else [])
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_pipeline_record_at_one_hash(tmp_path, monkeypatch):
    """N = 1 asked for the CPU by GKR_BENCH_DEVICE, with no card: the
    record's keys are the reference's, its sizes the one-hash circuit's,
    and --out holds the same record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "pipeline.json"
    lines, _ = run_main(bench_pipeline, ["0", "--out", str(out)], {"GKR_BENCH_DEVICE": "cpu"})
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == PIPELINE_KEYS
    assert rec["n_hashes"] == 1 and rec["direct_constraints_91N"] == 91
    assert rec["constraints"] == JAX_PIPELINE_BN0_CONSTRAINTS == rec["constraints_per_hash"]
    assert rec["wires"] > rec["constraints"] and all(rec[k] > 0 for k in PIPELINE_KEYS[5:])
    assert json.loads(out.read_text()) == rec
