"""Smoke run of the PyTorch + CUDA port (gkr_mimc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--bn 22]

Builds the CUDA kernels from gkr_mimc_tpu_torch/csrc at first use, then:

1. toolchain and card: torch, CUDA, nvcc, the card's name and power limit,
   the build time and nvcc's register report;
2. every kernel against its plain torch twin on the card, bit for bit, at
   small shapes and at the main path's shapes (timed, kernel and plain);
3. golden transcripts: MimcHash([12]) and tests/golden/transcripts.json,
   with tail_bits 8 and 1;
4. a full GKR walk at bn = 14 through the kernels and again through the
   plain twins on the same CUDA tensors: identical proof vectors;
5. the main path at --bn (default 22, the north-star size): inputs
   generated on the card, witness, GKR proof, verification, a tamper probe,
   and the launch count of every kernel during that run.

Prints one JSON line of per-kernel results, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero on any
failure, including when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gkr_mimc_tpu_torch.fields import fr  # noqa: E402
from gkr_mimc_tpu_torch.fields.bn254 import L  # noqa: E402
from gkr_mimc_tpu_torch.gadget.serialize import proof_to_vec  # noqa: E402
from gkr_mimc_tpu_torch.gkr import prover as gkr_prover  # noqa: E402
from gkr_mimc_tpu_torch.gkr import verifier as gkr_verifier  # noqa: E402
from gkr_mimc_tpu_torch.hashes.ark import arks_mont  # noqa: E402
from gkr_mimc_tpu_torch.hashes.mimc import mimc_hash, mimc_hash_device, mimc_keyed_permutation  # noqa: E402
from gkr_mimc_tpu_torch.models.mimc import assign_fused, mimc_circuit  # noqa: E402
from gkr_mimc_tpu_torch.ops import build  # noqa: E402
from gkr_mimc_tpu_torch.ops import kernels as K  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import prover as sumcheck_prover  # noqa: E402
from gkr_mimc_tpu_torch.sumcheck import testing  # noqa: E402
from gkr_mimc_tpu_torch.utils.common import random_fr_array, random_fr_device  # noqa: E402
from gkr_mimc_tpu_torch.utils.convert import ints_to_rows, rows_to_ints  # noqa: E402

MIMC_KAT = 1808205620575546259657963589762746470347087906694759866517376279978241663265
TWO_P_TOP = 0x60C89CE5  # top limb of 2p: limbs below it give values < 2p


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sync() -> None:
    torch.cuda.synchronize()


def rand_lazy(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    """Field tables of lazy representatives (< 2p) from a numpy seed."""
    limbs = rng.integers(0, 1 << 32, size=(L,) + tuple(shape), dtype=np.uint64)
    limbs[L - 1] %= TWO_P_TOP
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(dev)


def max_abs_err(a, b) -> int:
    """Largest limb difference (unsigned 32-bit values) over all outputs."""
    outs_a = a if isinstance(a, list) else [a]
    outs_b = b if isinstance(b, list) else [b]
    err = 0
    for x, y in zip(outs_a, outs_b):
        if x.shape != y.shape:
            raise AssertionError(f"shapes {tuple(x.shape)} vs {tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        xf, yf = x.reshape(-1), y.reshape(-1)
        for i in range(0, xf.numel(), 1 << 24):  # int64 copies of a slice at a time
            d = (xf[i : i + (1 << 24)].to(torch.int64) & 0xFFFFFFFF) - (yf[i : i + (1 << 24)].to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max().item()))
    return err


def time_kernel(fn, args) -> float:
    """ms per call, CUDA events over repeated launches after a warm-up."""
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    sync()
    reps = max(1, min(20, int(200.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def time_once(fn, args):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    out = fn(*args)
    end.record()
    sync()
    return out, start.elapsed_time(end)


@contextmanager
def plain_twins():
    """Swap every kernel wrapper for its plain twin (callers resolve
    K.<name> at call time), so the same CUDA tensors take the plain path."""
    saved = {name: getattr(K, name) for name in K.KERNELS}
    for name in K.KERNELS:
        setattr(K, name, K.PLAIN[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def kernel_cases(bn: int, dev, rng):
    """(kernel name, small cases, main-path case); a case is an args tuple."""
    n = 1 << bn
    arks = arks_mont(K.MIMC_ROUNDS, dev)

    def r(*shape):
        return rand_lazy(rng, shape, dev)

    def fold_args(nt, g, n_):
        return ([r(g * n_) for _ in range(nt)], r(g))

    def acc_args(g, n_):
        return (r(g * n_ // 2), r(g * n_), r(g * n_), r(g))

    def eq_args(c, j, b):  # mh (C, 8, J), lo (8, J, B)
        return (r(c, j).permute(1, 0, 2).contiguous(), r(j, b))

    return [
        ("mimc_witness", [(r(2), r(2), arks), (r(1 << 16), r(1 << 16), arks)],
         lambda: (r(n), r(n), arks)),
        ("mimc_hash", [(r(1),), (r(3),), (r(9),)], lambda: (r(9),)),
        ("mimc_hash_g", [(r(9, 1),), (r(9, 2048),)], lambda: (r(9, 91 * bn),)),
        ("fold", [fold_args(1, 1, 2), fold_args(2, 4, 2), fold_args(4, 1, 8),
                  fold_args(2, 1, 1 << 16), fold_args(1, 4, 1 << 14)],
         lambda: fold_args(2, 1, n)),
        ("suffix_step", [(r(1), r(1)), (r(4 * 2), r(4)), (r(1 << 15), r(1)), (r(4 << 13), r(4))],
         lambda: (r(n // 4), r(1))),
        ("multi_eq", [eq_args(1, 10, 8), eq_args(3, 5, 2), eq_args(64, 91, 1 << 10)],
         lambda: eq_args(max(1, n >> 10), 91, min(n, 1 << 10))),
        ("gruen_acc", [acc_args(1, 2), acc_args(4, 2), acc_args(1, 1 << 16), acc_args(4, 1 << 12)],
         lambda: acc_args(1, n)),
        ("identity_acc", [(r(2), r(2), 1), (r(8), r(8), 4), (r(1 << 16), r(1 << 16), 1),
                          (r(4 << 12), r(4 << 12), 4)],
         lambda: (r(n), r(n), 1)),
    ]


def phase_kernels(bn: int, dev) -> dict:
    rng = np.random.default_rng(2024)
    results = {}
    for name, small, main in kernel_cases(bn, dev, rng):
        kern, plain = getattr(K, name), K.PLAIN[name]
        err = 0
        for args in small:
            got, want = kern(*args), plain(*args)
            sync()
            e = max_abs_err(got, want)
            if e:
                raise AssertionError(f"{name}: kernel != plain (max limb diff {e})")
            err = max(err, e)
        args = main()
        ms = time_kernel(kern, args)
        got = kern(*args)
        want, plain_ms = time_once(plain, args)
        err = max(err, max_abs_err(got, want))
        if err:
            raise AssertionError(f"{name}: kernel != plain at the main shapes (max limb diff {err})")
        del got, want, args
        torch.cuda.empty_cache()
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"# kernel {name}: bit-equal to plain; {ms:.4f} ms kernel vs {plain_ms:.2f} ms plain "
            f"at the bn={bn} main-path shapes")
    return results


# ---------------------------------------------------------------------------
# Phase 3: golden transcripts
# ---------------------------------------------------------------------------


def phase_golden(dev) -> None:
    if mimc_hash([12]) != MIMC_KAT:
        raise AssertionError("host MimcHash([12]) known answer")
    if fr.to_int(mimc_hash_device(fr.encode_mont_ints([12], dev))) != MIMC_KAT:
        raise AssertionError("device MimcHash([12]) known answer")
    golden = json.loads((ROOT / "tests" / "golden" / "transcripts.json").read_text())

    def strs(x):
        return [strs(v) for v in x] if isinstance(x, list) else str(x)

    for tail_bits in (8, 1):
        for bn in (1, 2, 3):
            xs, claims, qps, gate = testing.initialize_cipher_gate_instance(bn, dev)
            scp = sumcheck_prover.prove(xs, testing.to_device_qprimes(qps, dev),
                                        testing.to_device_claims(claims, dev), gate, tail_bits)
            want = golden["sumcheck"][f"cipher_bn{bn}"]
            if (strs(rows_to_ints(scp.coeffs)) != want["coeffs"]
                    or strs(rows_to_ints(scp.challenges)) != want["challenges"]
                    or strs(rows_to_ints(scp.final_claims)) != want["final_claims"]):
                raise AssertionError(f"golden cipher_bn{bn} (tail_bits={tail_bits})")
        xs, claims, qps, gate = testing.initialize_multi_instance(3, 10, dev)
        scp = sumcheck_prover.prove(xs, testing.to_device_qprimes(qps, dev),
                                    testing.to_device_claims(claims, dev), gate, tail_bits)
        want = golden["sumcheck"]["multi_bn3_j10"]
        if (strs(rows_to_ints(scp.coeffs)) != want["coeffs"]
                or strs(rows_to_ints(scp.final_claims)) != want["final_claims"]):
            raise AssertionError(f"golden multi_bn3_j10 (tail_bits={tail_bits})")
        want = golden["gkr_mimc"]
        bn = want["bn"]
        block = fr.encode_mont_ints(random_fr_array(1 << bn), dev)
        c = mimc_circuit()
        a = assign_fused(block, block.clone())
        qprime = ints_to_rows(random_fr_array(bn), dev)
        proof = gkr_prover.prove(c, a, qprime, tail_bits)
        if strs(fr.to_ints(a[93])) != want["outputs"] or strs(proof_to_vec(c, proof)) != want["proof_vec"]:
            raise AssertionError(f"golden gkr_mimc bn={bn} (tail_bits={tail_bits})")
        gkr_verifier.verify(c, proof, [block, block], a[93], qprime)
        log(f"# golden: cipher_bn1..3, multi_bn3_j10, gkr_mimc bn={bn} reproduced (tail_bits={tail_bits})")


# ---------------------------------------------------------------------------
# Phases 4 and 5: GKR walks
# ---------------------------------------------------------------------------


def walk(bn: int, dev):
    """Inputs on the card -> witness -> proof; returns timings and artifacts."""
    n = 1 << bn
    c = mimc_circuit()
    sync()
    t0 = time.perf_counter()
    block = fr.to_mont(random_fr_device(n, 0, dev))
    state = block.clone()
    qprime = ints_to_rows(random_fr_array(bn), dev)
    sync()
    t1 = time.perf_counter()
    a = assign_fused(block, state)
    sync()
    t2 = time.perf_counter()
    proof = gkr_prover.prove(c, a, qprime)
    sync()
    t3 = time.perf_counter()
    times = {"inputs_s": t1 - t0, "witness_s": t2 - t1, "prove_s": t3 - t2}
    return c, block, state, qprime, a, proof, times


def phase_cross_check(bn: int, dev) -> None:
    c, *_, proof, t_k = walk(bn, dev)
    vec_kernel = proof_to_vec(c, proof)
    del proof
    with plain_twins():
        c, *_, proof, t_p = walk(bn, dev)
    vec_plain = proof_to_vec(c, proof)
    if vec_kernel != vec_plain:
        raise AssertionError(f"bn={bn}: kernel and plain walks differ")
    log(f"# cross-check bn={bn}: kernel and plain walks give identical proof vectors "
        f"({len(vec_kernel)} elements); prove {t_k['prove_s']:.2f} s kernels vs "
        f"{t_p['prove_s']:.2f} s plain")


def phase_main(bn: int, dev, card: str) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    c, block, state, qprime, a, proof, times = walk(bn, dev)
    t0 = time.perf_counter()
    gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    sync()
    times["verify_s"] = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # outputs against the host oracle on a few instances
    vals = random_fr_array(1 << bn)
    idx = [0, 1, (1 << bn) // 3, (1 << bn) - 1]
    out = fr.to_ints(a[93][:, idx].contiguous())
    if out != [mimc_keyed_permutation(vals[i], vals[i]) for i in idx]:
        raise AssertionError("output table disagrees with the host MiMC permutation")
    # tamper probe: one flipped coefficient bit must be rejected
    bad = proof.sumcheck_proofs[50].coeffs.clone()
    bad[0, 0, 0] ^= 1
    good = proof.sumcheck_proofs[50].coeffs
    proof.sumcheck_proofs[50].coeffs = bad
    try:
        gkr_verifier.verify(c, proof, [block, state], a[93], qprime)
    except gkr_verifier.GKRError as e:
        log(f"# tamper probe rejected: {e}")
    else:
        raise AssertionError("a tampered proof was accepted")
    proof.sumcheck_proofs[50].coeffs = good

    n = 1 << bn
    hps = n / (times["witness_s"] + times["prove_s"])
    log(f"# main path bn={bn} on {card}: inputs {times['inputs_s']:.3f} s, witness "
        f"{times['witness_s']:.3f} s, prove {times['prove_s']:.3f} s, verify {times['verify_s']:.3f} s, "
        f"{hps:,.0f} hashes proven/s (witness + prove), peak memory {peak_gb:.2f} GB")
    log(f"# launches on the main path: {json.dumps(launches)}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bn", type=int, default=22, help="log2 of the hashes proven on the main path")
    bn = ap.parse_args().bn
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # 1. toolchain and card
    card = card_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"# nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"# card: {card}")
    t0 = time.perf_counter()
    build.library()
    log(f"# kernels built in {time.perf_counter() - t0:.1f} s -> {build.library_path().name}")
    report = Path(f"{build.library_path()}.log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"#   ptxas {line.split('ptxas info    :')[-1].strip()}")

    kernel_results = phase_kernels(bn, dev)  # 2.
    phase_golden(dev)  # 3.
    phase_cross_check(min(14, bn), dev)  # 4.
    launches = phase_main(bn, dev, card)  # 5.

    kernels = []
    for name, (source, replaces) in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **kernel_results[name]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
